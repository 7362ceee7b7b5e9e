"""The generated PBD kernel run on the CPU, for its lane logic.

`brax_torch/csrc/pbd_step.cu`, with a System's scene header in front
(`brax_torch.sim.kernels.scene_header`), is compiled by the host C++
compiler against a few lines that stand in for CUDA: a block is
PBD_THREADS lanes (one warp, or an env of 64-256 lanes on the wide route),
each a fiber with a stack of its own on one OS thread, `__syncthreads` a
barrier (the lane hands control back to a scheduler that runs the others up
to it; a barrier that some lane never reaches aborts the program, where a
block on the card would hang), `__shfl_sync` a store, a barrier, a load and
a barrier, and a `__shared__` array a global one (the blocks run one after
another).  Fibers switch in a few instructions, where OS threads at a
barrier wait on the kernel's scheduler.  With PBD_IEEE_DIV_SQRT defined the kernel divides and takes
square roots with the host's IEEE `/` and sqrtf, so what this checks is the
lane design (the plan, the header's lists, the shuffles, the roles of the
lanes), not the card's arithmetic; tests/test_torch_cuda.py and
chip_smoke.py hold the card's build to the twin; tests/pbd_faults.py plants
faults in copies of the source.

    python -m tests.pbd_emulation

prints the largest difference from `pbd_step_plain` per output for ant (37
envs), ant with two legs removed (41 envs), humanoid (37 envs),
humanoidstandup (19 envs), halfcheetah (17 envs) and pusher (9 envs), in
contact, and for the last two also with their capsule-capsule pairs
overlapping; then for the scenes without contacts, inverted_pendulum (37
envs, its 1-wide action), inverted_double_pendulum (19), swimmer (19, 11
action columns), reacherangle (21, targets past the joint limits) and
reacher (17), after 10 twin steps; and grasp (17 envs) from a reset and
with its claw closed on the ball (`pbd_parity.grasp_states`).
"""

import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from brax_torch.sim import kernels

SHIM = r"""
#include <math.h>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <vector>
using std::size_t;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define PBD_IEEE_DIV_SQRT
struct Dim { unsigned x; };
// the running lane's indices: the scheduler sets them as it enters a lane
Dim threadIdx, blockIdx;
typedef void* cudaStream_t;
template <class T> inline T __ldg(const T* p) { return *p; }

// Each lane of a block is a fiber on this one OS thread, with a stack of
// its own; a barrier hands control back to the scheduler, which runs the
// next lane.  fiber_switch saves the callee-saved registers and the stack
// pointer of the running side and restores the other's (x86-64 System V).
extern "C" void fiber_switch(void** save_sp, void* load_sp);
asm(R"(
.text
.globl fiber_switch
.type fiber_switch,@function
fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
)");

enum LaneState { RUNNING, AT_BARRIER, DONE };
struct Lane { void* sp; LaneState state; };
struct Block {
  std::vector<Lane> lanes;
  void* sched_sp;
  int current;
  float slots[256];
};
Block* g_block;

inline void __syncthreads() {
  Lane& me = g_block->lanes[g_block->current];
  me.state = AT_BARRIER;
  fiber_switch(&me.sp, g_block->sched_sp);
}
inline float __shfl_sync(unsigned, float v, int src, int width) {
  g_block->slots[threadIdx.x] = v;
  __syncthreads();
  float r = g_block->slots[(threadIdx.x & ~(width - 1)) + src];
  __syncthreads();
  return r;
}
// one block runs at a time: a __shared__ array is a global one
#define __shared__
"""

MAIN = r"""
static void (*g_body)();
static void lane_entry() {
  g_body();
  Lane& me = g_block->lanes[g_block->current];
  me.state = DONE;
  fiber_switch(&me.sp, g_block->sched_sp);
  abort();  // a finished lane is never entered again
}

// Runs body() on `count` lanes as one block: round after round, each lane
// runs until it reaches a barrier or ends.  A round in which some lanes
// reached a barrier and others ended is a barrier that not every thread
// reaches, which hangs a block on the card: it aborts here.
static void run_block(Block& w, int count, std::vector<std::vector<char>>& stacks) {
  w.lanes.assign(count, Lane{nullptr, RUNNING});
  for (int l = 0; l < count; ++l) {
    char* top = stacks[l].data() + stacks[l].size();
    void** sp = (void**)((size_t)top & ~(size_t)15);
    *--sp = nullptr;              // lane_entry's return address slot (alignment)
    *--sp = (void*)&lane_entry;   // fiber_switch's ret
    for (int r = 0; r < 6; ++r) *--sp = nullptr;  // rbp rbx r12-r15
    w.lanes[l].sp = sp;
  }
  g_block = &w;
  for (;;) {
    int at_barrier = 0, done = 0;
    for (int l = 0; l < count; ++l) {
      w.current = l;
      threadIdx.x = l;
      fiber_switch(&w.sched_sp, w.lanes[l].sp);
      if (w.lanes[l].state == AT_BARRIER) ++at_barrier;
      else ++done;
    }
    if (done == count) return;
    if (at_barrier != count) {
      fprintf(stderr, "a barrier that %d of %d lanes never reach\n", done, count);
      abort();
    }
    for (auto& lane : w.lanes) lane.state = RUNNING;
  }
}

int main(int argc, char** argv) {
  const int n = atoi(argv[1]), n_act = atoi(argv[2]), nb = PBD_NB;
  const int widths[11] = {3, 4, 3, 3, -1, 3, 4, 3, 3, 3, 3};
  std::vector<std::vector<float>> t(11);
  for (int q = 0; q < 11; ++q)
    t[q].resize(widths[q] < 0 ? (size_t)n * n_act : (size_t)n * nb * widths[q]);
  FILE* f = fopen(argv[3], "rb");
  for (int q = 0; q < 5; ++q) fread(t[q].data(), 4, t[q].size(), f);
  fclose(f);
  // 16 NaNs past each input: a planted fault that reads past the action
  // (reference_clip) reads them, as a kernel on the card reads what lies there
  for (int q = 0; q < 5; ++q) t[q].resize(t[q].size() + 16, NAN);
  std::vector<std::vector<char>> stacks(PBD_THREADS, std::vector<char>(1 << 20));
  static std::vector<std::vector<float>>* g_t = &t;
  static int g_n, g_n_act;
  g_n = n;
  g_n_act = n_act;
  g_body = [] {
    auto& t = *g_t;
    pbd_step_kernel(t[0].data(), t[1].data(), t[2].data(), t[3].data(), t[4].data(),
                    t[5].data(), t[6].data(), t[7].data(), t[8].data(), t[9].data(),
                    t[10].data(), g_n, g_n_act);
  };
  Block w;
  for (int b = 0; b < (n + PBD_ENVS_PER_BLOCK - 1) / PBD_ENVS_PER_BLOCK; ++b) {
    blockIdx.x = b;
    run_block(w, PBD_THREADS, stacks);
  }
  f = fopen(argv[4], "wb");
  for (int q = 5; q < 11; ++q) fwrite(t[q].data(), 4, t[q].size(), f);
  fclose(f);
}
"""


def compiler():
    """The host C++ compiler, or None."""
    return shutil.which("g++") or shutil.which("clang++")


def executable(text: str) -> Path:
    """The emulation program of `text` (a scene header and pbd_step.cu),
    compiled once: kept under the build directory, named by the hash of
    what it compiles."""
    text = text.replace("#include <cuda_runtime.h>\n", "")
    text = SHIM + text[:text.index('extern "C" {')] + MAIN
    exe = kernels.BUILD_DIR / "emulated" / (
        "pbd_step_" + hashlib.sha256(text.encode()).hexdigest()[:16])
    if not exe.exists():
        exe.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=exe.parent) as tmp:
            src, out = Path(tmp) / "pbd_step_emulated.cpp", Path(tmp) / exe.name
            src.write_text(text)
            subprocess.run([compiler(), "-O1", "-std=c++20", "-o", str(out),
                            str(src)], check=True, capture_output=True)
            out.replace(exe)
    return exe


def emulate(sys, qp, act, source=None):
    """The kernel's outputs (pos, rot, vel, ang, contact vel, contact ang),
    each (N, nb, C), for CPU inputs qp and act; `source` is the text of
    pbd_step.cu to compile (default: the package's)."""
    exe = executable(kernels.scene_header(sys) + (source or kernels.SOURCE.read_text()))
    n, n_act, nb = qp.pos.shape[0], act.shape[1], sys.num_bodies
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        work = Path(tmp)
        with open(work / "in.bin", "wb") as f:
            for t in (qp.pos, qp.rot, qp.vel, qp.ang, act):
                f.write(t.contiguous().numpy().astype(np.float32).tobytes())
        subprocess.run([str(exe), str(n), str(n_act), str(work / "in.bin"),
                        str(work / "out.bin")], check=True)
        raw = np.fromfile(work / "out.bin", dtype=np.float32)
    outs, at = [], 0
    for c in (3, 4, 3, 3, 3, 3):
        outs.append(torch.from_numpy(raw[at:at + n * nb * c].reshape(n, nb, c).copy()))
        at += n * nb * c
    return outs


def max_errors(sys, qp, act):
    """{output: max |emulated kernel - twin|} over the batch."""
    ref, info = kernels.pbd_step_plain(sys, qp, act)
    want = (ref.pos, ref.rot, ref.vel, ref.ang, info.contact.vel, info.contact.ang)
    names = ("pos", "rot", "vel", "ang", "contact_vel", "contact_ang")
    return {k: float((o - w).abs().max()) for k, o, w in zip(names, emulate(sys, qp, act), want)}


def main():
    from brax_torch.tools.pbd_parity import capcap_state, physics_actions
    from tests.test_torch_pbd_launch import Scene, _config, scene_state

    for name, n in (("ant", 37), ("two_legged_ant", 41), ("humanoid", 37),
                    ("humanoidstandup", 19), ("halfcheetah", 17), ("pusher", 9)):
        env = Scene(_config(name), batch_size=n, device="cpu")
        qp, act = scene_state(env, n, steps=10, seed=0, device="cpu")
        print(name, n, "envs:", max_errors(env.sys, qp, act))
        if name in ("halfcheetah", "pusher"):
            qp, act = capcap_state(name, env, n, seed=0, device="cpu")
            print(name, n, "envs, capsule-capsule pairs overlapping:",
                  max_errors(env.sys, qp, act))
    for name, n in FORCE_SCENES.items():
        env = Scene(_config(name), batch_size=n, device="cpu")
        qp, act = scene_state(env, n, steps=10, seed=0, device="cpu",
                              draw=lambda g, name=name, n=n: physics_actions(name, n, g, "cpu"))
        print(name, n, "envs:", max_errors(env.sys, qp, act))
    from brax_torch.envs.grasp import Grasp
    from brax_torch.tools.pbd_parity import grasp_states

    env = Grasp(batch_size=17, device="cpu")
    for state, (qp, act) in grasp_states(env, 17, 0, "cpu").items():
        print(f"grasp 17 envs, {state}:", max_errors(env.sys, qp, act))


# the scenes without contacts (thrusters, angle actuators; reacher), and the
# envs of each emulated
FORCE_SCENES = {"inverted_pendulum": 37, "inverted_double_pendulum": 19, "swimmer": 19,
                "reacherangle": 21, "reacher": 17}


if __name__ == "__main__":
    main()
