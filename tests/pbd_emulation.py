"""The generated PBD kernel run on the CPU, for its lane logic.

`brax_torch/csrc/pbd_step.cu`, with a System's scene header in front
(`brax_torch.sim.kernels.scene_header`), is compiled by the host C++
compiler against a few lines that stand in for CUDA: a warp is 32 OS
threads, `__shfl_sync` a store, a barrier, a load and a barrier, and a block
is one warp.  With PBD_IEEE_DIV_SQRT defined the kernel divides and takes
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
#include <barrier>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
using std::size_t;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define PBD_IEEE_DIV_SQRT
struct Dim { unsigned x; };
thread_local Dim threadIdx, blockIdx;
typedef void* cudaStream_t;
template <class T> inline T __ldg(const T* p) { return *p; }
struct Warp { std::barrier<> bar{32}; float slots[32]; };
thread_local Warp* g_warp;
inline float __shfl_sync(unsigned, float v, int src, int width) {
  g_warp->slots[threadIdx.x] = v;
  g_warp->bar.arrive_and_wait();
  float r = g_warp->slots[(threadIdx.x & ~(width - 1)) + src];
  g_warp->bar.arrive_and_wait();
  return r;
}
"""

MAIN = r"""
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
  for (int b = 0; b < (n + PBD_ENVS_PER_BLOCK - 1) / PBD_ENVS_PER_BLOCK; ++b) {
    Warp w;
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l)
      lanes.emplace_back([&, l] {
        blockIdx.x = b;
        threadIdx.x = l;
        g_warp = &w;
        pbd_step_kernel(t[0].data(), t[1].data(), t[2].data(), t[3].data(), t[4].data(),
                        t[5].data(), t[6].data(), t[7].data(), t[8].data(), t[9].data(),
                        t[10].data(), n, n_act);
      });
    for (auto& l : lanes) l.join();
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
            subprocess.run([compiler(), "-O1", "-std=c++20", "-pthread", "-o", str(out),
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
