"""The generated PBD kernel run on the CPU, for its lane logic.

`brax_torch/csrc/pbd_step.cu`, with a System's scene header in front
(`brax_torch.sim.kernels.scene_header`), is compiled by the host C++
compiler against a few lines that stand in for CUDA: a warp is 32 OS
threads, `__shfl_sync` a store, a barrier, a load and a barrier, and a block
is one warp.  With PBD_IEEE_DIV_SQRT defined the kernel divides and takes
square roots with the host's IEEE `/` and sqrtf, so what this checks is the
lane design (the plan, the header's lists, the shuffles, the roles of the
lanes), not the card's arithmetic; tests/test_torch_cuda.py and
chip_smoke.py hold the card's build to the twin.

    python -m tests.pbd_emulation

prints the largest difference from `pbd_step_plain` per output for ant (37
envs), ant with two legs removed (41 envs), humanoid (37 envs) and
humanoidstandup (19 envs), in contact.
"""

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


def emulate(sys, qp, act):
    """The kernel's outputs (pos, rot, vel, ang, contact vel, contact ang),
    each (N, nb, C), for CPU inputs qp and act."""
    text = kernels.scene_header(sys) + kernels.SOURCE.read_text()
    text = text.replace("#include <cuda_runtime.h>\n", "")
    text = SHIM + text[:text.index('extern "C" {')] + MAIN
    n, n_act, nb = qp.pos.shape[0], act.shape[1], sys.num_bodies
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        work = Path(tmp)
        src, exe = work / "pbd_step_emulated.cpp", work / "pbd_step_emulated"
        src.write_text(text)
        subprocess.run([compiler(), "-O1", "-std=c++20", "-pthread", "-o", str(exe), str(src)],
                       check=True, capture_output=True)
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
    from tests.test_torch_pbd_launch import Scene, _config, scene_state

    for name, n in (("ant", 37), ("two_legged_ant", 41), ("humanoid", 37),
                    ("humanoidstandup", 19)):
        env = Scene(_config(name), batch_size=n, device="cpu")
        qp, act = scene_state(env, n, steps=10, seed=0, device="cpu")
        print(name, n, "envs:", max_errors(env.sys, qp, act))


if __name__ == "__main__":
    main()
