"""Ahead-of-time builds: every CUDA library a training run launches, built
and loaded before its first training step.

The port's counterpart of `brax_tpu/aot.py`'s role (the learner's
`--aot_cache`).  The JAX package serializes traced programs so that a warm
process skips minutes of tracing; the port has no tracing, and
`cuda_build` already caches every build on disk by a hash of its source
and flags.  What is left to move out of the first training step is the
build itself (nvcc, seconds per source) and the load: `prebuild` writes the
env's specialised sources, runs one nvcc for each that has no build yet,
all at once, and loads every library.  Without it each library is built at
first use, inside the first step that launches it.

    prebuild("ant")                  # v1: the PBD step for ant's System
    prebuild("ant", engine="v2")     # v2: the generalized step for its scene
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from brax_torch import cuda_build, envs
from brax_torch.sim import kernels
from brax_torch.training import fused_mlp
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels as gen_kernels


def libraries(env_name: str, engine: str = "v1", backend: str = "generalized",
              device="cuda") -> Dict[str, cuda_build.Library]:
    """{label: library} of a run on `env_name`: its physics kernel (the PBD
    step for a v1 env's System, the generalized step for a v2 scene) and the
    fused MLP kernels."""
    if engine == "v2":
        env = v2_envs.get_environment(env_name, backend=backend, device=device)
        libs = {"gen_step": gen_kernels.library(env.sys)}
    else:
        env = envs.factory(env_name)(1, torch.device(device))
        libs = {"pbd_step": kernels.library(env.sys)}
    libs["fused_mlp"] = fused_mlp.library()
    return libs


def prebuild(env_name: str, engine: str = "v1", backend: str = "generalized",
             device="cuda") -> Dict[str, object]:
    """Builds (in parallel) and loads every library of a run on `env_name`
    (`libraries`).  Returns {"seconds": wall-clock of builds and loads,
    "built": the sources compiled now, "libraries": every library's
    source}.  On the CPU nothing is built: the wrappers run their plain
    versions there."""
    t0 = time.perf_counter()
    if torch.device(device).type != "cuda":
        return {"seconds": 0.0, "built": [], "libraries": []}
    libs = libraries(env_name, engine, backend, device)
    missing = [lib.source.name for lib in libs.values()
               if not cuda_build.library_path(lib.source).exists()]
    cuda_build.build(*(lib.source for lib in libs.values()))
    for lib in libs.values():
        lib.get()
    return {"seconds": time.perf_counter() - t0, "built": missing,
            "libraries": [lib.source.name for lib in libs.values()]}
