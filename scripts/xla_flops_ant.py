"""Algorithmic FLOPs of one ant env step, from XLA's cost analysis.

    JAX_PLATFORMS=cpu python scripts/xla_flops_ant.py

Runs `bench.py::_algorithmic_flops_per_env_step` (the cost analysis of the
unfused JAX jnp `env.step`) at a small batch on the CPU: the count per
env-step does not depend on the batch.  Prints the count, and the time that
ant@4096 would need for it at the H100's data-sheet fp32 rate outside the
tensor cores (67 TFLOP/s): the operations side of the port kernel's bound.
"""

import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from brax_tpu.envs import create  # noqa: E402

N = 16
env = create("ant", episode_length=1000, auto_reset=True, batch_size=N)
state = jax.jit(env.reset)(jax.random.split(jax.random.PRNGKey(0), N))
flops = bench._algorithmic_flops_per_env_step(env, state, N)
print(f"flops per env-step (XLA cost analysis, jnp env.step, CPU): {flops:.0f}")
print(f"ant@4096: {flops * 4096:.0f} flops -> {flops * 4096 / 67e12 * 1e3:.5f} ms at 67 TFLOP/s")
