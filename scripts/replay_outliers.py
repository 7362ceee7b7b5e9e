"""Replays chip_smoke.py's parity outliers through both JAX paths on CPU.

    JAX_PLATFORMS=cpu python scripts/replay_outliers.py build/brax_torch/parity_outliers.npz

chip_smoke.py saves the inputs of the envs where the CUDA kernel and its
plain-torch twin disagree beyond tolerance, with both outputs.  This script
steps the same inputs through the twin on CPU, the JAX jnp step
(`brax_tpu.sim.system._raw_step`) and the JAX Pallas kernel's math
(`brax_tpu.sim.kernels._build_tile_step`, eager), and prints, per env, the
largest velocity difference of each to the kernel's and to the twin's output.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from brax_tpu.sim import kernels as jax_kernels  # noqa: E402
from brax_torch.envs.ant import Ant  # noqa: E402
from brax_torch.sim import kernels  # noqa: E402
from brax_torch.sim.types import QP  # noqa: E402
from tests import torch_parity as tp  # noqa: E402

d = np.load(sys.argv[1])
n = d["pos"].shape[0]
env = Ant(use_contact_forces=True, batch_size=n, device="cpu")
qp = QP.from_numpy(d["pos"], d["rot"], d["vel"], d["ang"], device="cpu")
twin_cpu, _ = kernels.pbd_step_plain(env.sys, qp, torch.from_numpy(d["act"]))
jnp_qp, _ = tp.jax_raw_step()(tp.to_jax_qp(qp), d["act"])
soa = lambda x: jnp.asarray(np.transpose(x, (1, 2, 0)))
tile = jax_kernels._build_tile_step(tp.jax_ant().sys)(
    soa(d["pos"]), soa(d["rot"]), soa(d["vel"]), soa(d["ang"]), jnp.asarray(d["act"].T))
paths = {
    "twin (CPU)": twin_cpu.vel.numpy(),
    "JAX jnp step": np.asarray(jnp_qp.vel),
    "JAX Pallas-kernel math": np.transpose(np.asarray(tile[2]), (2, 0, 1)),
}
for i in range(n):
    print(f"outlier {i}: max |vel| difference to the CUDA kernel / to the CUDA twin")
    for name, vel in paths.items():
        to_kernel = np.abs(vel[i] - d["kernel_vel"][i]).max()
        to_twin = np.abs(vel[i] - d["twin_vel"][i]).max()
        print(f"  {name:24s} {to_kernel:.3e} / {to_twin:.3e}")
