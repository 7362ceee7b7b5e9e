"""The port's PBD step on the thruster/twister and angle-actuator scenes
against the Pallas kernel's math, on the CPU.

`brax_tpu.sim.kernels._build_tile_step` (the Pallas kernel body, run
eagerly: jitting it costs minutes of CPU compile) over one pass (the
System with 2 substeps: what the CUDA kernel's loop repeats), 16 envs of
each scene from a reset, against `pbd_step_plain` on the same System, env
by env at `pbd_parity.TOLERANCE`.  The Pallas body clips a force's action
columns to num_joint_dof + num_forces_dof - 1, not to the action's width
(brax_tpu/sim/kernels.py:301-308), and reads past a narrower action; the
inverted pendulums' 1-wide action is therefore repeated to that width,
which the jnp path's clip reads alike
(tests/test_torch_forces.py::test_padded_action_steps_as_the_clip).
"""

import numpy as np
import pytest
import torch

from brax_torch.sim import kernels
from brax_torch.tools.pbd_parity import TOLERANCE, fields, one_pass

from tests import forces_parity as fp
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", fp.NAMES)
def test_twin_matches_pallas_kernel_math(name):
    sys = one_pass(fp.port_env(name).sys)
    qp = fp.reset_qp(name, seed=2)
    act = fp.physics_actions(name, seed=4)
    pallas_act = np.repeat(act, fp.PALLAS_ACT[name], axis=1) if act.shape[1] == 1 else act
    assert pallas_act.shape[1] == fp.PALLAS_ACT[name]
    out, info = kernels.pbd_step_plain(sys, qp, torch.from_numpy(act))
    got = fields(out, info)
    want = fp.pallas_one_pass(name, qp, pallas_act)
    for k, tol in TOLERANCE.items():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol, err_msg=k)
