"""The port's PBD step (`kernels.pbd_step_plain`) on the thruster/twister
and angle-actuator scenes against the JAX jnp step, on the CPU.

v1 inverted_pendulum (its 1-wide action: the thruster's columns clipped to
column 0), inverted_double_pendulum, swimmer (2 torque columns and 9 force
columns), reacherangle (targets past the joint limits) and reacher, 16
envs each from a reset, against `jax.vmap(system._raw_step)` traced in the
JAX package's kernel mode (tests/forces_parity.py::jax_raw_step says why)
at tests/test_torch_step.py's one-step tolerances; a twister, which no
default scene has (swimmer with its torso's thruster made one), against
the JAX step and in the CPU's warp emulation of the kernel; and
`maths.quat_to_euler`, which swimmer's observation takes, against the JAX
package's.
"""

import jax
import numpy as np
import pytest
import torch

from brax_tpu import maths as jax_maths
from brax_tpu.envs.assets.swimmer import swimmer_config as jax_swimmer_config
from brax_tpu.sim import builder as jax_builder
from brax_tpu.sim import lowering
from brax_tpu.sim import system as jax_system
from brax_torch import maths
from brax_torch.envs.assets.swimmer import swimmer_config
from brax_torch.sim import builder, kernels
from brax_torch.sim.system import flatten
from brax_torch.tools.pbd_parity import TOLERANCE, fields, one_pass

from tests import forces_parity as fp
from tests import pbd_emulation
from tests.test_torch_sim import _assert_tables_equal
from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", fp.NAMES)
def test_twin_step_matches_jnp_path(name):
    """One whole step (substeps / 2 passes) from a reset, every field of
    every env within ONE_STEP.  The thrusters push: the cart's velocity or
    the links' move with the action."""
    sys = fp.port_env(name).sys
    qp = fp.reset_qp(name)
    act = fp.physics_actions(name, seed=1)
    assert act.shape[1] == fp.PHYSICS_ACT[name]
    out, info = kernels.pbd_step_plain(sys, qp, torch.from_numpy(act))
    want = fp.jax_fields(*fp.jax_raw_step(name)(tp.to_jax_qp(qp), act))
    got = fields(out, info)
    for k, tol in fp.ONE_STEP.items():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol, err_msg=k)
    if sys.force_groups:
        unforced, _ = kernels.pbd_step_plain(sys, qp, torch.zeros_like(torch.from_numpy(act)))
        moved = (out.vel - unforced.vel)[:, sys.force_groups[0].body].abs().amax(dim=(1, 2))
        assert (moved > 1e-3).all()


def test_quat_to_euler_matches_jax():
    """On 256 random unit quaternions and the identity, to float32 rounding
    of angles of O(1) (2e-6), as the JAX env takes it (under jit,
    jnp.arctan2); at rotations of +-90 degrees about y, where the middle
    angle's sine is clipped to +-1, that angle (the other two are
    atan2(0, 0), whose sign of zero rounding picks: 0 or pi)."""
    rs = np.random.RandomState(0)
    q = np.concatenate([rs.randn(256, 4), [[1, 0, 0, 0]]])
    half = np.sqrt(0.5)
    gimbal = np.array([[half, 0, half, 0], [half, 0, -half, 0]])
    q = np.concatenate([q, gimbal])
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(jax.jit(jax_maths.quat_to_euler)(q))
    got = maths.quat_to_euler(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got[:-2], want[:-2], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[-2:, 1], want[-2:, 1], rtol=0, atol=2e-6)


def test_twister_matches_jax_and_emulation():
    """swimmer's scene with its torso's thruster made a twister (an angular
    velocity change from three action columns): the build leaf for leaf,
    one pass of the twin against the JAX jnp pass (kernel mode) at
    ONE_STEP, and the kernel's PBD_FORCES section in the emulation against
    the twin at TOLERANCE, from swimmer's reset states."""
    def twisted(config):
        cfg = config()
        cfg.forces[0].kind = "twister"
        return cfg

    sys, _ = builder.build(twisted(swimmer_config), device="cpu")
    jax_sys, _ = jax_builder.build(twisted(jax_swimmer_config))
    _assert_tables_equal(flatten(sys), flatten(jax_sys))
    assert [f.kind for f in sys.force_groups] == ["thruster", "twister"]
    assert kernels.plan(sys).force_twister == (False, False, True)
    sys = one_pass(sys)
    qp = fp.reset_qp("swimmer")
    act = fp.physics_actions("swimmer", seed=5)
    out, info = kernels.pbd_step_plain(sys, qp, torch.from_numpy(act))
    untwisted, _ = kernels.pbd_step_plain(one_pass(fp.port_env("swimmer").sys), qp,
                                          torch.from_numpy(act))
    assert (out.ang[:, 0] - untwisted.ang[:, 0]).abs().amax() > 1e-2
    step = jax.jit(jax.vmap(lambda q, a: jax_system._raw_step(jax_sys.replace(substeps=2), q, a)))
    with lowering.kernel_mode():
        want = fp.jax_fields(*step(tp.to_jax_qp(qp), act))
    got = fields(out, info)
    for k, tol in fp.ONE_STEP.items():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol, err_msg=k)
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    errs = pbd_emulation.max_errors(sys, qp, torch.from_numpy(act))
    assert all(errs[k] <= TOLERANCE[k] for k in TOLERANCE), errs
