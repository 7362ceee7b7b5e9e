"""v1 grasp of brax_torch against the JAX package, on the CPU: the build,
the angle actuators on spherical joints, the PBD step (`pbd_step_plain`)
from grasp's states, the Pallas kernel body over one pass, and the env.

grasp's scene: 16 bodies, 12 three-dof spherical joints with angle
actuators (strength 300, angular damping 50, two of each joint's three
dofs held to +-0.1 degrees), one-way contacts of the ball with the floor
(capsule-plane) and with the frozen palm (capsule-capsule), and two-way
capsule-capsule contacts of the four fingertips with the ball.  Its
states (`pbd_parity.grasp_states`): a reset, on uniform actions, and the
claw closed on the ball (all four fingertips on it).

The step is held against `jax.vmap(system._raw_step)` traced in the JAX
package's kernel mode (tests/forces_parity.py::jax_raw_step says why):
pos, rot and vel at ONE_STEP, ang and the contact impulses at the rounding
rule's TOLERANCE (`pbd_parity`), because grasp's stiff claw makes the JAX
step's own float32 rounding reach past ONE_STEP's 5e-4 rad/s:
`test_jnp_step_spreads_past_one_step` feeds it its reset input with
relative noise of 1e-7 (about one float32 ulp) and it moves its own
angular velocity by 1.0e-3 rad/s over one pass (measured 1.007e-3 at
these seeds; over the whole step 3.7e-4, with the claw closed 4.4e-4 and
4.7e-4), against the twin's 7.6e-4 from it.
"""

import jax
import numpy as np
import pytest
import torch

from brax_tpu.envs.assets.grasp import grasp_config as jax_grasp_config
from brax_tpu.sim import actuators as jax_actuators
from brax_tpu.sim import builder as jax_builder
from brax_tpu.sim.types import HArray
from brax_torch.envs.assets.grasp import grasp_config
from brax_torch.sim import actuators, builder, kernels
from brax_torch.sim.system import flatten
from brax_torch.tools.pbd_parity import GRASP_STATES, TOLERANCE, fields, one_pass, padded_grasp

from tests import forces_parity as fp
from tests import grasp_parity as gp
from tests.test_torch_sim import _assert_tables_equal
from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

# the fields held at ONE_STEP; the others at TOLERANCE
EXACT = ("pos", "rot", "vel")


def test_build_matches_jax_leaf_for_leaf():
    """grasp's System, table for table: its three contact groups (the
    one-way capsule-capsule one with the palm as body b), its spherical
    joints and angle actuators."""
    sys, _ = builder.build(grasp_config(), device="cpu")
    jax_sys, _ = jax_builder.build(jax_grasp_config())
    _assert_tables_equal(flatten(sys), flatten(jax_sys))
    assert [(type(c).__name__, c.com.one_way) for c in sys.contact_groups] == [
        ("CapsulePlane", True), ("CapsuleCapsule", True), ("CapsuleCapsule", False)]
    assert [(g.kind, g.dof, g.n) for g in sys.joint_groups] == [("spherical", 3, 12)]
    assert [a.kind for a in sys.actuator_groups] == ["angle"]


@pytest.mark.parametrize("padded", [False, True])
def test_spherical_angle_actuators_match_jax(padded):
    """`actuators.apply` of grasp's angle actuators on its spherical joints
    against the JAX package's, from the claw closed on the ball, on targets
    in degrees across and past the limits (+-120); padded: dof 0's column
    taken from every actuator but the first (`pbd_parity.padded_grasp`),
    each such dof PDing toward clip(0, lo, hi) in both.  Within 0.02 of
    torques up to ~250: each joint's middle Euler angle is an arccos of a
    dot product held within 0.1 degrees of 1 by its limits, where one
    float32 ulp of that product (6e-8) moves the angle by ~6e-5 rad and the
    torque, at strength 300, by ~0.02."""
    env = gp.port_env("grasp")
    sys = padded_grasp(env.sys) if padded else env.sys
    (group,) = sys.actuator_groups
    jax_sys = gp.jax_env("grasp").sys
    (jax_group,) = jax_sys.actuator_groups
    jax_group = jax_group.replace(act_index=HArray(group.act_index))
    qp, _ = gp.grasp_states()[GRASP_STATES[1]]
    act = np.random.RandomState(3).uniform(-120, 120, (gp.N, 39)).astype(np.float32)
    got = actuators.apply(group, sys.joint_groups[0], qp, torch.from_numpy(act), sys.nb)
    jg = jax_sys.joint_groups[0]
    want = jax.jit(jax.vmap(lambda q, a: jax_actuators.apply(jax_group, jg, q, a, jax_sys.nb)))(
        tp.to_jax_qp(qp), act)
    np.testing.assert_allclose(got.ang.numpy(), np.asarray(want.ang), rtol=0, atol=0.02)
    full = actuators.apply(env.sys.actuator_groups[0], env.sys.joint_groups[0], qp,
                           torch.from_numpy(act), env.sys.nb)
    assert bool((got.ang - full.ang).abs().max() > 1.0) == padded


@pytest.mark.parametrize("state", GRASP_STATES)
def test_twin_step_matches_jnp_path(state):
    """One pass and one whole step of the twin from each grasp state
    against the JAX jnp step: pos, rot and vel at ONE_STEP, ang and the
    contact impulses at TOLERANCE, every env; from the closed claw the
    fingertips, the palm and the floor all push the ball."""
    env = gp.port_env("grasp")
    qp, act = gp.grasp_states()[state]
    jax_sys = gp.jax_env("grasp").sys
    for passes, sys in ((1, one_pass(env.sys)), (None, env.sys)):
        out, info = kernels.pbd_step_plain(sys, qp, act)
        got = fields(out, info)
        want = gp.jax_step("grasp", jax_sys, qp, act, passes)
        for k in TOLERANCE:
            tol = fp.ONE_STEP[k] if k in EXACT else TOLERANCE[k]
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol,
                                       err_msg=f"{k}, {passes or 'whole step'}")
    if state == GRASP_STATES[1]:
        ball = env.art.body_index["Object"]
        assert bool((info.contact.vel[:, ball].abs().amax(dim=1) > 0).all())


def test_jnp_step_spreads_past_one_step():
    """The JAX jnp pass itself, fed its reset input with relative noise of
    1e-7, moves its angular velocity by more than ONE_STEP's 5e-4 (1.0e-3
    at these seeds): grasp's ang is held to TOLERANCE, not ONE_STEP."""
    qp, act = gp.grasp_states()[GRASP_STATES[0]]
    jax_sys = gp.jax_env("grasp").sys
    base = gp.jax_step("grasp", jax_sys, qp, act, 1)
    gen = torch.Generator().manual_seed(3)
    spread = 0.0
    for _ in range(4):
        noisy = type(qp)(*(x * (1 + 1e-7 * (torch.rand(x.shape, generator=gen) * 2 - 1))
                           for x in (qp.pos, qp.rot, qp.vel, qp.ang)))
        moved = gp.jax_step("grasp", jax_sys, noisy, act, 1)
        spread = max(spread, float((moved["ang"] - base["ang"]).abs().max()))
    assert fp.ONE_STEP["ang"] < spread < TOLERANCE["ang"], spread


def test_twin_matches_pallas_kernel_math():
    """The Pallas kernel body over one pass (run eagerly) from the closed
    claw, env by env at TOLERANCE: its one-way capsule-capsule branch and
    its spherical angle actuators, the math the CUDA kernel follows."""
    env = gp.port_env("grasp")
    qp, act = gp.grasp_states()[GRASP_STATES[1]]
    got = fields(*kernels.pbd_step_plain(one_pass(env.sys), qp, act))
    want = gp.pallas_one_pass(gp.jax_env("grasp").sys, qp, act)
    for k, tol in TOLERANCE.items():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol, err_msg=k)


def test_env_matches_jax():
    """grasp's reset and 3 steps of both envs on the same actions (0.3 x
    uniform in [-1, 1], as tests/test_env_suite_parity.py draws them), each
    on its own physics, the new target's draws handed across: PAIRS' atol
    2e-3 (rtol 3e-2) on the observation, 1e-3 on the reward and metrics;
    each step's physics input (the palm moved, the action rescaled) to
    float32 rounding."""
    name = "grasp"
    env = gp.port_env(name)
    keys = jax.random.split(jax.random.PRNGKey(11), gp.N)
    _, jstate = gp.jax_reset(name)(keys)
    state = gp.port_reset(name, ())
    assert state.obs.shape == (gp.N, gp.OBS[name]) and env.action_size == gp.ACTION[name]
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=1e-6)
    before, draws, after = gp.jax_env_parts(name)
    acts = 0.3 * np.random.RandomState(5).uniform(-1, 1, (gp.ENV_STEPS[name], gp.N, 39))
    for a in acts.astype(np.float32):
        jqp, jact = before(jstate, a)
        pqp, pact = env.physics_input(state.qp, torch.from_numpy(a))
        np.testing.assert_allclose(pact.numpy(), np.asarray(jact), rtol=1e-6, atol=1e-5)
        jnext, jinfo = gp.jax_raw(name, gp.jax_env(name).sys, fp.from_jax_qp(jqp), jact)
        state = gp.port_step(name, state, a, draws(jstate))
        jstate = after(jstate, a, jnext, jinfo)
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs),
                               atol=gp.ENV_ATOL[name], rtol=3e-2)
    np.testing.assert_allclose(state.reward.numpy(), np.asarray(jstate.reward), atol=1e-3)
    for k in gp.METRICS[name]:
        np.testing.assert_allclose(state.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                   atol=1e-3, err_msg=k)
