"""The v1 humanoid path of brax_torch against the JAX package, on the CPU.

Covers the spherical-joint group (`builder.build`'s sphericalization, the
joints' spherical axis_angle and PBD rows, torque actuators over 3-dof
joints), the plain-torch step (`pbd_step_plain`) against the JAX jnp step,
the three humanoid envs (humanoid, the fork's humanoid_new; humanoid_legacy;
humanoidstandup), the fused MLP's plain versions at the humanoid widths,
and PPO at tiny sizes through `ppo.train` and `brax_torch.tools.brax_training`.

Inputs are made with numpy from seeds and handed to both packages.  Each
JAX function is jitted once per process (the lru_caches below): the
humanoid's and humanoid_legacy's Systems are equal, so they share one
compiled JAX step (~9 s of compile on this CPU); humanoidstandup has its
own.  The kernel itself is held to the twin by tests/test_torch_pbd_launch.py
(emulated) and tests/test_torch_cuda.py and chip_smoke.py (on the card).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.envs import humanoid as jax_humanoid
from brax_tpu.envs import humanoid_standup as jax_humanoid_standup
from brax_tpu.sim import actuators as jax_actuators
from brax_tpu.sim import builder as jax_builder
from brax_tpu.sim import joints as jax_joints
from brax_tpu.sim import system as jax_system
from brax_torch import envs
from brax_torch.envs.assets.humanoid import humanoid_config, humanoid_config_spring
from brax_torch.envs.assets.humanoid_new import humanoid_new_config
from brax_torch.envs.assets.humanoid_standup import humanoid_standup_config
from brax_torch.envs.humanoid import Humanoid, HumanoidLegacy
from brax_torch.envs.humanoid_standup import HumanoidStandup
from brax_torch.sim import actuators, builder, joints, kernels
from brax_torch.sim.system import flatten
from brax_torch.sim.types import QP

from tests import torch_parity as tp
from tests.test_torch_fused_mlp import _compare as compare_dense_chain
from tests.test_torch_sim import _assert_tables_equal
from tests.torch_parity import one_torch_thread  # noqa: F401

N = 8
NDOF = 17
OBS = 240
# the env registry's names, the port's and the JAX package's env classes
ENVS = {
    "humanoid": (Humanoid, jax_humanoid.Humanoid),
    "humanoid_legacy": (HumanoidLegacy, jax_humanoid.HumanoidLegacy),
    "humanoidstandup": (HumanoidStandup, jax_humanoid_standup.HumanoidStandup),
}
CONFIGS = {"humanoid": humanoid_new_config, "humanoid_legacy": humanoid_config,
           "humanoidstandup": humanoid_standup_config}
# the humanoid and humanoid_legacy scenes build to equal Systems
PHYSICS = {"humanoid": "humanoid", "humanoid_legacy": "humanoid",
           "humanoidstandup": "humanoidstandup"}
# tests/test_env_suite_parity.py::PAIRS' humanoid tolerance and horizon
ENV_TOL, ENV_STEPS = 1e-3, 5
METRICS = {"humanoid": ("forward_reward", "reward_linvel", "reward_quadctrl", "reward_alive",
                        "x_position", "y_position", "distance_from_origin", "x_velocity",
                        "y_velocity"),
           "humanoidstandup": ("reward_linup", "reward_quadctrl")}
METRICS["humanoid_legacy"] = METRICS["humanoid"]


@functools.lru_cache(maxsize=None)
def jax_env(name):
    return ENVS[name][1]()


@functools.lru_cache(maxsize=None)
def port_env(name):
    return ENVS[name][0](batch_size=N, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_raw_step(physics):
    """(qp, act) -> (qp, info): the JAX jnp physics step, vmapped."""
    sys = jax_env(physics).sys
    return jax.jit(jax.vmap(lambda qp, act: jax_system._raw_step(sys, qp, act)))


@functools.lru_cache(maxsize=None)
def jax_obs(name):
    """(qp, act) -> obs: the JAX env's observation, vmapped."""
    env = jax_env(name)
    return jax.jit(jax.vmap(lambda qp, act: env._get_obs(qp, None, act)))


@functools.lru_cache(maxsize=None)
def jax_env_step_given(name):
    """(state, act, qp_next, info) -> state: the JAX env step with its physics
    given (from `jax_raw_step`), so that the physics compiles once."""
    def step(state, act, qp, info):
        env = copy.copy(jax_env(name))
        env.sys = tp._GivenPhysics(env.sys, qp, info)
        return env.step(state, act)

    return jax.jit(jax.vmap(step))


def noise(seed, scale=1e-2):
    rs = np.random.RandomState(seed)
    return tuple(rs.uniform(-scale, scale, (N, NDOF)).astype(np.float32) for _ in range(2))


def actions(seed, steps=1):
    return np.random.RandomState(seed).uniform(-1, 1, (steps, N, NDOF)).astype(np.float32)


def reset_qp(name, seed=0, scale=1e-2):
    """The port's default_qp from the reset's noise (its parity with the JAX
    default_qp is test_default_qp_matches_jax's)."""
    qpos, qvel = noise(seed, scale)
    return port_env(name)._reset_qp(torch.from_numpy(qpos), torch.from_numpy(qvel))


def jax_qp(qp):
    return tp.to_jax_qp(qp)


# ---------------------------------------------------------------------------
# the scene build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_build_matches_jax(name):
    """The port's System equals the JAX build leaf by leaf: one spherical
    group of 10 joints, free_dofs (2, 1, 3, 1, 3, 1, 2, 1, 2, 1), limits
    padded with (0, 0), -1 in the padded dofs' action columns, 17 dofs."""
    config = CONFIGS[name]()
    limits_before = [list(j.angle_limits) for j in config.joints]
    sys, art = builder.build(config, device="cpu")
    jax_sys, jax_art = jax_builder.build(CONFIGS[name]())
    _assert_tables_equal(flatten(sys), flatten(jax_sys))
    (g,), (a,) = sys.joint_groups, sys.actuator_groups
    assert g.kind == "spherical" and g.dof == 3
    assert g.free_dofs == (2, 1, 3, 1, 3, 1, 2, 1, 2, 1)
    assert sys.num_joint_dof == art.action_size == jax_art.action_size == NDOF
    assert a.act_index.tolist()[:3] == [[0, 1, -1], [2, -1, -1], [3, 4, 5]]
    assert not g.limit[1, 1:].any()  # a 1-dof joint's padded rows
    # the caller's config is not padded; the artifacts' copy is, as in JAX
    assert [list(j.angle_limits) for j in config.joints] == limits_before
    assert [len(j.angle_limits) for j in art.config.joints] == [3] * 10
    assert [list(j.angle_limits) for j in art.config.joints] == [
        list(j.angle_limits) for j in jax_art.config.joints]


def test_spring_modes_still_raise():
    with pytest.raises(NotImplementedError, match="legacy_spring"):
        builder.build(humanoid_config_spring(), device="cpu")
    for cls in (HumanoidLegacy, HumanoidStandup):
        with pytest.raises(NotImplementedError, match="legacy_spring"):
            cls(legacy_spring=True, device="cpu")


def test_default_qp_matches_jax():
    """default_qp of the 3-dof padded joints, from the reset's noise."""
    env = jax_env("humanoid")
    qpos, qvel = noise(seed=0)
    fn = jax.jit(jax.vmap(lambda n1, n2: env.default_qp(
        joint_angle=env.default_angle() + n1, joint_velocity=n2)))
    for got, want in zip(reset_qp("humanoid").numpy(), tp.qp_numpy(fn(qpos, qvel))):
        np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# spherical joints and the actuators
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def joint_states():
    """Two batches of humanoid states: from reset, and with joint angles of
    up to 1.5 rad and velocities, so that most joints' Euler angles lie
    outside their limits and the spherical rows' masks fire."""
    return {"reset": reset_qp("humanoid"), "outside": reset_qp("humanoid", seed=3, scale=1.5)}


@functools.lru_cache(maxsize=None)
def _jax_joint_fns():
    sys = jax_env("humanoid").sys
    g, a = sys.joint_groups[0], sys.actuator_groups[0]
    nb = sys.num_bodies
    axis_angle = lambda qp: jax_joints.axis_angle(g, qp.take(g.parent), qp.take(g.child))
    return {
        "axis_angle": jax.jit(jax.vmap(axis_angle)),
        "pbd_apply": jax.jit(jax.vmap(lambda qp: jax_joints.pbd_apply(g, qp, nb))),
        "actuators": jax.jit(jax.vmap(lambda qp, act: jax_actuators.apply(a, g, qp, act, nb))),
        "angle_vel": jax.jit(jax.vmap(sys.joint_angle_vel)),
    }


def assert_theta_close(got, want):
    """theta (the middle Euler angle) is an arccos: where its argument is
    near 1 (theta near 0, as at a padded dof) a float32 error e of the
    argument moves theta by ~sqrt(2 e), so an ulp-level difference in the
    axes gives ~1e-3.  Held to: the argument, cos(theta), to 2e-6, and theta
    to 1e-4 where |theta| > 0.05."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(np.cos(got), np.cos(want), atol=2e-6)
    far = np.abs(want) > 0.05
    np.testing.assert_allclose(got[far], want[far], atol=1e-4)


@pytest.mark.parametrize("state", ["reset", "outside"])
def test_spherical_axis_angle_matches_jax(joint_states, state):
    """Axes and Euler angles (psi, theta, phi) of the 10 joints."""
    qp = joint_states[state]
    sys = port_env("humanoid").sys
    g = sys.joint_groups[0]
    axes, angles = joints.axis_angle(g, qp.take(g.parent), qp.take(g.child))
    jaxes, jangles = _jax_joint_fns()["axis_angle"](jax_qp(qp))
    jangles = np.asarray(jangles)
    assert axes.shape == (N, 10, 3, 3) and angles.shape == (N, 10, 3)
    np.testing.assert_allclose(axes.numpy(), np.asarray(jaxes), atol=1e-6)
    np.testing.assert_allclose(angles[..., [0, 2]].numpy(), jangles[..., [0, 2]], atol=1e-5)
    assert_theta_close(angles[..., 1].numpy(), jangles[..., 1])
    lo, hi = g.limit[..., 0], g.limit[..., 1]
    outside = ((angles < lo) | (angles > hi)).float().mean()
    assert (outside > 0.3) if state == "outside" else (outside < 0.3)


@pytest.mark.parametrize("state", ["reset", "outside"])
def test_spherical_pbd_apply_matches_jax(joint_states, state):
    """The position projection with the three Euler rows, scattered onto
    the bodies, outside the limits too (where the masks fire)."""
    qp = joint_states[state]
    sys = port_env("humanoid").sys
    dq = joints.pbd_apply(sys.joint_groups[0], qp, sys.nb)
    jdq = _jax_joint_fns()["pbd_apply"](jax_qp(qp))
    np.testing.assert_allclose(dq.pos.numpy(), np.asarray(jdq.pos), atol=1e-6)
    np.testing.assert_allclose(dq.rot.numpy(), np.asarray(jdq.rot), atol=2e-5)
    if state == "outside":
        assert np.abs(np.asarray(jdq.rot)).max() > 1e-2


@pytest.mark.parametrize("state", ["reset", "outside"])
def test_torque_actuators_over_3dof_joints_match_jax(joint_states, state):
    """Torques over every dof's axis, gated by each dof's own limits; the
    padded dofs' -1 columns are masked."""
    qp = joint_states[state]
    sys = port_env("humanoid").sys
    act = actions(seed=4)[0]
    dp = actuators.apply(sys.actuator_groups[0], sys.joint_groups[0], qp, torch.from_numpy(act),
                         sys.nb)
    jdp = _jax_joint_fns()["actuators"](jax_qp(qp), act)
    np.testing.assert_allclose(dp.ang.numpy(), np.asarray(jdp.ang), rtol=1e-5, atol=1e-5)
    assert not dp.vel.any()


def test_joint_angle_vel_matches_jax(joint_states):
    """System.joint_angle_vel: the 17 free dofs' angles and velocities."""
    qp = joint_states["outside"]
    angle, vel = port_env("humanoid").sys.joint_angle_vel(qp)
    jangle, jvel = _jax_joint_fns()["angle_vel"](jax_qp(qp))
    assert angle.shape == vel.shape == (N, NDOF)
    # a 2-dof joint's second free dof is its theta
    theta = [1, 6, 13, 15]
    psi_phi = [i for i in range(NDOF) if i not in theta]
    np.testing.assert_allclose(angle[:, psi_phi].numpy(), np.asarray(jangle)[:, psi_phi],
                               atol=1e-5)
    assert_theta_close(angle[:, theta].numpy(), np.asarray(jangle)[:, theta])
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), atol=1e-5)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _settled(physics, steps=10):
    """The JAX state `steps` jnp steps on from a reset, and one more action."""
    acts = actions(seed=2, steps=steps + 1)
    jq = jax_qp(reset_qp(physics))
    for a in acts[:steps]:
        jq, info = jax_raw_step(physics)(jq, a)
    return QP.from_numpy(*tp.qp_numpy(jq), device="cpu"), acts[steps], info


@pytest.mark.parametrize("physics", ["humanoid", "humanoidstandup"])
def test_twin_step_matches_jnp_path_from_reset(physics):
    """pbd_step_plain against jax.vmap(_raw_step), 8 envs from a reset, at
    tests/test_torch_step.py's one-step tolerances."""
    sys = port_env(physics).sys
    qp = reset_qp(physics)
    act = actions(seed=1)[0]
    out, info = kernels.pbd_step_plain(sys, qp, torch.from_numpy(act))
    jout, jinfo = jax_raw_step(physics)(jax_qp(qp), act)
    for got, want, atol in zip((out.pos, out.rot, out.vel, out.ang), tp.qp_numpy(jout),
                               (2e-5, 2e-5, 5e-4, 5e-4)):
        np.testing.assert_allclose(got.numpy(), want, atol=atol)
    np.testing.assert_allclose(info.contact.vel.numpy(), np.asarray(jinfo.contact.vel), atol=5e-4)
    np.testing.assert_allclose(info.contact.ang.numpy(), np.asarray(jinfo.contact.ang), atol=5e-4)


@pytest.mark.parametrize("physics", ["humanoid", "humanoidstandup"])
def test_twin_step_matches_jnp_path_in_contact(physics):
    """One step from a state 10 JAX steps after reset, feet (humanoid) or
    body (humanoidstandup) on the floor, at the in-contact tolerances."""
    qp, act, _ = _settled(physics)
    out, info = kernels.pbd_step_plain(port_env(physics).sys, qp, torch.from_numpy(act))
    jout, jinfo = jax_raw_step(physics)(jax_qp(qp), act)
    assert (np.abs(np.asarray(jinfo.contact.vel)) > 0).any(axis=(1, 2)).mean() > 0.5
    jpos, _, jvel, _ = tp.qp_numpy(jout)
    np.testing.assert_allclose(out.pos.numpy(), jpos, atol=1e-4)
    np.testing.assert_allclose(out.vel.numpy(), jvel, atol=3e-3)
    np.testing.assert_allclose(info.contact.vel.numpy(), np.asarray(jinfo.contact.vel), atol=3e-3)
    np.testing.assert_allclose(info.contact.ang.numpy(), np.asarray(jinfo.contact.ang), atol=3e-3)


# ---------------------------------------------------------------------------
# the envs
# ---------------------------------------------------------------------------


def _to_jax_state(name, state):
    from brax_tpu.envs import base as jax_base

    num = lambda t: jnp.asarray(t.detach().cpu().numpy())
    return jax_base.State(qp=jax_qp(state.qp), obs=num(state.obs), reward=num(state.reward),
                          done=num(state.done),
                          metrics={k: num(state.metrics[k]) for k in METRICS[name]})


@pytest.mark.parametrize("name", list(ENVS))
def test_env_matches_jax(name):
    """From a shared reset QP, the reset observation, then 5 steps each
    from the JAX env's state loaded into the port: obs, reward, done and
    metrics at tests/test_env_suite_parity.py's humanoid tolerance."""
    env = port_env(name)
    qpos, qvel = noise(seed=0)
    state = env.reset_from_noise(torch.from_numpy(qpos), torch.from_numpy(qvel))
    assert state.obs.shape == (N, OBS) and sorted(state.metrics) == sorted(METRICS[name])
    zero = np.zeros((N, NDOF), np.float32)
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jax_obs(name)(jax_qp(state.qp), zero)),
                               atol=1e-5)
    jstate = _to_jax_state(name, state)
    for a in actions(seed=6, steps=ENV_STEPS):
        shared = state.replace(qp=QP.from_numpy(*tp.qp_numpy(jstate.qp), device="cpu"))
        state = env.step(shared, torch.from_numpy(a))
        jq, jinfo = jax_raw_step(PHYSICS[name])(jstate.qp, a)
        jstate = jax_env_step_given(name)(jstate, a, jq, jinfo)
        np.testing.assert_allclose(state.qp.pos.numpy(), np.asarray(jstate.qp.pos), atol=1e-4)
        np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=ENV_TOL)
        np.testing.assert_allclose(state.reward.numpy(), np.asarray(jstate.reward),
                                   atol=ENV_TOL, rtol=ENV_TOL)
        np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))
        for k in METRICS[name]:
            np.testing.assert_allclose(state.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                       atol=ENV_TOL, rtol=ENV_TOL, err_msg=k)


def test_qfrc_actuator_block_reads_column_0_for_padded_dofs():
    """The observation's last 30 entries are each actuator's 3 action
    columns times its strength, gathered as jnp.take(mode="clip") gathers:
    a padded dof's -1 reads column 0, unmasked, in both packages."""
    env = port_env("humanoid")
    qp = reset_qp("humanoid")
    act = np.zeros((N, NDOF), np.float32)
    act[:, 0] = np.linspace(0.1, 0.8, N)
    obs = env._get_obs(qp, torch.from_numpy(act)).numpy()
    jobs = np.asarray(jax_obs("humanoid")(jax_qp(qp), act))
    np.testing.assert_allclose(obs, jobs, atol=1e-5)
    a = env.sys.actuator_groups[0]
    qfrc = obs[:, OBS - 30:].reshape(N, 10, 3)
    strength = a.strength.numpy()
    for k, cols in enumerate(a.act_index):
        for d, col in enumerate(cols):
            want = act[:, 0] * strength[k] if col in (-1, 0) else np.zeros(N)
            np.testing.assert_allclose(qfrc[:, k, d], want, rtol=1e-6)
    assert (qfrc[:, 1, 1:] != 0).all()  # actuator 1's padded dofs read column 0


def test_create_registers_the_humanoids():
    """envs.create builds each humanoid on the CPU at its batch, 240-wide obs
    and 17 actions; the CPU step runs the twin and launches nothing."""
    for name in ENVS:
        env = envs.create(name, batch_size=2, episode_length=4, device="cpu")
        assert env.observation_size == OBS and env.action_size == NDOF
        state = env.reset(torch.Generator().manual_seed(0))
        before = kernels.pbd_step_launch.launches
        state = env.step(state, torch.zeros((2, NDOF)))
        assert kernels.pbd_step_launch.launches == before
        assert state.obs.shape == (2, OBS) and bool(torch.isfinite(state.obs).all())


# ---------------------------------------------------------------------------
# the fused MLP at the humanoid widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [(10,), (2, 7)])
@pytest.mark.parametrize("sizes", [(256,) * 5 + (1,), (32,) * 4 + (34,)],
                         ids=["value", "policy"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_dense_chain_plain_matches_jax_at_humanoid_widths(rows, sizes, bf16):
    """240-wide observations into the value chain (-> 1) and the policy
    chain (-> 34: 17 means and 17 scales), at
    tests/test_torch_fused_mlp.py's tolerances."""
    compare_dense_chain(rows, OBS, sizes, "swish", bf16)


# ---------------------------------------------------------------------------
# PPO and the training entry point
# ---------------------------------------------------------------------------


def test_ppo_trains_humanoid_for_one_step():
    from brax_torch.training.agents.ppo import train as ppo

    _, params, metrics = ppo.train(
        "humanoid", num_timesteps=32, episode_length=4, num_envs=4, num_eval_envs=2,
        unroll_length=2, batch_size=4, num_minibatches=4, num_updates_per_batch=1,
        num_evals=1, normalize_observations=True, reward_scaling=0.1, seed=0, device="cpu")
    for key in ("training/total_loss", "training/policy_loss", "training/v_loss",
                "eval/episode_reward"):
        assert np.isfinite(metrics[key]), key
    assert params[1]["hidden_0.kernel"].shape == (OBS, 32)


def test_brax_training_entry_point_on_cpu(tmp_path, capsys):
    """The humanoid recipe at 32 envs and a batch of 1 for one training step
    (320 env steps, 256 minibatch steps), its evaluations cut to 2 envs x 4
    steps."""
    from brax_torch.tools import brax_training

    metrics = brax_training.main(
        ["--num_timesteps", "320", "--num_envs", "32", "--batch_size", "1", "--device", "cpu",
         "--logdir", str(tmp_path)], num_eval_envs=2, episode_length=4)
    assert np.isfinite(metrics["training/total_loss"])
    out = capsys.readouterr().out
    assert "time to first training step" in out and "time to train" in out
    rows = (tmp_path / "curve.csv").read_text().split()
    assert [int(r.split(",")[0]) for r in rows] == [0, 320]
