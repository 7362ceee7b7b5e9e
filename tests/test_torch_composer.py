"""The port's composer (`brax_torch/composer`) against the JAX package's:
every registered scene built leaf for leaf, the resets, and mirrors of
tests/test_composer.py's tests.

Each scene of the JAX composer registry (octopus_run, a legacy-spring
scene, in tests/test_torch_octopus.py), and the 4-agent chase, builds the same
System table for table, with the same observation and action widths,
agent groups and component indices; the resets (which draw nothing) give
the JAX reset's qp, obs, reward, done and metrics at
tests/test_torch_halfcheetah.py's reset tolerances (qp 1e-6, obs 1e-5, the
rest exact).  JAX resets are jitted once per scene (6-14 s each here), so
the non-slow test holds the 2-agent chase's and ant_push's, a slow one the
others.
"""

import numpy as np
import pytest
import torch

from brax_torch import composer
from brax_torch.composer import envs as cenvs
from brax_torch.sim import kernels
from brax_torch.sim.system import flatten

from tests import composer_parity as cp
from tests.test_torch_sim import _assert_tables_equal
from tests.torch_parity import one_torch_thread  # noqa: F401

# (bodies, contact points, lanes an env, obs width, action width) per scene
SHAPES = {"ant_run": (10, 5, 16, 81, 8), "pro_ant_run": (10, 18, 32, 81, 8),
          "ant_push": (11, 11, 16, 94, 8), "ant_on_ball": (11, 29, 32, 94, 8),
          "halfcheetah_run": (8, 9, 16, 23, 6), "humanoid_run": (12, 14, 16, 71, 17),
          "ant_chase": (19, 35, 64, 164, 16), "chase": (19, 35, 64, 164, 16),
          "follow": (19, 35, 64, 164, 16), "sumo": (39, 35, 64, 164, 16),
          "chase4": (37, 170, 256, 336, 32)}


def _two_ant_chase(batch_size=None, episode_length=50):
    return composer.create(
        components=dict(
            agent1=dict(component="ant", pos=(0.0, 2.0, 0.0),
                        reward_fns=dict(fwd=dict(reward_type="forward_velocity"))),
            agent2=dict(component="ant", pos=(0.0, -2.0, 0.0)),
        ),
        edges={"agent1__agent2": dict(collide_type="root",
                                      reward_fns=dict(chase=dict(reward_type="chase")))},
        agent_groups=dict(
            agent1=dict(action_agents=("agent1",),
                        reward_names=("chase__agent1__agent2", "fwd__agent1")),
            agent2=dict(action_agents=("agent2",), reward_names=("chase__agent1__agent2",)),
        ),
        episode_length=episode_length, batch_size=batch_size, auto_reset=True, device="cpu")


def test_every_scene_builds_as_jax():
    """Each scene's System, table for table, and its widths, agent groups and
    component indices; every scene is one the kernel covers (the wide ones
    past a warp), and the registry holds the JAX one's tasks."""
    assert cenvs.list_env() == sorted(cp.jax_composer_envs.list_env())
    for scene, (nb, nc, lanes, obs, act) in SHAPES.items():
        env, jenv = cp.port_env(scene, 2), cp.jax_env(scene)
        _assert_tables_equal(flatten(env.sys), flatten(jenv.sys))
        p = kernels.plan(env.sys)
        assert (env.sys.num_bodies, p.nc, p.lanes) == (nb, nc, lanes), scene
        assert (env.observation_size, env.action_size) == (obs, act), scene
        assert jenv.action_size == act, scene
        assert kernels.unsupported_features(env.sys, act) == [], scene
        assert env.agent_names == jenv.agent_names
        assert env.group_action_shapes == jenv.group_action_shapes
        for name, meta in env.component_meta.items():
            jmeta = jenv.component_meta[name]
            for key in ("body_idx", "root_idx", "joint_dof_idx", "act_idx", "observers"):
                assert meta[key] == jmeta[key], (scene, name, key)


def _reset_matches(scene):
    state = cp.port_env(scene).reset(torch.Generator().manual_seed(0))
    jstate = cp.jax_reset(scene)
    for got, want in zip(state.qp.numpy(), cp.tp.qp_numpy(jstate.qp)):
        np.testing.assert_allclose(got, cp.broadcast(want), atol=1e-6)
    np.testing.assert_allclose(state.obs.numpy(), cp.broadcast(jstate.obs), atol=1e-5)
    np.testing.assert_array_equal(state.reward.numpy(), cp.broadcast(jstate.reward))
    np.testing.assert_array_equal(state.done.numpy(), cp.broadcast(jstate.done))
    assert sorted(state.metrics) == sorted(jstate.metrics)
    for k, v in jstate.metrics.items():
        np.testing.assert_array_equal(state.metrics[k].numpy(), cp.broadcast(v), err_msg=k)


def test_reset_matches_jax():
    for scene in ("chase", "ant_push"):
        _reset_matches(scene)


@pytest.mark.slow  # a JAX reset jit of 6-14 s per scene
@pytest.mark.parametrize("scene", [s for s in cp.SCENES if s not in ("chase", "ant_push")])
def test_reset_matches_jax_every_scene(scene):
    _reset_matches(scene)


def test_two_ant_multiagent():
    """tests/test_composer.py::test_two_ant_multiagent on the port: a
    (N, 2) reward, 16 actions in two groups of 8, finite steps, the ants
    apart."""
    env = _two_ant_chase(batch_size=4)
    assert env.is_multiagent
    assert env.agent_names == ("agent1", "agent2")
    assert env.action_size == 16
    assert env.group_action_shapes["agent1"]["size"] == 8
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen)
    assert state.reward.shape == (4, 2)
    for _ in range(3):
        state = env.step(state, torch.rand((4, 16), generator=gen) * 2 - 1)
    assert state.reward.shape == (4, 2)
    assert bool(torch.isfinite(state.obs).all())
    m = env.unwrapped.component_meta
    sep = torch.linalg.norm(state.qp.pos[0, m["agent1"]["root_idx"]]
                            - state.qp.pos[0, m["agent2"]["root_idx"]])
    assert float(sep) > 1.0


def test_single_agent_scene_scalar_reward():
    """tests/test_composer.py::test_single_agent_scene_scalar_reward: a
    single-agent scene's reward is one number an env."""
    env = composer.create(
        components=dict(
            ant1=dict(component="ant", reward_fns=dict(
                fwd=dict(reward_type="forward_velocity"),
                ctrl=dict(reward_type="ctrl_cost", weight=0.1))),
            ball=dict(component="ball", pos=(2.0, 0.0, 1.0)),
        ),
        episode_length=20, batch_size=None, auto_reset=False, device="cpu")
    s = env.reset(torch.Generator().manual_seed(0))
    assert s.reward.shape == (1,)
    s = env.step(s, torch.zeros((1, env.action_size)))
    assert bool(torch.isfinite(s.reward).all())
    assert "reward_fwd__ant1" in s.metrics


def test_ma_descs_build_and_step():
    """tests/test_composer.py::test_ma_descs_build_and_step: the pointmass
    chase of 3 agents and sumo of 2 (2 agents, the ground and 20 frozen,
    non-colliding ring segments) build and step."""
    env = cenvs.create_ma_env(task="chase", main_agent="pointmass", other_agent="pointmass",
                              num_agents=3, episode_length=20, batch_size=2, device="cpu")
    assert env.unwrapped.agent_names == ("agent0", "agent1", "agent2")
    s = env.reset(torch.Generator().manual_seed(0))
    assert s.reward.shape == (2, 3)
    s = env.step(s, torch.zeros((2, env.action_size)))
    assert bool(torch.isfinite(s.obs).all())
    env = cenvs.create_ma_env(task="sumo", main_agent="pointmass", other_agent="pointmass",
                              num_agents=2, episode_length=10, batch_size=2, device="cpu")
    assert len(env.unwrapped.component_meta) == 23
    s = env.step(env.reset(torch.Generator().manual_seed(0)),
                 torch.zeros((2, env.action_size)))
    assert bool(torch.isfinite(s.obs).all())


def test_sa_descs_build_and_step():
    """tests/test_composer.py::test_sa_descs_build_and_step: ant_run,
    ant_push and pro_ant_run step; a dotted-path desc edit builds."""
    for task in ["ant_run", "ant_push", "pro_ant_run"]:
        env = cenvs.create_env(task, episode_length=16, auto_reset=False, device="cpu")
        s = env.reset(torch.Generator().manual_seed(0))
        s = env.step(s, torch.zeros((1, env.action_size)))
        assert bool(torch.isfinite(s.reward.sum())), task
    edited = cenvs.create_env("ant_push", desc_edits={"components.cap1.reward_fns.goal.scale": 0.2},
                              episode_length=16, auto_reset=False, device="cpu")
    s = edited.reset(torch.Generator().manual_seed(0))
    assert s.obs.shape == (1, edited.observation_size)
    reward = edited.unwrapped.reward_fns["goal__cap1"]
    plain = cp.port_env("ant_push", 1).reward_fns["goal__cap1"]
    moved = s.qp.replace(vel=s.qp.vel + 1.0)
    args = (edited.unwrapped, moved, s.qp, torch.zeros((1, 8)))
    torch.testing.assert_close(reward(*args)[0], 0.2 * plain(*args)[0])


def test_term_params_z_offset():
    """tests/test_composer.py::test_term_params_z_offset: ant_on_ball starts
    ~6 m up on the ball, and its height bounds are shifted with it, so a
    step from the reset does not terminate; the same height without the
    shift would."""
    env = cenvs.create_env("ant_on_ball", episode_length=16, auto_reset=False, batch_size=2,
                           device="cpu")
    s = env.reset(torch.Generator().manual_seed(0))
    assert float(s.done.max()) == 0.0
    inner = env.unwrapped
    meta = inner.component_meta["agent1"]
    assert float(s.qp.pos[0, meta["root_idx"], 2]) > 5.0
    zero = torch.zeros(2)
    assert float(meta["term_fn"](zero, s.qp, meta["root_idx"]).max()) == 0.0
    unshifted = composer.components.load_component("pro_ant", num_legs=4).term_fn
    assert float(unshifted(zero, s.qp, meta["root_idx"]).min()) == 1.0


def test_chaos_rule_strays_on_non_finite_outputs():
    """pbd_parity.chaos_rule counts an env whose output is NaN or infinite
    as straying: a planted fault that gives NaN (`wide_warp_local` over the
    4-agent chase's whole step, on the card) passed it before, as NaN
    compares false against any bound."""
    from brax_torch.sim import kernels as sim_kernels
    from brax_torch.tools import pbd_parity as pp

    env = pp.composer_env("chase", 4, "cpu")
    qp, act = pp.composer_states("chase", env, 4, 0, "cpu")[pp.COMPOSER_STATES[1]]
    want = pp.fields(*sim_kernels.pbd_step_plain(env.sys, qp, act))
    spread = {k: torch.full((4,), 1e9) for k in pp.TOLERANCE}  # a spread covering anything
    got = {k: v.clone() for k, v in want.items()}
    _, strays, _ = pp.chaos_rule(env.sys, qp, act, got, want, spread=spread)
    assert strays.tolist() == []
    got["vel"][1, 0, 0] = float("nan")
    got["pos"][3, 2, 1] = float("inf")
    report, strays, _ = pp.chaos_rule(env.sys, qp, act, got, want, spread=spread)
    assert strays.tolist() == [1, 3] and report["vel"]["outside"] == 1
