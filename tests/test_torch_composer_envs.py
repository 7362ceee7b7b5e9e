"""The port's composed envs stepped against the JAX package's, on the CPU.

From the port's reset, each step starts both envs from the same state (the
JAX state loaded into the port): the port steps its own physics (the PBD
twin, `kernels.pbd_step_plain`), the JAX env the JAX jnp physics
(tests/composer_parity.py); positions are held at 1e-4, obs, the
per-agent or scalar reward and the metrics at tests/test_torch_halfcheetah.py's
1e-3, done exactly.  The 2-agent chase (a (N, 2) reward), follow (the
reward_agents groups), sumo (frozen ring segments, the ring rewards'
votes), ant_push (a sphere object) and humanoid_run (spherical joints,
whose padded dofs the component's indices count: both packages clamp
them) are held; the 4-agent chase's step, whose JAX physics takes 25 s to
jit, is slow.  The wrappers are held with a per-agent reward.
"""

import numpy as np
import pytest
import torch

from brax_torch import composer
from brax_torch.composer import envs as cenvs
from brax_torch.envs import wrappers

from tests import composer_parity as cp
from tests.torch_parity import one_torch_thread  # noqa: F401

STEPS = 3


def _steps_match(scene, seed, steps=STEPS):
    env = cp.port_env(scene)
    state = env.reset(torch.Generator().manual_seed(0))
    jstate = cp.to_jax_state(state)
    for a in cp.actions(scene, seed, steps):
        shared = state.replace(qp=cp.port_qp(jstate.qp))
        jq, jinfo = cp.jax_physics(scene, shared.qp, a)
        state = env.step(shared, torch.from_numpy(a))
        jstate = cp.jax_env_step_given(scene)(jstate, a, jq, jinfo)
        np.testing.assert_allclose(state.qp.pos.numpy(), np.asarray(jstate.qp.pos), atol=1e-4)
        np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=cp.ENV_TOL)
        assert state.reward.shape == np.asarray(jstate.reward).shape
        np.testing.assert_allclose(state.reward.numpy(), np.asarray(jstate.reward),
                                   atol=cp.ENV_TOL, rtol=cp.ENV_TOL)
        np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))
        assert sorted(state.metrics) == sorted(jstate.metrics)
        for k, v in jstate.metrics.items():
            np.testing.assert_allclose(state.metrics[k].numpy(), np.asarray(v),
                                       atol=cp.ENV_TOL, rtol=cp.ENV_TOL, err_msg=k)
    return state


def test_chase_steps_match_jax():
    state = _steps_match("chase", seed=1)
    assert state.reward.shape == (cp.N, 2)


def test_follow_steps_match_jax():
    """follow: the leader's group by reward_agents, the follower's by name."""
    state = _steps_match("follow", seed=2)
    assert state.reward.shape == (cp.N, 2)


def test_sumo_steps_match_jax():
    _steps_match("sumo", seed=3)


def test_ant_push_steps_match_jax():
    state = _steps_match("ant_push", seed=4)
    assert state.reward.shape == (cp.N,)


def test_humanoid_run_steps_match_jax():
    _steps_match("humanoid_run", seed=5)


@pytest.mark.slow  # the JAX physics' jit: 25 s
def test_chase4_steps_match_jax():
    state = _steps_match("chase4", seed=6, steps=2)
    assert state.reward.shape == (cp.N, 4)


def test_wrappers_with_per_agent_reward():
    """The episode wrapper sums a (N, 2) reward over its action repeats; the
    auto-reset wrapper puts a done env back to its first state and obs and
    leaves the others and the reward be."""
    env = cenvs.create_ma_env(task="chase", episode_length=4, action_repeat=2, batch_size=3,
                              device="cpu")
    assert isinstance(env, wrappers.AutoResetWrapper)
    assert isinstance(env.env, wrappers.VmapWrapper)
    inner = env.unwrapped
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen)
    first_obs = state.obs.clone()
    act = torch.rand((3, env.action_size), generator=gen) * 2 - 1
    one = inner.step(inner.reset(), act)
    two = inner.step(one, act)
    stepped = env.step(state, act)
    torch.testing.assert_close(stepped.reward, one.reward + two.reward)
    assert stepped.reward.shape == (3, 2)
    assert stepped.info["steps"].tolist() == [2.0, 2.0, 2.0]
    stepped = env.step(stepped, act)  # steps 4: the episode ends
    assert stepped.done.tolist() == [1.0, 1.0, 1.0]
    assert stepped.reward.shape == (3, 2)
    torch.testing.assert_close(stepped.obs, first_obs)
    torch.testing.assert_close(stepped.qp.pos, state.info["first_qp"].pos)
    # a done vote of one env resets that env alone
    state = env.reset(gen)
    mid = env.step(state, act)
    forced = mid.replace(done=torch.tensor([0.0, 1.0, 0.0]))
    nxt = env.step(forced, act)
    assert nxt.info["steps"].tolist() == [4.0, 2.0, 4.0]


def test_octopus_waits_for_its_slice():
    """The octopus component's slice has landed: the component loads (root
    `octopus`, 27 bodies) and octopus_run builds a legacy-spring env of 63
    observations and 26 actions (tests/test_torch_octopus*.py hold it to
    the JAX package)."""
    spec = composer.components.load_component("octopus")
    assert spec.root == "octopus" and len(spec.config.bodies) == 27
    env = cenvs.create_env("octopus_run", batch_size=1, device="cpu")
    assert env.unwrapped.sys.dynamics_mode == "legacy_spring"
    assert (env.observation_size, env.action_size) == (63, 26)
