"""v1 inverted_pendulum, inverted_double_pendulum, swimmer, reacherangle and
reacher of brax_torch against the JAX envs, on the CPU, and PPO at the
reacher recipe's shape.

Each env's reset_from_noise of the JAX reset's draws, then 10 steps of
both envs from there on the same actions (0.3 x uniform in [-1, 1], as
tests/test_env_suite_parity.py draws them), held at that file's PAIRS
horizon and tolerance for these envs (10 steps; atol 1e-4 with its rtol
3e-2 on the observation, 1e-3 on the reward).  reacherangle maps its
action onto the joint limits before the physics; swimmer appends its
viscous forces to the action.

Four envs run free on their own physics (the JAX env's jnp step traced in
kernel mode: see tests/forces_parity.py).  swimmer's step rounds at
PAIRS' 1e-4: from one reset state the JAX package's own Pallas body and jnp
path differ by 1.0e-4 rad/s in the links' angular velocity and 1.2e-4 m/s
in their velocity, and the port's env running free from states 1 float32
ulp apart spreads by 3.2e-4 in its observation over the 10 steps.  So
swimmer steps the JAX physics (tests/test_torch_forces_step.py and
tests/test_torch_forces_pallas.py hold its physics), and what is compared
is the env's own arithmetic: the physics action it builds (its viscous
forces, to 1e-6) and its observation, reward and metrics, as
tests/test_torch_halfcheetah.py does for halfcheetah's chaotic step.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from brax_torch import envs
from brax_torch.sim import kernels

from tests import forces_parity as fp
from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

OBS = {"inverted_pendulum": 4, "inverted_double_pendulum": 8, "swimmer": 8, "reacherangle": 11,
       "reacher": 11}
ACTION = {"inverted_pendulum": 1, "inverted_double_pendulum": 1, "swimmer": 2,
          "reacherangle": 2, "reacher": 2}
METRICS = {"inverted_pendulum": (), "inverted_double_pendulum": (),
           "swimmer": ("reward_fwd", "reward_ctrl", "x_position", "y_position",
                       "distance_from_origin", "x_velocity", "y_velocity", "forward_reward"),
           "reacherangle": ("rewardDist", "rewardCtrl"), "reacher": ("reward_dist", "reward_ctrl")}
# tests/test_env_suite_parity.py::test_env_parity's relative tolerance and
# reward tolerance, beside PAIRS' atol
OBS_RTOL, REWARD_ATOL = 3e-2, 1e-3


class RecordingPhysics(tp._GivenPhysics):
    """A JAX physics result handed to the port's env, recording the action
    the env steps its physics with."""

    def step(self, qp, act):
        self.act = act
        return super().step(qp, act)


@pytest.mark.parametrize("name", fp.NAMES)
def test_env_matches_jax(name):
    env = fp.port_env(name)
    keys = jax.random.split(jax.random.PRNGKey(11), fp.N)
    draws, jstate = fp.jax_reset(name)(keys)
    state = env.reset_from_noise(*(torch.from_numpy(np.array(d)) for d in draws))
    assert state.obs.shape == (fp.N, OBS[name]) and env.action_size == ACTION[name]
    assert sorted(state.metrics) == sorted(METRICS[name])
    for got, want in zip(state.qp.numpy(), tp.qp_numpy(jstate.qp)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=1e-5)
    for k in METRICS[name]:
        np.testing.assert_array_equal(state.metrics[k].numpy(), np.asarray(jstate.metrics[k]))

    acts = 0.3 * np.random.RandomState(5).uniform(-1, 1, (fp.ENV_STEPS, fp.N, ACTION[name]))
    before, physics, after = fp.jax_env_parts(name)
    drag = 0.0  # the largest viscous force column swimmer handed its physics
    for a in acts.astype(np.float32):
        jact = before(jstate.qp, a)
        jq, jinfo = physics(jstate.qp, jact)
        stepper = env
        if name == "swimmer":
            stepper = copy.copy(env)
            stepper.sys = RecordingPhysics(env.sys, fp.from_jax_qp(jq), None)
            state = state.replace(qp=fp.from_jax_qp(jstate.qp))
        state = stepper.step(state, torch.from_numpy(a))
        jstate = after(jstate, a, jq, jinfo)
        if name == "swimmer":
            np.testing.assert_allclose(stepper.sys.act.numpy(), np.asarray(jact), rtol=0,
                                       atol=1e-6)
            drag = max(drag, float(np.abs(np.asarray(jact)[:, 2:]).max()))
        np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))
    assert (drag > 1e-3) == (name == "swimmer")
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=fp.ENV_ATOL,
                               rtol=OBS_RTOL)
    np.testing.assert_allclose(state.reward.numpy(), np.asarray(jstate.reward),
                               atol=REWARD_ATOL)
    for k in METRICS[name]:
        np.testing.assert_allclose(state.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                   atol=fp.ENV_ATOL, rtol=OBS_RTOL, err_msg=k)


def test_create_registers_the_envs():
    """envs.create builds each env on the CPU at its batch; the CPU step
    runs the twin and launches nothing."""
    for name in fp.NAMES:
        env = envs.create(name, batch_size=2, episode_length=4, device="cpu")
        assert env.observation_size == OBS[name] and env.action_size == ACTION[name]
        state = env.reset(torch.Generator().manual_seed(0))
        before = kernels.pbd_step_launch.launches
        state = env.step(state, torch.zeros((2, ACTION[name])))
        assert kernels.pbd_step_launch.launches == before
        assert state.obs.shape == (2, OBS[name]) and bool(torch.isfinite(state.obs).all())


def test_ppo_trains_reacher_with_action_repeat():
    """One PPO training step at the reacher recipe's shape (action_repeat 4)
    at tiny sizes: each env step of the rollout is 4 physics steps."""
    from brax_torch.training.agents.ppo import train as ppo

    calls = []
    step = kernels.pbd_step_plain

    def counting(sys_, qp, act):
        calls.append(qp.pos.shape[0])
        return step(sys_, qp, act)

    kernels.pbd_step_plain = counting
    try:
        _, params, metrics = ppo.train(
            "reacher", num_timesteps=64, episode_length=8, action_repeat=4, num_envs=4,
            num_eval_envs=2, unroll_length=2, batch_size=4, num_minibatches=2,
            num_updates_per_batch=1, num_evals=1, normalize_observations=True,
            reward_scaling=5.0, discounting=0.95, seed=0, device="cpu")
    finally:
        kernels.pbd_step_plain = step
    for key in ("training/total_loss", "training/policy_loss", "training/v_loss",
                "eval/episode_reward"):
        assert np.isfinite(metrics[key]), key
    assert params[1]["hidden_0.kernel"].shape == (OBS["reacher"], 32)
    # the rollout: batch 4 x 2 minibatches / 4 envs x unroll 2 = 4 env steps of
    # 4 envs; the evaluation: 8 / 4 = 2 env steps of 2 envs; 4 physics steps each
    assert calls.count(4) == 4 * 4 and calls.count(2) == 2 * 4
