"""PPO on the legacy-spring ant, on the CPU: the trainer at the ant
recipe's network shapes (policy 87 -> 32x4 -> 16, value 87 -> 256x5 -> 1)
on a factory of `envs.create_fn("ant", legacy_spring=True)`, one training
step at tiny sizes, every physics step a spring one.  chip_smoke.py runs
the recipe at full width on the card.
"""

import numpy as np
import torch

from brax_torch import envs
from brax_torch.sim import kernels
from brax_torch.training.agents.ppo import train as ppo

from tests.torch_parity import one_torch_thread  # noqa: F401

SPRING_ANT = envs.create_fn("ant", legacy_spring=True, episode_length=None, auto_reset=False)


def spring_ant(batch_size, device):
    """The bare spring ant: the factory PPO trains on."""
    return SPRING_ANT(batch_size=batch_size, device=device).unwrapped


def test_create_fn_makes_the_spring_ant():
    env = spring_ant(3, "cpu")
    assert type(env).__name__ == "Ant" and env.sys.dynamics_mode == "legacy_spring"
    assert env.observation_size == 87 and env.action_size == 8
    state = env.reset(torch.Generator().manual_seed(0))
    state = env.step(state, torch.zeros((3, 8)))
    assert bool(torch.isfinite(state.obs).all())


def test_ppo_trains_spring_ant():
    modes = []
    step = kernels.pbd_step_plain

    def recording(sys_, qp, act):
        modes.append((sys_.dynamics_mode, qp.pos.shape[0]))
        return step(sys_, qp, act)

    kernels.pbd_step_plain = recording
    try:
        _, params, metrics = ppo.train(
            spring_ant, num_timesteps=16, episode_length=8, num_envs=4, num_eval_envs=2,
            unroll_length=2, batch_size=4, num_minibatches=2, num_updates_per_batch=1,
            num_evals=1, normalize_observations=True, reward_scaling=10.0, discounting=0.97,
            seed=0, device="cpu")
    finally:
        kernels.pbd_step_plain = step
    for key in ("training/total_loss", "training/policy_loss", "training/v_loss",
                "eval/episode_reward"):
        assert np.isfinite(metrics[key]), key
    policy = params[1]
    assert policy["hidden_0.kernel"].shape == (87, 32) and policy["hidden_4.kernel"].shape == (32, 16)
    # the rollout: 4 env steps of 4 envs; the evaluation: 8 env steps of 2
    assert sorted(set(modes)) == [("legacy_spring", 2), ("legacy_spring", 4)]
    assert modes.count(("legacy_spring", 4)) == 4 and modes.count(("legacy_spring", 2)) == 8
