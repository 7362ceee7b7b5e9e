"""Published per-env PPO hyperparameters (tuning data, not code).

A copy of the data in `brax_tpu/braxlines/defaults.py`: the reference's
sweep defaults, mapped to the trainer's kwarg names.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

DEFAULT_PPO_PARAMS: Dict[str, Dict[str, Any]] = {
    "ant": dict(
        num_timesteps=30_000_000, num_evals=20, reward_scaling=10,
        episode_length=1000, normalize_observations=True, action_repeat=1,
        unroll_length=5, num_minibatches=32, num_updates_per_batch=4,
        discounting=0.97, learning_rate=3e-4, entropy_cost=1e-2,
        num_envs=2048, batch_size=1024,
    ),
    "humanoid": dict(
        num_timesteps=50_000_000, num_evals=20, reward_scaling=0.1,
        episode_length=1000, normalize_observations=True, action_repeat=1,
        unroll_length=10, num_minibatches=32, num_updates_per_batch=8,
        discounting=0.97, learning_rate=3e-4, entropy_cost=1e-3,
        num_envs=2048, batch_size=1024,
    ),
    "fetch": dict(
        num_timesteps=100_000_000, num_evals=20, reward_scaling=5,
        episode_length=1000, normalize_observations=True, action_repeat=1,
        unroll_length=20, num_minibatches=32, num_updates_per_batch=4,
        discounting=0.997, learning_rate=3e-4, entropy_cost=1e-3,
        num_envs=2048, batch_size=256,
    ),
    "grasp": dict(
        num_timesteps=600_000_000, num_evals=10, reward_scaling=10,
        episode_length=1000, normalize_observations=True, action_repeat=1,
        unroll_length=20, num_minibatches=32, num_updates_per_batch=2,
        discounting=0.99, learning_rate=3e-4, entropy_cost=1e-3,
        num_envs=2048, batch_size=256,
    ),
    "halfcheetah": dict(
        num_timesteps=100_000_000, num_evals=10, reward_scaling=1,
        episode_length=1000, normalize_observations=True, action_repeat=1,
        unroll_length=20, num_minibatches=32, num_updates_per_batch=8,
        discounting=0.95, learning_rate=3e-4, entropy_cost=1e-3,
        num_envs=2048, batch_size=512,
    ),
    "ur5e": dict(
        num_timesteps=20_000_000, num_evals=20, reward_scaling=10,
        episode_length=1000, normalize_observations=True, action_repeat=1,
        unroll_length=5, num_minibatches=32, num_updates_per_batch=4,
        discounting=0.95, learning_rate=2e-4, entropy_cost=1e-2,
        num_envs=2048, batch_size=1024,
    ),
    "reacher": dict(
        num_timesteps=100_000_000, num_evals=20, reward_scaling=5,
        episode_length=1000, normalize_observations=True, action_repeat=4,
        unroll_length=50, num_minibatches=32, num_updates_per_batch=8,
        discounting=0.95, learning_rate=3e-4, entropy_cost=1e-3,
        num_envs=2048, batch_size=256,
    ),
}
DEFAULT_PPO_PARAMS["hopper"] = DEFAULT_PPO_PARAMS["halfcheetah"]
DEFAULT_PPO_PARAMS["walker2d"] = DEFAULT_PPO_PARAMS["halfcheetah"]


def get_ppo_params(
    env_name: str,
    timesteps_multiplier: float = 1.0,
    num_timesteps: Optional[int] = None,
) -> Dict[str, Any]:
    """Per-env preset, optionally rescaled in training length."""
    params = copy.deepcopy(DEFAULT_PPO_PARAMS.get(env_name, DEFAULT_PPO_PARAMS["ant"]))
    if num_timesteps is not None:
        params["num_timesteps"] = num_timesteps
    else:
        params["num_timesteps"] = int(params["num_timesteps"] * timesteps_multiplier)
    return params
