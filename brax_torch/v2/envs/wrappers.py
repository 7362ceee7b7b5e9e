"""Wrappers for the v2 envs, batch-first.

Counterpart of `brax_tpu/v2/envs/wrappers.py`.  The port's envs step their
whole batch already, so `VmapWrapper` is the identity.  Wrappers return
new info dicts rather than updating the ones of the state they were given.
`EvalMetrics` is the v1 class: the JAX package's two have the same fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from brax_torch.envs.wrappers import EvalMetrics, eval_reset, eval_step
from brax_torch.v2.base import Tensor
from brax_torch.v2.envs import env as v2_env


def wrap_for_training(env: v2_env.Env, episode_length: int = 1000,
                      action_repeat: int = 1) -> v2_env.Wrapper:
    """Episode -> Vmap -> AutoReset, the standard trainer stack (v2 envs)."""
    env = EpisodeWrapper(env, episode_length, action_repeat)
    env = VmapWrapper(env)
    env = AutoResetWrapper(env)
    return env


class VmapWrapper(v2_env.Wrapper):
    """The identity: the wrapped env already steps its whole batch."""

    def __init__(self, env: v2_env.Env, batch_size: Optional[int] = None):
        super().__init__(env)
        if batch_size is not None and batch_size != env.batch_size:
            raise ValueError(f"batch_size {batch_size} != the env's {env.batch_size}")


class EpisodeWrapper(v2_env.Wrapper):
    """Counts steps, sets done at episode_length, repeats actions."""

    def __init__(self, env: v2_env.Env, episode_length: int, action_repeat: int):
        super().__init__(env)
        self.episode_length = episode_length
        self.action_repeat = action_repeat

    def reset(self, rng: torch.Generator) -> v2_env.State:
        state = self.env.reset(rng)
        zero = torch.zeros_like(state.done)
        return state.replace(info=dict(state.info, steps=zero, truncation=zero))

    def step(self, state: v2_env.State, action: Tensor) -> v2_env.State:
        reward = None
        for _ in range(self.action_repeat):
            state = self.env.step(state, action)
            reward = state.reward if reward is None else reward + state.reward
        steps = state.info["steps"] + self.action_repeat
        ended = steps >= self.episode_length
        done = torch.where(ended, torch.ones_like(state.done), state.done)
        truncation = torch.where(ended, 1 - state.done, torch.zeros_like(state.done))
        return state.replace(reward=reward, done=done,
                             info=dict(state.info, steps=steps, truncation=truncation))


def _where_tree(done: Tensor, a, b):
    """where(done, a, b) over every tensor of two same-shaped state trees."""
    if isinstance(a, Tensor):
        return torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _where_tree(done, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    if isinstance(a, (tuple, list)):
        return type(a)(_where_tree(done, x, y) for x, y in zip(a, b))
    return a


class AutoResetWrapper(v2_env.Wrapper):
    """Restores the post-reset pipeline state and obs where an episode ended."""

    def reset(self, rng: torch.Generator) -> v2_env.State:
        state = self.env.reset(rng)
        return state.replace(info=dict(state.info, first_pipeline_state=state.pipeline_state,
                                       first_obs=state.obs))

    def step(self, state: v2_env.State, action: Tensor) -> v2_env.State:
        if "steps" in state.info:
            steps = torch.where(state.done.bool(), torch.zeros_like(state.info["steps"]),
                                state.info["steps"])
            state = state.replace(info=dict(state.info, steps=steps))
        state = self.env.step(state.replace(done=torch.zeros_like(state.done)), action)
        done = state.done.bool()
        return state.replace(
            pipeline_state=_where_tree(done, state.info["first_pipeline_state"],
                                       state.pipeline_state),
            obs=_where_tree(done, state.info["first_obs"], state.obs))


class EvalWrapper(v2_env.Wrapper):
    """Accumulates per-episode metrics until each episode finishes; the v1
    EvalWrapper's rule (`brax_torch.envs.wrappers.eval_step`)."""

    def reset(self, rng: torch.Generator) -> v2_env.State:
        return eval_reset(self.env.reset(rng))

    def step(self, state: v2_env.State, action: Tensor) -> v2_env.State:
        return eval_step(self.env.step, state, action)
