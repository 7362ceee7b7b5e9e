"""Environment wrappers: episode bookkeeping, auto-reset, eval, batch-first.

Counterpart of `brax_tpu/envs/wrappers.py`.  The port's envs are batched
already, so `VmapWrapper` is the identity; it stays so that wrapper stacks
read as they do in the JAX package.  Wrappers return new info and metrics
dicts rather than updating the ones of the state they were given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from brax_torch.envs import base
from brax_torch.sim.types import QP, Tensor


def wrap_for_training(env: base.Env, episode_length: int = 1000,
                      action_repeat: int = 1) -> base.Wrapper:
    """Episode -> Vmap -> AutoReset wrapper stack (v1 envs)."""
    env = EpisodeWrapper(env, episode_length, action_repeat)
    env = VmapWrapper(env)
    env = AutoResetWrapper(env)
    return env


def wrap_for_training_any(env, episode_length: int = 1000, action_repeat: int = 1):
    """The training stack for a v1 or a v2 env: a `brax_torch.v2.envs.Env`
    gets the v2 stack, anything else the v1 stack."""
    from brax_torch.v2 import envs as v2_envs

    if isinstance(env, v2_envs.Env):
        return v2_envs.wrappers.wrap_for_training(env, episode_length=episode_length,
                                                  action_repeat=action_repeat)
    return wrap_for_training(env, episode_length=episode_length, action_repeat=action_repeat)


class VmapWrapper(base.Wrapper):
    """The identity: the wrapped env already steps its whole batch."""

    def __init__(self, env: base.Env, batch_size: Optional[int] = None):
        super().__init__(env)
        if batch_size is not None and batch_size != env.batch_size:
            raise ValueError(f"batch_size {batch_size} != the env's {env.batch_size}")


class EpisodeWrapper(base.Wrapper):
    """Maintains the episode step count and sets done at episode end."""

    def __init__(self, env: base.Env, episode_length: int, action_repeat: int):
        super().__init__(env)
        self.episode_length = episode_length
        self.action_repeat = action_repeat

    def reset(self, rng: torch.Generator) -> base.State:
        state = self.env.reset(rng)
        zero = torch.zeros_like(state.done)
        return state.replace(info=dict(state.info, steps=zero, truncation=zero))

    def step(self, state: base.State, action: Tensor) -> base.State:
        reward = None
        for _ in range(self.action_repeat):
            state = self.env.step(state, action)
            reward = state.reward if reward is None else reward + state.reward
        steps = state.info["steps"] + self.action_repeat
        ended = steps >= self.episode_length
        done = torch.where(ended, torch.ones_like(state.done), state.done)
        truncation = torch.where(ended, 1 - state.done, torch.zeros_like(state.done))
        info = dict(state.info, steps=steps, truncation=truncation)
        return state.replace(reward=reward, done=done, info=info)


class AutoResetWrapper(base.Wrapper):
    """Resets envs that are done back to their initial state."""

    def reset(self, rng: torch.Generator) -> base.State:
        state = self.env.reset(rng)
        return state.replace(info=dict(state.info, first_qp=state.qp, first_obs=state.obs))

    def step(self, state: base.State, action: Tensor) -> base.State:
        if "steps" in state.info:
            steps = torch.where(state.done.bool(), torch.zeros_like(state.info["steps"]),
                                state.info["steps"])
            state = state.replace(info=dict(state.info, steps=steps))
        state = state.replace(done=torch.zeros_like(state.done))
        state = self.env.step(state, action)

        done = state.done.bool()

        def where_done(x, y):
            return torch.where(done.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

        first_qp = state.info["first_qp"]
        qp = QP(
            pos=where_done(first_qp.pos, state.qp.pos),
            rot=where_done(first_qp.rot, state.qp.rot),
            vel=where_done(first_qp.vel, state.qp.vel),
            ang=where_done(first_qp.ang, state.qp.ang),
        )
        obs = where_done(state.info["first_obs"], state.obs)
        return state.replace(qp=qp, obs=obs)


@dataclass
class EvalMetrics:
    """Aggregated per-episode evaluation metrics."""

    episode_metrics: Dict[str, Tensor]
    active_episodes: Tensor
    episode_steps: Tensor


def eval_reset(state):
    """An env's reset state with eval metrics added: the reward among the
    metrics, zero episode sums, every episode active.  Shared by the v1 and
    v2 EvalWrappers, which the JAX package writes alike."""
    metrics = dict(state.metrics, reward=state.reward)
    eval_metrics = EvalMetrics(
        episode_metrics={k: torch.zeros_like(v) for k, v in metrics.items()},
        active_episodes=torch.ones_like(state.done),
        episode_steps=torch.zeros_like(state.done),
    )
    return state.replace(metrics=metrics, info=dict(state.info, eval_metrics=eval_metrics))


def eval_step(step, state, action):
    """`step(state, action)` with the eval metrics carried: the step's
    metrics are added to the sums of the episodes still active before it,
    and an episode stops being active at its first done (so an auto-reset
    env's later episodes add nothing)."""
    state_metrics = state.info["eval_metrics"]
    if not isinstance(state_metrics, EvalMetrics):
        raise ValueError(f"Incorrect type for state_metrics: {type(state_metrics)}")
    info = {k: v for k, v in state.info.items() if k != "eval_metrics"}
    nstate = step(state.replace(info=info), action)
    metrics = dict(nstate.metrics, reward=nstate.reward)
    active = state_metrics.active_episodes
    episode_steps = torch.where(active.bool(), nstate.info["steps"], state_metrics.episode_steps)

    def accumulate(a, b):
        return a + b * active.reshape(active.shape + (1,) * (b.dim() - active.dim()))

    episode_metrics = {k: accumulate(state_metrics.episode_metrics[k], metrics[k])
                       for k in state_metrics.episode_metrics}
    eval_metrics = EvalMetrics(
        episode_metrics=episode_metrics,
        active_episodes=active * (1 - nstate.done),
        episode_steps=episode_steps,
    )
    return nstate.replace(metrics=metrics, info=dict(nstate.info, eval_metrics=eval_metrics))


class EvalWrapper(base.Wrapper):
    """Tracks episode-aggregated metrics for evaluation runs."""

    def reset(self, rng: torch.Generator) -> base.State:
        return eval_reset(self.env.reset(rng))

    def step(self, state: base.State, action: Tensor) -> base.State:
        return eval_step(self.env.step, state, action)
