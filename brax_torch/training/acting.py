"""Rollout generation and evaluation.

Counterpart of `brax_tpu/training/acting.py`.  `generate_unroll` is a Python
loop over time; its Transition stacks the steps along a leading time dim,
[T, B, ...], as `lax.scan` does.  Rollouts run without autograd.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence, Tuple

import torch

from brax_torch.envs import base, wrappers
from brax_torch.training.types import Metrics, Policy, PolicyParams, Transition, tree_stack


def actor_step(
    env: base.Env,
    env_state: base.State,
    policy: Policy,
    generator: torch.Generator,
    extra_fields: Sequence[str] = (),
) -> Tuple[base.State, Transition]:
    """One policy step + env step, emitting a Transition."""
    actions, policy_extras = policy(env_state.obs, generator)
    nstate = env.step(env_state, actions)
    state_extras = {x: nstate.info[x] for x in extra_fields}
    return nstate, Transition(
        observation=env_state.obs,
        action=actions,
        reward=nstate.reward,
        discount=1 - nstate.done,
        next_observation=nstate.obs,
        extras={"policy_extras": policy_extras, "state_extras": state_extras},
    )


@torch.no_grad()
def generate_unroll(
    env: base.Env,
    env_state: base.State,
    policy: Policy,
    generator: torch.Generator,
    unroll_length: int,
    extra_fields: Sequence[str] = (),
) -> Tuple[base.State, Transition]:
    """Collects a trajectory of unroll_length steps, stacked time-first."""
    transitions = []
    state = env_state
    for _ in range(unroll_length):
        state, transition = actor_step(env, state, policy, generator, extra_fields)
        transitions.append(transition)
    return state, tree_stack(transitions)


class Evaluator:
    """Runs policy evaluation episodes and aggregates metrics."""

    def __init__(self, eval_env: base.Env,
                 eval_policy_fn: Callable[[PolicyParams], Policy],
                 num_eval_envs: int, episode_length: int, action_repeat: int,
                 generator: torch.Generator):
        if eval_env.batch_size != num_eval_envs:
            raise ValueError(f"eval env batch {eval_env.batch_size} != num_eval_envs "
                             f"{num_eval_envs}")
        self._generator = generator
        self._eval_walltime = 0.0
        self._eval_env = wrappers.EvalWrapper(eval_env)
        self._eval_policy_fn = eval_policy_fn
        self._unroll_length = episode_length // action_repeat
        self._steps_per_unroll = episode_length * num_eval_envs

    @torch.no_grad()
    def _unroll(self, policy_params: PolicyParams) -> base.State:
        state = self._eval_env.reset(self._generator)
        policy = self._eval_policy_fn(policy_params)
        for _ in range(self._unroll_length):
            actions, _ = policy(state.obs, self._generator)
            state = self._eval_env.step(state, actions)
        return state

    def run_evaluation(self, policy_params: PolicyParams, training_metrics: Metrics,
                       aggregate_episodes: bool = True) -> Metrics:
        """Runs one evaluation epoch and returns eval/ metrics."""
        t = time.time()
        eval_state = self._unroll(policy_params)
        eval_metrics = eval_state.info["eval_metrics"]
        to_host = lambda v: v.detach().cpu().numpy()
        # reading the metrics to the host waits for the device
        metrics = {
            f"eval/episode_{name}": float(to_host(value).mean()) if aggregate_episodes
            else to_host(value)
            for name, value in eval_metrics.episode_metrics.items()
        }
        metrics["eval/avg_episode_length"] = float(to_host(eval_metrics.episode_steps).mean())
        epoch_eval_time = time.time() - t
        metrics["eval/epoch_eval_time"] = epoch_eval_time
        metrics["eval/sps"] = self._steps_per_unroll / epoch_eval_time
        self._eval_walltime = self._eval_walltime + epoch_eval_time
        return {"eval/walltime": self._eval_walltime, **training_metrics, **metrics}
