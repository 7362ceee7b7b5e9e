"""Augmented random search (ARS v2-t, arXiv:1803.07055) on one device.

Counterpart of `brax_tpu/training/agents/ars/train.py`.  Each epoch draws
`number_of_directions` normal directions for the linear policy, runs 2 *
number_of_directions envs (each direction and its antithesis, one env a
direction) for one episode from a fresh reset, each env's policy a batched
product over the direction axis, and sums each env's reward less
`reward_shift` while its episode is active.  The observation normaliser is
updated over the active steps; the `top_directions` directions by max(r+,
r-) step the policy by step_size / (top_directions * the selected rewards'
std) (`ars_update`; a zero or undefined std, as a constant reward gives,
counts as 1).

`environment` (and `eval_env`) is an env name of `brax_torch.envs` or a
factory `(batch_size, device) -> Env`.  Physics runs through the PBD
kernel (v1) or the generalized-step kernel (v2) on CUDA tensors, one
launch a step.  `mesh` has no counterpart on one device and raises.  Each
epoch's rollout and update, and each evaluation, are
`torch.profiler.record_function` ranges ("ars/rollout", "ars/update",
"ars/eval").
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from brax_torch import envs
from brax_torch.envs import wrappers
from brax_torch.training import acting, running_statistics, types
from brax_torch.training.agents.ars import networks as ars_networks
from brax_torch.training.agents.es.train import run_episode

Tensor = torch.Tensor


def add_noise(params: Tensor, std: float, directions: int, generator: torch.Generator):
    """(params + std * noise, params - std * noise, noise), each with a
    leading axis of `directions`."""
    noise = torch.randn((directions,) + tuple(params.shape), generator=generator,
                        device=params.device)
    return params[None] + noise * std, params[None] - noise * std, noise


def ars_update(policy_params: Tensor, noise: Tensor, eval_scores: Tensor, top_directions: int,
               step_size: float) -> Tuple[Tensor, Tensor]:
    """The policy after one ARS step from the 2 * D scores (the directions'
    first, then their antitheses'), and the directions' weights (1 for the
    top_directions by max(r+, r-), else 0)."""
    eval_scores = eval_scores.reshape(-1)
    reward_plus, reward_minus = torch.split(eval_scores, eval_scores.shape[0] // 2)
    reward_max = torch.maximum(reward_plus, reward_minus)
    reward_rank = torch.argsort(torch.argsort(-reward_max, stable=True), stable=True)
    reward_weight = (reward_rank < top_directions).to(eval_scores.dtype)
    selected = eval_scores[torch.cat([reward_weight, reward_weight]).bool()]
    reward_std = (torch.std(selected, unbiased=False) if selected.numel()
                  else torch.tensor(float("nan"), device=eval_scores.device))
    # all selected rewards equal (a constant reward) gives std 0, nothing
    # selected nan: either would poison the params, so count it as 1
    reward_std = torch.where(torch.isfinite(reward_std) & (reward_std > 0), reward_std,
                             torch.ones_like(reward_std))
    w = (reward_weight * (reward_plus - reward_minus)).reshape([-1] + [1] * (noise.dim() - 1))
    direction = torch.sum(noise * w, dim=0)
    return policy_params + step_size * direction / (top_directions * reward_std), reward_weight


def train(
    environment: Union[str, envs.EnvFactory],
    num_timesteps: int = 100,
    episode_length: int = 1000,
    action_repeat: int = 1,
    number_of_directions: int = 60,
    top_directions: int = 20,
    step_size: float = 0.015,
    num_eval_envs: int = 128,
    exploration_noise_std: float = 0.025,
    seed: int = 0,
    normalize_observations: bool = False,
    num_evals: int = 1,
    reward_shift: float = 0.0,
    network_factory=ars_networks.make_policy_network,
    progress_fn: Callable[[int, types.Metrics], None] = lambda *args: None,
    eval_env: Optional[Union[str, envs.EnvFactory]] = None,
    mesh=None,
    device="cuda",
):
    """ARS training; returns (make_policy, params, metrics).

    params is (normalizer_params, W), detached copies.  Each epoch's metrics
    add the seconds of its rollout and update (host clock around
    synchronised phases).
    """
    if mesh is not None:
        raise NotImplementedError("ARS runs on one device here; a device mesh waits for the "
                                  "port's multi-device training (ROADMAP.md queue A 9)")
    device = torch.device(device)
    top_directions = min(top_directions, number_of_directions)
    num_envs = number_of_directions * 2  # noise + anti-noise
    with torch.no_grad():
        num_env_steps_between_evals = num_timesteps // num_evals
        next_eval_step = num_timesteps - (num_evals - 1) * num_env_steps_between_evals

        make_env = envs.factory(environment)
        env = wrappers.wrap_for_training_any(make_env(num_envs, device),
                                             episode_length=episode_length,
                                             action_repeat=action_repeat)
        eval_factory = make_env if eval_env is None else envs.factory(eval_env)
        eval_env = wrappers.wrap_for_training_any(eval_factory(num_eval_envs, device),
                                                  episode_length=episode_length,
                                                  action_repeat=action_repeat)
        obs_size = env.observation_size

        normalize = lambda x, y: x
        if normalize_observations:
            normalize = running_statistics.normalize
        ars_network = network_factory(obs_size, env.action_size,
                                      preprocess_observations_fn=normalize, device=device)
        make_policy = ars_networks.make_inference_fn(ars_network)

        seeds = np.random.SeedSequence(seed).generate_state(3)
        generator = lambda s: torch.Generator(device=device).manual_seed(int(s))
        gen_init, gen_eval, gen_train = map(generator, seeds)

        policy_params = ars_network.init(gen_init)
        normalizer_params = running_statistics.init_state((obs_size,), device=device)
        num_env_steps = 0

        def training_epoch(normalizer_params, policy_params):
            clock = [time.time()]

            def lap():
                acting.sync(device)
                clock.append(time.time())

            with record_function("ars/rollout"):
                plus, minus, noise = add_noise(policy_params, exploration_noise_std,
                                               number_of_directions, gen_train)
                pparams = torch.cat([plus, minus])
                policy = lambda obs: ars_network.population_apply(normalizer_params, pparams, obs)
                eval_scores, obs, obs_weights = run_episode(
                    env, policy, episode_length // action_repeat, gen_train, reward_shift)
                lap()
            with record_function("ars/update"):
                normalizer_params = running_statistics.update(
                    normalizer_params, obs.reshape(-1, obs_size),
                    weights=obs_weights.reshape(-1))
                policy_params, reward_weight = ars_update(policy_params, noise, eval_scores,
                                                          top_directions, step_size)
                steps = int(torch.sum(obs_weights)) * action_repeat
                metrics = {"params_norm": float(torch.linalg.vector_norm(policy_params)),
                           "eval_scores_mean": float(torch.mean(eval_scores)),
                           "eval_scores_std": float(torch.std(eval_scores, unbiased=False)),
                           "weights": float(torch.mean(reward_weight))}
                lap()
            seconds = np.diff(clock).tolist()
            metrics.update(rollout_s=seconds[0], update_s=seconds[1])
            return normalizer_params, policy_params, steps, metrics

        evaluator = acting.Evaluator(eval_env, make_policy, num_eval_envs=num_eval_envs,
                                     episode_length=episode_length, action_repeat=action_repeat,
                                     generator=gen_eval)

        metrics = {}
        training_walltime = 0.0
        while num_env_steps < num_timesteps:
            acting.sync(device)
            t = time.time()
            normalizer_params, policy_params, steps, epoch_metrics = training_epoch(
                normalizer_params, policy_params)
            num_env_steps += steps
            epoch_training_time = time.time() - t
            training_walltime += epoch_training_time
            training_metrics = {
                "training/sps": num_envs * episode_length / epoch_training_time,
                "training/walltime": training_walltime,
                **{f"training/{name}": value for name, value in epoch_metrics.items()},
            }
            if num_env_steps >= next_eval_step:
                with record_function("ars/eval"):
                    metrics = evaluator.run_evaluation((normalizer_params, policy_params),
                                                       training_metrics)
                progress_fn(num_env_steps, metrics)
                next_eval_step += num_env_steps_between_evals

        assert num_env_steps >= num_timesteps
        return make_policy, (normalizer_params, policy_params.clone()), metrics

