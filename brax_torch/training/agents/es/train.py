"""Evolution strategies (OpenAI-ES, arXiv:1703.03864) on one device.

Counterpart of `brax_tpu/training/agents/es/train.py`.  Each epoch draws
one normal noise tensor per parameter for `population_size` members, runs
2 * population_size envs (the noise and its antithesis, one env a member)
for one episode from a fresh reset, each member's policy a batched product
over the member axis (`es_networks.population_apply`), and accumulates
each env's reward while its episode is active.  The observation normaliser
is updated over the steps each env was active; the shaped fitness of the
antithetic pairs weights the noise into an update direction (`es_update`,
with `l2coeff`), which Adam applies.

`environment` (and `eval_env`) is an env name of `brax_torch.envs` or a
factory `(batch_size, device) -> Env`, as for the port's PPO.  Physics
runs through the PBD kernel (v1) or the generalized-step kernel (v2) on
CUDA tensors, one launch a step; the policy's products are PyTorch's.
`mesh` has no counterpart on one device and raises.

Each epoch's rollout and update, and each evaluation, are
`torch.profiler.record_function` ranges ("es/rollout", "es/update",
"es/eval").
"""

from __future__ import annotations

import enum
import functools
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from brax_torch import envs
from brax_torch.envs import wrappers
from brax_torch.training import acting, fused_mlp, gradients, running_statistics, types
from brax_torch.training.agents.apg.train import global_norm
from brax_torch.training.agents.es import networks as es_networks

Tensor = torch.Tensor


def _ranks(x: Tensor) -> Tensor:
    """jnp.argsort(jnp.argsort(x)): each entry's rank, ties in order."""
    return torch.argsort(torch.argsort(x, stable=True), stable=True)


def centered_rank(x: Tensor) -> Tensor:
    x = _ranks(x).to(torch.float32)
    x = x / (len(x) - 1)
    return x - 0.5


def wierstra(x: Tensor) -> Tensor:
    n = len(x)
    x = (n - _ranks(x)).to(torch.float32)
    x = torch.clamp(torch.log(torch.tensor(n / 2.0 + 1, device=x.device)) - torch.log(x), min=0)
    return x / torch.sum(x) - 1.0 / n


class FitnessShaping(enum.Enum):
    ORIGINAL = functools.partial(lambda x: x)
    CENTERED_RANK = functools.partial(centered_rank)
    WIERSTRA = functools.partial(wierstra)


def add_noise(params: Dict[str, Tensor], std: float, members: int,
              generator: torch.Generator):
    """(params + std * noise, params - std * noise, noise), each parameter
    with a leading axis of `members`; one standard normal draw per
    parameter, in the order of `params`."""
    noise = {k: torch.randn((members,) + tuple(v.shape), generator=generator, device=v.device)
             for k, v in params.items()}
    plus = {k: v[None] + noise[k] * std for k, v in params.items()}
    minus = {k: v[None] - noise[k] * std for k, v in params.items()}
    return plus, minus, noise


def run_episode(env, rollout_policy, steps: int, generator: torch.Generator,
                reward_shift: float = 0.0):
    """One episode of `rollout_policy(obs) -> actions` from a fresh reset:
    (each env's summed reward less `reward_shift` while active (N,), the
    observations each step started from (T, N, obs), and whether each env
    was active there (T, N))."""
    state = env.reset(generator)
    cumulative_reward = state.reward
    active_episode = torch.ones_like(cumulative_reward)
    observations, weights = [], []
    for _ in range(steps):
        nstate = env.step(state, rollout_policy(state.obs))
        cumulative_reward = cumulative_reward + (nstate.reward - reward_shift) * active_episode
        observations.append(state.obs)
        weights.append(active_episode)
        active_episode = active_episode * (1 - nstate.done)
        state = nstate
    return cumulative_reward, torch.stack(observations), torch.stack(weights)


def es_update(policy_params: Dict[str, Tensor], noise: Dict[str, Tensor], eval_scores: Tensor,
              optimizer: torch.optim.Optimizer, fitness_shaping: FitnessShaping,
              center_fitness: bool, l2coeff: float) -> Tensor:
    """One ES step of `optimizer` (Adam, holding `policy_params`) from the
    2 * P scores of the antithetic population (the noise's members first);
    returns the P pair weights."""
    population_size = eval_scores.shape[0] // 2
    weights = fitness_shaping.value(eval_scores.reshape(-1))
    if center_fitness:
        weights = (weights - torch.mean(weights)) / (1e-6 + torch.std(weights, unbiased=False))
    weights1, weights2 = torch.split(weights, population_size)
    weights = weights1 - weights2
    for k, p in policy_params.items():
        n = noise[k]
        w = weights.reshape([population_size] + [1] * (n.dim() - 1))
        delta = torch.sum(n * w, dim=0) / population_size
        delta = delta - l2coeff * p
        p.grad = -delta
    optimizer.step()
    for p in policy_params.values():
        p.grad = None
    return weights


def train(
    environment: Union[str, envs.EnvFactory],
    num_timesteps: int = 100,
    episode_length: int = 1000,
    action_repeat: int = 1,
    l2coeff: float = 0,
    population_size: int = 128,
    learning_rate: float = 1e-3,
    fitness_shaping: FitnessShaping = FitnessShaping.ORIGINAL,
    num_eval_envs: int = 128,
    perturbation_std: float = 0.1,
    seed: int = 0,
    normalize_observations: bool = False,
    num_evals: int = 1,
    center_fitness: bool = False,
    deterministic_eval: bool = False,
    network_factory=es_networks.make_es_networks,
    progress_fn: Callable[[int, types.Metrics], None] = lambda *args: None,
    eval_env: Optional[Union[str, envs.EnvFactory]] = None,
    mesh=None,
    device="cuda",
):
    """ES training; returns (make_policy, params, metrics).

    params is (normalizer_params, policy_params), detached copies.  Each
    epoch's metrics add the seconds of its rollout and update (host clock
    around synchronised phases).
    """
    if mesh is not None:
        raise NotImplementedError("ES runs on one device here; a device mesh waits for the "
                                  "port's multi-device training (ROADMAP.md queue A 9)")
    device = torch.device(device)
    num_envs = population_size * 2  # noise + anti-noise
    # the policies are plain products: the fused MLP kernels stay off
    with fused_mlp.enabled_as(False), torch.no_grad():
        num_evals_after_init = max(num_evals - 1, 1)
        num_env_steps_between_evals = num_timesteps // num_evals_after_init
        next_eval_step = num_timesteps - (num_evals_after_init - 1) * num_env_steps_between_evals

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
        es_network = network_factory(obs_size, env.action_size,
                                     preprocess_observations_fn=normalize, device=device)
        make_policy = es_networks.make_inference_fn(es_network)
        dist = es_network.parametric_action_distribution

        seeds = np.random.SeedSequence(seed).generate_state(3)
        generator = lambda s: torch.Generator(device=device).manual_seed(int(s))
        gen_init, gen_eval, gen_train = map(generator, seeds)

        policy_params = es_network.policy_network.init(gen_init)
        optimizer = gradients.adam(list(policy_params.values()), learning_rate)
        normalizer_params = running_statistics.init_state((obs_size,), device=device)
        num_env_steps = 0

        def training_epoch(normalizer_params):
            clock = [time.time()]

            def lap():
                acting.sync(device)
                clock.append(time.time())

            with record_function("es/rollout"):
                plus, minus, noise = add_noise(policy_params, perturbation_std, population_size,
                                               gen_train)
                pparams = {k: torch.cat([plus[k], minus[k]]) for k in plus}

                def rollout_policy(obs):
                    logits = es_networks.population_apply(es_network.policy_network,
                                                          normalizer_params, pparams, obs)
                    return dist.sample(logits, gen_train)

                eval_scores, obs, obs_weights = run_episode(
                    env, rollout_policy, episode_length // action_repeat, gen_train)
                lap()
            with record_function("es/update"):
                normalizer_params = running_statistics.update(
                    normalizer_params, obs.reshape(-1, obs_size),
                    weights=obs_weights.reshape(-1))
                weights = es_update(policy_params, noise, eval_scores, optimizer, fitness_shaping,
                                    center_fitness, l2coeff)
                steps = int(torch.sum(obs_weights)) * action_repeat
                metrics = {"params_norm": float(global_norm(policy_params.values())),
                           "eval_scores_mean": float(torch.mean(eval_scores)),
                           "eval_scores_std": float(torch.std(eval_scores, unbiased=False)),
                           "weights": float(torch.mean(weights))}
                lap()
            seconds = np.diff(clock).tolist()
            metrics.update(rollout_s=seconds[0], update_s=seconds[1])
            return normalizer_params, steps, metrics

        evaluator = acting.Evaluator(
            eval_env, functools.partial(make_policy, deterministic=deterministic_eval),
            num_eval_envs=num_eval_envs, episode_length=episode_length,
            action_repeat=action_repeat, generator=gen_eval)

        def params():
            return (normalizer_params,
                    {k: v.detach().clone() for k, v in policy_params.items()})

        metrics = {}
        if num_evals > 1:
            with record_function("es/eval"):
                metrics = evaluator.run_evaluation(params(), training_metrics={})
            progress_fn(0, metrics)

        training_walltime = 0.0
        while num_env_steps < num_timesteps:
            acting.sync(device)
            t = time.time()
            normalizer_params, steps, epoch_metrics = training_epoch(normalizer_params)
            num_env_steps += steps
            epoch_training_time = time.time() - t
            training_walltime += epoch_training_time
            training_metrics = {
                "training/sps": num_envs * episode_length / epoch_training_time,
                "training/walltime": training_walltime,
                **{f"training/{name}": value for name, value in epoch_metrics.items()},
            }
            if num_env_steps >= next_eval_step:
                with record_function("es/eval"):
                    metrics = evaluator.run_evaluation(params(), training_metrics)
                progress_fn(num_env_steps, metrics)
                next_eval_step += num_env_steps_between_evals

        assert num_env_steps >= num_timesteps
        return make_policy, params(), metrics
