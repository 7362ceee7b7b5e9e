"""Analytic policy gradients through the differentiable physics step.

Counterpart of `brax_tpu/training/agents/apg/train.py`, single device: each
epoch is a rollout of `episode_length // action_repeat` steps recorded by
autograd from a fresh reset, then `backward()` of -mean(reward) through the
policy and the physics, then a clipped Adam step.  The physics steps run
through `brax_torch.sim.kernels.PBDStep` (v1) or
`brax_torch.v2.generalized.kernels.GenStep` (v2): the kernel forward on
CUDA tensors, the twin's or the pipeline's backward, as the JAX trainer's
gradients flow through the kernels' custom VJPs.  Every
`truncation_length` steps the whole env State is detached, as JAX's
`stop_gradient` cuts it, the reward of that step included.

`environment` (and `eval_env`) is an env name of `brax_torch.envs` or a
factory `(batch_size, device) -> Env` of the unwrapped env, v1 or v2, as
for the port's PPO.  `use_fused_kernel=None` turns the fused MLP kernels on
when `device` is CUDA, and the previous setting is restored on return.
Physics runs through its kernels on CUDA tensors whatever this flag says.

Each epoch's rollout, backward and update, and each evaluation, are
`torch.profiler.record_function` ranges ("apg/rollout", "apg/backward",
"apg/update", "apg/eval"); the epoch's metrics add the seconds of the
first three (host clock around synchronised phases) and the gradient's
norm before the clip (`training/unclipped_grad_norm`: inf where its
squares overflow float32, and the clip then zeroes it, as optax's does).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from brax_torch import envs
from brax_torch.envs import wrappers
from brax_torch.training import acting, fused_mlp, gradients, running_statistics, types
from brax_torch.training.agents.apg import networks as apg_networks

Tensor = torch.Tensor


def stop_gradient(tree):
    """Every tensor of an env State (dataclasses, dicts, lists, tuples)
    detached."""
    if isinstance(tree, Tensor):
        return tree.detach()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: stop_gradient(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: stop_gradient(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(stop_gradient(x) for x in tree)
    return tree


def global_norm(tensors) -> Tensor:
    """optax.global_norm: the norm of every entry of every tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def clip_by_global_norm(grads: Dict[str, Tensor], max_gradient_norm: float) -> Dict[str, Tensor]:
    """The JAX trainer's clip: each gradient kept where the global norm is
    below `max_gradient_norm`, else (g / norm) * max_gradient_norm."""
    g_norm = global_norm(grads.values())
    keep = g_norm < max_gradient_norm
    return {k: torch.where(keep, g, (g / g_norm) * max_gradient_norm) for k, g in grads.items()}


def rollout_loss(env: envs.Env, env_state, policy: types.Policy,
                 generator: torch.Generator, steps: int,
                 truncation_length: Optional[int] = None):
    """-mean(reward) over `steps` steps of `policy` from `env_state`,
    recorded by autograd, and the observations each step started from
    (detached, [steps, N, obs]).  Every `truncation_length` steps the env
    State is detached, that step's reward with it, as the JAX trainer's
    `stop_gradient` cuts its scan."""
    rewards, observations = [], []
    for step in range(steps):
        actions = policy(env_state.obs, generator)[0]
        nstate = env.step(env_state, actions)
        if truncation_length is not None and (step + 1) % truncation_length == 0:
            nstate = stop_gradient(nstate)
        rewards.append(nstate.reward)
        observations.append(env_state.obs.detach())
        env_state = nstate
    return -torch.mean(torch.stack(rewards)), torch.stack(observations)


def train(
    environment: Union[str, envs.EnvFactory],
    episode_length: int,
    action_repeat: int = 1,
    num_envs: int = 1,
    num_eval_envs: int = 128,
    learning_rate: float = 1e-4,
    seed: int = 0,
    truncation_length: Optional[int] = None,
    max_gradient_norm: float = 1e9,
    num_evals: int = 1,
    normalize_observations: bool = False,
    deterministic_eval: bool = False,
    network_factory=apg_networks.make_apg_networks,
    progress_fn: Callable[[int, types.Metrics], None] = lambda *args: None,
    eval_env: Optional[Union[str, envs.EnvFactory]] = None,
    use_fused_kernel: Optional[bool] = None,
    device="cuda",
):
    """Direct trajectory optimisation; returns (make_policy, params, metrics).

    params is (normalizer_params, policy_params), detached copies.
    """
    if truncation_length is not None:
        assert truncation_length > 0
    device = torch.device(device)
    if use_fused_kernel is None:
        use_fused_kernel = device.type == "cuda"
    with fused_mlp.enabled_as(bool(use_fused_kernel)):
        num_evals_after_init = max(num_evals - 1, 1)
        make_env = envs.factory(environment)
        env = wrappers.wrap_for_training_any(make_env(num_envs, device),
                                             episode_length=episode_length,
                                             action_repeat=action_repeat)
        eval_factory = make_env if eval_env is None else envs.factory(eval_env)
        eval_env = wrappers.wrap_for_training_any(eval_factory(num_eval_envs, device),
                                                  episode_length=episode_length,
                                                  action_repeat=action_repeat)

        normalize = lambda x, y: x
        if normalize_observations:
            normalize = running_statistics.normalize
        apg_network = network_factory(env.observation_size, env.action_size,
                                      preprocess_observations_fn=normalize, device=device)
        make_policy = apg_networks.make_inference_fn(apg_network)

        seeds = np.random.SeedSequence(seed).generate_state(4)
        generator = lambda s: torch.Generator(device=device).manual_seed(int(s))
        gen_policy, gen_env, gen_eval, gen_train = map(generator, seeds)

        policy_params = apg_network.policy_network.init(gen_policy)
        optimizer = gradients.adam(list(policy_params.values()), learning_rate)
        normalizer_params = running_statistics.init_state((env.observation_size,), device=device)

        def training_epoch(normalizer_params):
            clock = [time.time()]

            def lap():
                acting.sync(device)
                clock.append(time.time())

            with record_function("apg/rollout"):
                loss, observations = rollout_loss(
                    env, env.reset(gen_env), make_policy((normalizer_params, policy_params)),
                    gen_train, episode_length // action_repeat, truncation_length)
                lap()
            with record_function("apg/backward"):
                optimizer.zero_grad(set_to_none=True)
                # fast's reward is not differentiable in its actions: its
                # gradient is zero, as jax.grad gives it
                if loss.requires_grad:
                    loss.backward()
                lap()
            with record_function("apg/update"), torch.no_grad():
                raw = {k: torch.zeros_like(p) if p.grad is None else p.grad
                       for k, p in policy_params.items()}
                grads = clip_by_global_norm(raw, max_gradient_norm)
                for k, p in policy_params.items():
                    p.grad = grads[k]
                optimizer.step()
                normalizer_params = running_statistics.update(normalizer_params, observations)
                metrics = {"grad_norm": global_norm(grads.values()),
                           "unclipped_grad_norm": global_norm(raw.values()),
                           "params_norm": global_norm(policy_params.values())}
                lap()
            seconds = np.diff(clock).tolist()
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics.update(rollout_s=seconds[0], backward_s=seconds[1], update_s=seconds[2])
            return normalizer_params, metrics

        evaluator = acting.Evaluator(
            eval_env, functools.partial(make_policy, deterministic=deterministic_eval),
            num_eval_envs=num_eval_envs, episode_length=episode_length,
            action_repeat=action_repeat, generator=gen_eval)

        def params():
            return (normalizer_params,
                    {k: v.detach().clone() for k, v in policy_params.items()})

        metrics = {}
        if num_evals > 1:
            with record_function("apg/eval"):
                metrics = evaluator.run_evaluation(params(), training_metrics={})
            progress_fn(0, metrics)

        training_walltime = 0.0
        for it in range(num_evals_after_init):
            acting.sync(device)
            t = time.time()
            normalizer_params, epoch_metrics = training_epoch(normalizer_params)
            epoch_training_time = time.time() - t
            training_walltime += epoch_training_time
            training_metrics = {
                "training/sps": episode_length * num_envs / epoch_training_time,
                "training/walltime": training_walltime,
                **{f"training/{name}": value for name, value in epoch_metrics.items()},
            }
            with record_function("apg/eval"):
                metrics = evaluator.run_evaluation(params(), training_metrics)
            progress_fn(it + 1, metrics)

        return make_policy, params(), metrics
