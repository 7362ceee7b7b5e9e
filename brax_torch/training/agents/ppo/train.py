"""Proximal policy optimization on one device.

Counterpart of `brax_tpu/training/agents/ppo/train.py`, single device: the
rollout, the normaliser update and the SGD epochs are Python loops over
eager torch calls, with the same data layout as the JAX trainer.

The port's envs are built for a fixed batch, so `environment` (and
`eval_env`) is an env name of `brax_torch.envs` or a factory
`(batch_size, device) -> Env` of the unwrapped env: `train` builds the
training env at `num_envs` and the eval env at `num_eval_envs`.  A factory
may return a v1 env or a bare v2 env (`brax_torch.v2.envs`), as the JAX
trainer takes either: `envs.wrappers.wrap_for_training_any` picks the
wrapper stack and `acting.Evaluator` the EvalWrapper.

`use_fused_kernel=None` turns the fused MLP kernels on when `device` is
CUDA, and the previous setting is restored on return.  Physics runs through
the CUDA PBD kernel (v1) or generalized-step kernel (v2) on CUDA tensors
whatever this flag says.

Auxiliary-learner hooks (braxlines' discriminators ride them, as in the
JAX trainer): `extra_params` (a dict of tensors) are trained once per
training step, on the whole batch before the SGD epochs, by one Adam step
(`extra_learning_rate`) on `extra_loss_fn(extra_params, transitions,
generator)`; then `reward_relabel_fn(extra_params, transitions)` replaces
the batch's rewards.  With no hook given the trainer draws and computes
what it did without them.

Full-state checkpoints (`training/checkpoint.py`), as the JAX trainer's:
with `checkpoint_dir`, after each evaluation but the step-0 one the policy
and value params, the Adam state, the normaliser, the env-step counter and
the training and eval generators' states go to
`<checkpoint_dir>/step_<env steps:012d>`; a run resumes from
`restore_checkpoint_path`, or else from the newest `step_*` in
`checkpoint_dir` (the auxiliary learner's params and Adam state too).  A
resumed run resets its envs and trains `num_timesteps` more, its step
counter going on from the checkpoint's.

Each training step (ending in a device synchronise), its rollout and its
SGD epochs, and each evaluation are `torch.profiler.record_function` ranges
("ppo/training_step", "ppo/rollout", "ppo/sgd", "ppo/eval"), which cost
nothing unless a profiler is recording.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from brax_torch import envs
from brax_torch.envs import wrappers
from brax_torch.training import (acting, checkpoint, fused_mlp, gradients, running_statistics,
                                 types)
from brax_torch.training.agents.ppo import losses as ppo_losses
from brax_torch.training.agents.ppo import networks as ppo_networks


def train(
    environment: Union[str, envs.EnvFactory],
    num_timesteps: int,
    episode_length: int,
    action_repeat: int = 1,
    num_envs: int = 1,
    num_eval_envs: int = 128,
    learning_rate: float = 1e-4,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    seed: int = 0,
    unroll_length: int = 10,
    batch_size: int = 32,
    num_minibatches: int = 16,
    num_updates_per_batch: int = 2,
    num_evals: int = 1,
    normalize_observations: bool = False,
    reward_scaling: float = 1.0,
    clipping_epsilon: float = 0.3,
    gae_lambda: float = 0.95,
    deterministic_eval: bool = False,
    network_factory=ppo_networks.make_ppo_networks,
    progress_fn: Callable[[int, types.Metrics], None] = lambda *args: None,
    normalize_advantage: bool = True,
    eval_env: Optional[Union[str, envs.EnvFactory]] = None,
    use_fused_kernel: Optional[bool] = None,
    device="cuda",
    extra_params: Optional[types.Params] = None,
    extra_loss_fn: Optional[Callable] = None,
    extra_learning_rate: float = 3e-4,
    reward_relabel_fn: Optional[Callable] = None,
    checkpoint_dir: Optional[str] = None,
    restore_checkpoint_path: Optional[str] = None,
):
    """PPO training; returns (make_policy, params, metrics).

    params is (normalizer_params, policy_params), detached copies, and with
    `extra_loss_fn` also the trained `extra_params`.  Besides
    the JAX trainer's metrics, `training/sps_after_first` gives env steps/s
    over the last epoch's training steps after its first (host clock around
    synchronised steps), when the epoch has more than one.
    """
    assert batch_size * num_minibatches % num_envs == 0
    device = torch.device(device)
    if use_fused_kernel is None:
        use_fused_kernel = device.type == "cuda"
    with fused_mlp.enabled_as(bool(use_fused_kernel)):
        env_step_per_training_step = batch_size * unroll_length * num_minibatches * action_repeat
        num_evals_after_init = max(num_evals - 1, 1)
        num_training_steps_per_epoch = -(
            -num_timesteps // (num_evals_after_init * env_step_per_training_step))
        num_unrolls = batch_size * num_minibatches // num_envs

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
        ppo_network = network_factory(env.observation_size, env.action_size,
                                      preprocess_observations_fn=normalize, device=device)
        make_policy = ppo_networks.make_inference_fn(ppo_network)

        seeds = np.random.SeedSequence(seed).generate_state(5)
        generator = lambda s: torch.Generator(device=device).manual_seed(int(s))
        gen_policy, gen_value, gen_env, gen_eval, gen_train = map(generator, seeds)

        params = ppo_losses.PPONetworkParams(
            policy=ppo_network.policy_network.init(gen_policy),
            value=ppo_network.value_network.init(gen_value),
        )
        optimizer = gradients.adam(list(params.policy.values()) + list(params.value.values()),
                                   learning_rate)
        loss_fn = functools.partial(
            ppo_losses.compute_ppo_loss,
            ppo_network=ppo_network,
            entropy_cost=entropy_cost,
            discounting=discounting,
            reward_scaling=reward_scaling,
            gae_lambda=gae_lambda,
            clipping_epsilon=clipping_epsilon,
            normalize_advantage=normalize_advantage,
        )
        update_fn = gradients.gradient_update_fn(loss_fn, optimizer, has_aux=True)
        normalizer_params = running_statistics.init_state((env.observation_size,), device=device)
        extra_update_fn = None
        ckpt_params = {"policy": params.policy, "value": params.value}
        ckpt_optimizers = {"ppo": optimizer}
        if extra_loss_fn is not None:
            extra_params = types.tree_map(
                lambda x: x.detach().clone().to(device).requires_grad_(True), extra_params)
            leaves = []
            types.tree_map(leaves.append, extra_params)
            extra_optimizer = gradients.adam(leaves, extra_learning_rate)
            extra_update_fn = gradients.gradient_update_fn(extra_loss_fn, extra_optimizer)
            ckpt_params["extra"] = {str(i): leaf for i, leaf in enumerate(leaves)}
            ckpt_optimizers["extra"] = extra_optimizer
        ckpt_generators = {"train": gen_train, "eval": gen_eval}
        current_step = 0
        restore_from = checkpoint.restore_path(checkpoint_dir, restore_checkpoint_path)
        if restore_from:
            normalizer_params, current_step = checkpoint.restore(
                checkpoint.load(restore_from), ckpt_params, ckpt_optimizers, ckpt_generators,
                device)

        def training_step(env_state, normalizer_params, loss_metrics):
            policy = make_policy((normalizer_params, params.policy))
            unrolls = []
            with record_function("ppo/rollout"):
                for _ in range(num_unrolls):
                    env_state, data = acting.generate_unroll(
                        env, env_state, policy, gen_train, unroll_length,
                        extra_fields=("truncation",))
                    unrolls.append(data)
            # [unrolls, T, num_envs, ...] -> [unrolls * num_envs, T, ...]
            data = types.tree_map(
                lambda x: torch.swapaxes(x, 1, 2).reshape((-1,) + (x.shape[1],) + x.shape[3:]),
                types.tree_stack(unrolls))
            normalizer_params = running_statistics.update(normalizer_params, data.observation)
            if extra_update_fn is not None:
                extra_update_fn(extra_params, data, gen_train)
            if reward_relabel_fn is not None:
                with torch.no_grad():
                    data = data._replace(reward=reward_relabel_fn(extra_params, data))
            with record_function("ppo/sgd"):
                _sgd(data, normalizer_params, loss_metrics)
            return env_state, normalizer_params

        def _sgd(data, normalizer_params, loss_metrics):
            for _ in range(num_updates_per_batch):
                perm = torch.randperm(data.observation.shape[0], generator=gen_train, device=device)
                shuffled = types.tree_map(
                    lambda x: x[perm].reshape((num_minibatches, -1) + x.shape[1:]), data)
                for m in range(num_minibatches):
                    minibatch = types.tree_map(lambda x: x[m], shuffled)
                    _, metrics = update_fn(params, normalizer_params, minibatch, gen_train)
                    loss_metrics.append({k: v.detach() for k, v in metrics.items()})

        env_state = env.reset(gen_env)
        evaluator = acting.Evaluator(
            eval_env, functools.partial(make_policy, deterministic=deterministic_eval),
            num_eval_envs=num_eval_envs, episode_length=episode_length,
            action_repeat=action_repeat, generator=gen_eval)

        def policy_params():
            return (normalizer_params, {k: v.detach().clone() for k, v in params.policy.items()})

        metrics = {}
        if num_evals > 1:
            metrics = evaluator.run_evaluation(policy_params(), training_metrics={})
            progress_fn(0, metrics)

        training_walltime = 0.0
        for _ in range(num_evals_after_init):
            acting.sync(device)
            t = time.time()
            step_ends = []
            loss_metrics = []
            for _ in range(num_training_steps_per_epoch):
                with record_function("ppo/training_step"):
                    env_state, normalizer_params = training_step(env_state, normalizer_params,
                                                                 loss_metrics)
                    acting.sync(device)
                step_ends.append(time.time())
            means = {k: float(torch.stack([m[k] for m in loss_metrics]).mean())
                     for k in loss_metrics[0]}
            epoch_training_time = time.time() - t
            training_walltime += epoch_training_time
            current_step += num_training_steps_per_epoch * env_step_per_training_step
            training_metrics = {
                "training/sps": num_training_steps_per_epoch * env_step_per_training_step
                / epoch_training_time,
                "training/walltime": training_walltime,
                **{f"training/{name}": value for name, value in means.items()},
            }
            if len(step_ends) > 1:
                training_metrics["training/sps_after_first"] = (
                    (len(step_ends) - 1) * env_step_per_training_step
                    / (step_ends[-1] - step_ends[0]))
            with record_function("ppo/eval"):
                metrics = evaluator.run_evaluation(policy_params(), training_metrics)
            progress_fn(current_step, metrics)
            if checkpoint_dir:
                checkpoint.save(checkpoint_dir, checkpoint.state(
                    current_step, ckpt_params, ckpt_optimizers, normalizer_params,
                    ckpt_generators))

        assert current_step >= num_timesteps
        params_out = policy_params()
        if extra_loss_fn is not None:
            params_out += (types.tree_map(lambda x: x.detach().clone(), extra_params),)
        return make_policy, params_out, metrics
