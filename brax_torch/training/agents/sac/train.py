"""Soft actor-critic on one device.

Counterpart of `brax_tpu/training/agents/sac/train.py`, single device: the
JAX trainer's order of work as Python loops over eager torch calls.  The
replay buffer is prefilled with the initial policy (`min_replay_size`
rows, a whole actor step at a time); then each training step is one
`actor_step` of every env (with the `truncation` extra), a normaliser
update, an insert, a sample of `batch_size * grad_updates_per_step` rows
reshaped to [grad_updates_per_step, batch_size], and that many SGD steps.

An SGD step (`sgd_step`) keeps the JAX step's data flow although the
optimizers update in place: the three losses' gradients are taken first,
each of its first argument alone (`gradients.loss_and_grads`), from the
parameters as the step found them, then the three Adam steps, then the
target critics' Polyak update.

`environment` (and `eval_env`) is an env name of `brax_torch.envs` or a
factory `(batch_size, device) -> Env` of the unwrapped env, v1 or v2, as
for the port's PPO; `envs.wrappers.wrap_for_training_any` wraps either.
`use_fused_kernel=None` turns the fused MLP kernels on when `device` is
CUDA (the critics' first layer takes obs and action together: humanoid's
257 inputs), and the previous setting is restored on return.  Physics runs
through its kernels on CUDA tensors whatever this flag says.  `mesh` and
`aot_cache` have no counterpart.

Checkpoints, as the JAX trainer's: `checkpoint_logdir` saves (normaliser,
policy params) through `io.model` as `<checkpoint_logdir>_sac_<env
steps>.pkl` after each training epoch; with `checkpoint_dir` the full
learner state (`training/checkpoint.py`: the policy, critic and target
critic params, log alpha, the three Adam states, the normaliser, the
env-step counter and the acting, SGD and eval generators' states) goes to
`<checkpoint_dir>/step_<env steps:012d>` beside it.  A run resumes from
`restore_checkpoint_path`, or else from the newest `step_*` in
`checkpoint_dir`.  The replay buffer is not saved, as in JAX: a resumed
run refills it through the prefill, its step counter going on from the
checkpoint's.

The prefill, each training step (ending in a device synchronise), its SGD
steps and each evaluation are `torch.profiler.record_function` ranges
("sac/prefill", "sac/training_step", "sac/sgd", "sac/eval").
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
from brax_torch.io import model
from brax_torch.training import (acting, checkpoint, fused_mlp, gradients, replay_buffers,
                                 running_statistics, types)
from brax_torch.training.agents.sac import losses as sac_losses
from brax_torch.training.agents.sac import networks as sac_networks

Tensor = torch.Tensor
Transition = types.Transition


def dummy_transition(obs_size: int, action_size: int) -> Transition:
    """One replay row's shapes: the Transition `actor_step` makes with the
    `truncation` extra and SAC's policy (no policy extras)."""
    obs, act, scalar = np.zeros((obs_size,)), np.zeros((action_size,)), np.zeros(())
    return Transition(observation=obs, action=act, reward=scalar, discount=scalar,
                      next_observation=obs,
                      extras={"state_extras": {"truncation": scalar}, "policy_extras": {}})


@dataclasses.dataclass
class TrainingState:
    """The learner's parameters (updated in place) and their optimizers."""

    policy_params: Dict[str, Tensor]
    q_params: Dict[str, Tensor]
    target_q_params: Dict[str, Tensor]
    log_alpha: Tensor
    policy_optimizer: torch.optim.Optimizer
    q_optimizer: torch.optim.Optimizer
    alpha_optimizer: torch.optim.Optimizer


def init_training_state(policy_params: Dict[str, Tensor], q_params: Dict[str, Tensor],
                        learning_rate: float) -> TrainingState:
    """The target critics a copy of the critics, log alpha 0; Adam at
    `learning_rate` for the policy and the critics, at 3e-4 for alpha."""
    device = next(iter(q_params.values())).device
    log_alpha = torch.zeros((), device=device, requires_grad=True)
    return TrainingState(
        policy_params=policy_params, q_params=q_params,
        target_q_params={k: v.detach().clone() for k, v in q_params.items()},
        log_alpha=log_alpha,
        policy_optimizer=gradients.adam(list(policy_params.values()), learning_rate),
        q_optimizer=gradients.adam(list(q_params.values()), learning_rate),
        alpha_optimizer=gradients.adam([log_alpha], 3e-4))


def sgd_step(ts: TrainingState, losses, transitions: Transition, normalizer_params,
             generator: torch.Generator, tau: float) -> Dict[str, Tensor]:
    """One SGD step, in place, with the JAX step's data flow: every loss's
    gradient from the parameters as the step found them (the critic with
    the temperature before this step's update, the actor with the critics
    before theirs), then the three Adam steps, then the Polyak update of
    the target critics.  The noise: one draw each for the alpha, critic and
    actor losses, in that order."""
    alpha_loss, critic_loss, actor_loss = losses
    alpha_loss_v, alpha_grad = gradients.loss_and_grads(
        alpha_loss, ts.log_alpha, ts.policy_params, normalizer_params, transitions, generator)
    alpha = torch.exp(ts.log_alpha.detach())
    critic_loss_v, q_grads = gradients.loss_and_grads(
        critic_loss, ts.q_params, ts.policy_params, normalizer_params, ts.target_q_params, alpha,
        transitions, generator)
    actor_loss_v, policy_grads = gradients.loss_and_grads(
        actor_loss, ts.policy_params, normalizer_params, ts.q_params, alpha, transitions,
        generator)
    gradients.apply_gradients(ts.alpha_optimizer, ts.log_alpha, alpha_grad)
    gradients.apply_gradients(ts.q_optimizer, ts.q_params, q_grads)
    gradients.apply_gradients(ts.policy_optimizer, ts.policy_params, policy_grads)
    with torch.no_grad():
        for k, target in ts.target_q_params.items():
            target.mul_(1 - tau).add_(ts.q_params[k] * tau)
    return {"critic_loss": critic_loss_v, "actor_loss": actor_loss_v,
            "alpha_loss": alpha_loss_v, "alpha": torch.exp(ts.log_alpha.detach())}


def train(
    environment: Union[str, envs.EnvFactory],
    num_timesteps: int,
    episode_length: int,
    action_repeat: int = 1,
    num_envs: int = 1,
    num_eval_envs: int = 128,
    learning_rate: float = 1e-4,
    discounting: float = 0.9,
    seed: int = 0,
    batch_size: int = 256,
    num_evals: int = 1,
    normalize_observations: bool = False,
    reward_scaling: float = 1.0,
    tau: float = 0.005,
    min_replay_size: int = 0,
    max_replay_size: Optional[int] = None,
    grad_updates_per_step: int = 1,
    deterministic_eval: bool = False,
    network_factory=sac_networks.make_sac_networks,
    progress_fn: Callable[[int, types.Metrics], None] = lambda *args: None,
    checkpoint_logdir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    restore_checkpoint_path: Optional[str] = None,
    eval_env: Optional[Union[str, envs.EnvFactory]] = None,
    use_fused_kernel: Optional[bool] = None,
    device="cuda",
):
    """SAC training; returns (make_policy, params, metrics).

    params is (normalizer_params, policy_params), detached copies.  Besides
    the JAX trainer's metrics, `training/sps_after_first` gives env steps/s
    over the last epoch's training steps after its first (host clock around
    synchronised steps), when the epoch has more than one.
    """
    if min_replay_size >= num_timesteps:
        raise ValueError("no training would happen: min_replay_size >= num_timesteps")
    if max_replay_size is None:
        max_replay_size = num_timesteps
    device = torch.device(device)
    if use_fused_kernel is None:
        use_fused_kernel = device.type == "cuda"
    with fused_mlp.enabled_as(bool(use_fused_kernel)):
        env_steps_per_actor_step = action_repeat * num_envs
        num_prefill_actor_steps = -(-min_replay_size // num_envs)
        num_prefill_env_steps = num_prefill_actor_steps * env_steps_per_actor_step
        assert num_timesteps - num_prefill_env_steps >= 0
        num_evals_after_init = max(num_evals - 1, 1)
        num_training_steps_per_epoch = -(
            -(num_timesteps - num_prefill_env_steps)
            // (num_evals_after_init * env_steps_per_actor_step))

        make_env = envs.factory(environment)
        env = wrappers.wrap_for_training_any(make_env(num_envs, device),
                                             episode_length=episode_length,
                                             action_repeat=action_repeat)
        eval_factory = make_env if eval_env is None else envs.factory(eval_env)
        eval_env = wrappers.wrap_for_training_any(eval_factory(num_eval_envs, device),
                                                  episode_length=episode_length,
                                                  action_repeat=action_repeat)
        obs_size, action_size = env.observation_size, env.action_size

        normalize = lambda x, y: x
        if normalize_observations:
            normalize = running_statistics.normalize
        sac_network = network_factory(observation_size=obs_size, action_size=action_size,
                                      preprocess_observations_fn=normalize, device=device)
        make_policy = sac_networks.make_inference_fn(sac_network)

        seeds = np.random.SeedSequence(seed).generate_state(7)
        generator = lambda s: torch.Generator(device=device).manual_seed(int(s))
        gen_policy, gen_q, gen_env, gen_eval, gen_buffer, gen_act, gen_sgd = map(generator, seeds)

        ts = init_training_state(sac_network.policy_network.init(gen_policy),
                                 sac_network.q_network.init(gen_q), learning_rate)
        normalizer_params = running_statistics.init_state((obs_size,), device=device)
        ckpt_params = {"policy": ts.policy_params, "q": ts.q_params,
                       "target_q": ts.target_q_params, "alpha": {"log_alpha": ts.log_alpha}}
        ckpt_optimizers = {"policy": ts.policy_optimizer, "q": ts.q_optimizer,
                           "alpha": ts.alpha_optimizer}
        ckpt_generators = {"act": gen_act, "sgd": gen_sgd, "eval": gen_eval}
        env_steps = 0
        restore_from = checkpoint.restore_path(checkpoint_dir, restore_checkpoint_path)
        if restore_from:
            normalizer_params, env_steps = checkpoint.restore(
                checkpoint.load(restore_from), ckpt_params, ckpt_optimizers, ckpt_generators,
                device)

        replay_buffer = replay_buffers.UniformSamplingQueue(
            max_replay_size=max_replay_size,
            dummy_data_sample=dummy_transition(obs_size, action_size),
            sample_batch_size=batch_size * grad_updates_per_step, device=device)
        buffer_state = replay_buffer.init(gen_buffer)

        losses = sac_losses.make_losses(sac_network=sac_network, reward_scaling=reward_scaling,
                                        discounting=discounting, action_size=action_size)

        @torch.no_grad()
        def get_experience(normalizer_params, env_state, buffer_state):
            policy = make_policy((normalizer_params, ts.policy_params))
            env_state, transitions = acting.actor_step(env, env_state, policy, gen_act,
                                                       extra_fields=("truncation",))
            normalizer_params = running_statistics.update(normalizer_params,
                                                          transitions.observation)
            buffer_state = replay_buffer.insert(buffer_state, transitions)
            return normalizer_params, env_state, buffer_state

        def training_step(normalizer_params, env_state, buffer_state, step_metrics):
            normalizer_params, env_state, buffer_state = get_experience(
                normalizer_params, env_state, buffer_state)
            buffer_state, transitions = replay_buffer.sample(buffer_state)
            transitions = types.tree_map(
                lambda x: x.reshape((grad_updates_per_step, -1) + x.shape[1:]), transitions)
            with record_function("sac/sgd"):
                for i in range(grad_updates_per_step):
                    step_metrics.append(sgd_step(ts, losses,
                                                 types.tree_map(lambda x: x[i], transitions),
                                                 normalizer_params, gen_sgd, tau))
            step_metrics[-1]["buffer_current_size"] = buffer_state.current_size
            step_metrics[-1]["buffer_current_position"] = buffer_state.current_position
            return normalizer_params, env_state, buffer_state

        env_state = env.reset(gen_env)
        evaluator = acting.Evaluator(
            eval_env, functools.partial(make_policy, deterministic=deterministic_eval),
            num_eval_envs=num_eval_envs, episode_length=episode_length,
            action_repeat=action_repeat, generator=gen_eval)

        def current_params():
            return (normalizer_params,
                    {k: v.detach().clone() for k, v in ts.policy_params.items()})

        metrics = {}
        if num_evals > 1:
            with record_function("sac/eval"):
                metrics = evaluator.run_evaluation(current_params(), training_metrics={})
            progress_fn(0, metrics)

        acting.sync(device)
        t = time.time()
        with record_function("sac/prefill"):
            for _ in range(num_prefill_actor_steps):
                normalizer_params, env_state, buffer_state = get_experience(
                    normalizer_params, env_state, buffer_state)
                env_steps += env_steps_per_actor_step
            acting.sync(device)
        training_walltime = time.time() - t

        for _ in range(num_evals_after_init):
            acting.sync(device)
            t = time.time()
            step_ends, step_metrics = [], []
            for _ in range(num_training_steps_per_epoch):
                with record_function("sac/training_step"):
                    normalizer_params, env_state, buffer_state = training_step(
                        normalizer_params, env_state, buffer_state, step_metrics)
                    env_steps += env_steps_per_actor_step
                    acting.sync(device)
                step_ends.append(time.time())
            means = {k: float(torch.stack([torch.as_tensor(m[k]) for m in step_metrics]).mean())
                     for k in ("critic_loss", "actor_loss", "alpha_loss", "alpha")}
            for k in ("buffer_current_size", "buffer_current_position"):
                means[k] = float(np.mean([m[k] for m in step_metrics if k in m]))
            epoch_training_time = time.time() - t
            training_walltime += epoch_training_time
            training_metrics = {
                "training/sps": env_steps_per_actor_step * num_training_steps_per_epoch
                / epoch_training_time,
                "training/walltime": training_walltime,
                **{f"training/{name}": value for name, value in means.items()},
            }
            if len(step_ends) > 1:
                training_metrics["training/sps_after_first"] = (
                    (len(step_ends) - 1) * env_steps_per_actor_step
                    / (step_ends[-1] - step_ends[0]))
            if checkpoint_logdir:
                model.save_params(f"{checkpoint_logdir}_sac_{env_steps}.pkl", current_params())
            if checkpoint_dir:
                checkpoint.save(checkpoint_dir, checkpoint.state(
                    env_steps, ckpt_params, ckpt_optimizers, normalizer_params, ckpt_generators))
            with record_function("sac/eval"):
                metrics = evaluator.run_evaluation(current_params(), training_metrics)
            progress_fn(env_steps, metrics)

        assert env_steps >= num_timesteps
        return make_policy, current_params(), metrics
