"""Multi-agent PPO on composed environments, on one device.

Counterpart of `brax_tpu/composer/training/mappo.py`.  Each agent of the
env's `agent_names` owns a policy/value parameter set of one shared network
shape: the joint policy writes each agent's action into its slice of the
env's action; each agent's PPO loss takes its own reward column (the env
emits an (N, agents) reward) and its own action slice.  The parameter sets
are disjoint, so one Adam over all of them is per-agent optimisation.

As the port's PPO trainer (`brax_torch/training/agents/ppo/train.py`), the
rollout, the normaliser update and the SGD epochs are Python loops over
eager torch calls with the JAX trainer's data layout; there is no mesh (one
device).  Each agent samples its actions from a `torch.Generator` of its
own (the JAX policy folds the agent's index into its key).  Physics runs
through the CUDA PBD kernel on CUDA tensors and its plain twin on CPU ones;
`use_fused_kernel=None` turns the fused MLP kernels on when `device` is
CUDA, so that each agent's policy and value chains launch them.

Each training step, its rollout and SGD epochs, and each evaluation are
`torch.profiler.record_function` ranges ("mappo/training_step",
"mappo/rollout", "mappo/sgd", "mappo/eval").
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from brax_torch.envs import wrappers
from brax_torch.training import (acting, fused_mlp, gradients, networks, running_statistics,
                                 types)
from brax_torch.training.agents.ppo import losses as ppo_losses
from brax_torch.training.agents.ppo import networks as ppo_networks

Tensor = torch.Tensor
# (batch_size, device) -> the bare multi-agent ComponentEnv
EnvFactory = Callable[[int, Union[str, torch.device]], object]


@dataclasses.dataclass
class TrainingState:
    """Learner state: the Adam over every agent's parameters, the
    parameters by agent, the observation normaliser and the step count."""

    optimizer: torch.optim.Optimizer
    params: Dict[str, ppo_losses.PPONetworkParams]
    normalizer_params: running_statistics.RunningStatisticsState
    env_steps: int


def make_joint_inference_fn(ppo_network: ppo_networks.PPONetworks, agent_names: Sequence[str],
                            agent_slices: Dict[str, Sequence[int]], action_size: int):
    """The joint policy factory: params is (normalizer_params, {agent:
    PPONetworkParams}); the policy maps (observations, generators) to (actions,
    extras), each agent's network writing its action slice.  `generators`
    is one torch.Generator per agent (agent i draws from the i-th) or one
    generator that the agents draw from in turn (None: the deterministic
    policy draws nothing)."""

    def make_policy(params, deterministic: bool = False) -> types.Policy:
        normalizer_params, agent_params = params
        dist = ppo_network.parametric_action_distribution

        def policy(observations: Tensor, generators):
            if generators is None or isinstance(generators, torch.Generator):
                generators = [generators] * len(agent_names)
            actions = torch.zeros(observations.shape[:-1] + (action_size,),
                                  device=observations.device)
            extras = {}
            for agent, gen in zip(agent_names, generators):
                logits = ppo_network.policy_network(normalizer_params,
                                                    agent_params[agent].policy, observations)
                if deterministic:
                    act = raw = dist.mode(logits)
                    log_prob = torch.zeros(observations.shape[:-1], device=observations.device)
                else:
                    raw = dist.sample_no_postprocessing(logits, gen)
                    log_prob = dist.log_prob(logits, raw)
                    act = dist.postprocess(raw)
                actions[..., list(agent_slices[agent])] = act
                extras[f"{agent}_log_prob"] = log_prob
                extras[f"{agent}_raw_action"] = raw
            return actions, extras

        return policy

    return make_policy


def compute_mappo_loss(
    params: Dict[str, ppo_losses.PPONetworkParams],
    normalizer_params,
    data: types.Transition,
    generator: torch.Generator,
    ppo_network: ppo_networks.PPONetworks,
    agent_names: Sequence[str],
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    reward_scaling: float = 1.0,
    gae_lambda: float = 0.95,
    clipping_epsilon: float = 0.3,
    normalize_advantage: bool = True,
):
    """The sum of per-agent PPO losses over a [B, T] batch (disjoint params,
    so decoupled gradients): agent i's loss reads reward column i and its
    own raw actions and behaviour log-probs."""
    dist = ppo_network.parametric_action_distribution
    data = types.tree_map(lambda x: torch.swapaxes(x, 0, 1), data)
    truncation = data.extras["state_extras"]["truncation"]
    termination = (1 - data.discount) * (1 - truncation)

    total = torch.zeros((), device=data.observation.device)
    metrics = {}
    for i, agent in enumerate(agent_names):
        p = params[agent]
        policy_logits = ppo_network.policy_network(normalizer_params, p.policy,
                                                   data.observation)
        baseline = ppo_network.value_network(normalizer_params, p.value, data.observation)
        bootstrap_value = ppo_network.value_network(normalizer_params, p.value,
                                                    data.next_observation[-1])
        rewards = data.reward[..., i] * reward_scaling
        raw_action = data.extras["policy_extras"][f"{agent}_raw_action"]
        behaviour_log_probs = data.extras["policy_extras"][f"{agent}_log_prob"]
        target_log_probs = dist.log_prob(policy_logits, raw_action)

        vs, advantages = ppo_losses.compute_gae(
            truncation=truncation, termination=termination, rewards=rewards,
            values=baseline, bootstrap_value=bootstrap_value, lambda_=gae_lambda,
            discount=discounting)
        if normalize_advantage:
            advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        rho_s = torch.exp(target_log_probs - behaviour_log_probs)
        s1 = rho_s * advantages
        s2 = torch.clamp(rho_s, 1 - clipping_epsilon, 1 + clipping_epsilon) * advantages
        policy_loss = -torch.mean(torch.minimum(s1, s2))
        v_error = vs - baseline
        v_loss = torch.mean(v_error * v_error) * 0.5 * 0.5
        entropy = torch.mean(dist.entropy(policy_logits, generator))
        agent_loss = policy_loss + v_loss + entropy_cost * -entropy
        total = total + agent_loss
        metrics[f"{agent}/policy_loss"] = policy_loss
        metrics[f"{agent}/v_loss"] = v_loss
    metrics["total_loss"] = total
    return total, metrics


def load_flax_params(agent_params, device="cpu") -> Dict[str, ppo_losses.PPONetworkParams]:
    """A JAX MAPPO's {agent: PPONetworkParams} of flax params (as arrays)
    as the port's, each network's a name -> tensor mapping on `device`."""
    return {a: ppo_losses.PPONetworkParams(
        policy=networks.flax_param_dict(p.policy, device),
        value=networks.flax_param_dict(p.value, device)) for a, p in agent_params.items()}


def _agent_params(ppo_network: ppo_networks.PPONetworks, gen_policy: torch.Generator,
                  gen_value: torch.Generator) -> ppo_losses.PPONetworkParams:
    """A fresh draw of the networks' parameters, as leaf tensors of the
    agent's own (the modules are shared by the agents)."""
    own = lambda named: {k: v.detach().clone().requires_grad_(True) for k, v in named.items()}
    return ppo_losses.PPONetworkParams(policy=own(ppo_network.policy_network.init(gen_policy)),
                                       value=own(ppo_network.value_network.init(gen_value)))


def train(
    environment: EnvFactory,
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
    progress_fn: Callable[[int, types.Metrics], None] = lambda *args: None,
    use_fused_kernel: Optional[bool] = None,
    device="cuda",
):
    """MAPPO training on a multi-agent ComponentEnv; `environment` is a
    factory `(batch_size, device) -> env` of the bare env (the training env
    is built at `num_envs`, the eval env at `num_eval_envs`).

    Returns (make_joint_policy, (normalizer_params, {agent: PPONetworkParams}),
    metrics), the params detached copies.  Besides the JAX trainer's
    metrics, `training/sps_after_first` gives env steps/s over the last
    epoch's training steps after its first, when the epoch has more than one.
    """
    assert batch_size * num_minibatches % num_envs == 0
    device = torch.device(device)
    if use_fused_kernel is None:
        use_fused_kernel = device.type == "cuda"
    with fused_mlp.enabled_as(bool(use_fused_kernel)):
        bare = environment(num_envs, device)
        inner = getattr(bare, "unwrapped", bare)
        assert getattr(inner, "is_multiagent", False), "environment must be multi-agent"
        agent_names = tuple(inner.agent_names)
        agent_slices = {a: tuple(inner.group_action_shapes[a]["indices"]) for a in agent_names}
        sizes = {len(agent_slices[a]) for a in agent_names}
        assert len(sizes) == 1, "agents must share an action size"
        per_agent_action_size = sizes.pop()

        env_step_per_training_step = batch_size * unroll_length * num_minibatches * action_repeat
        num_evals_after_init = max(num_evals - 1, 1)
        num_training_steps_per_epoch = -(
            -num_timesteps // (num_evals_after_init * env_step_per_training_step))
        num_unrolls = batch_size * num_minibatches // num_envs

        env = wrappers.wrap_for_training(bare, episode_length=episode_length,
                                         action_repeat=action_repeat)
        eval_env = wrappers.wrap_for_training(environment(num_eval_envs, device),
                                              episode_length=episode_length,
                                              action_repeat=action_repeat)

        normalize = lambda x, y: x
        if normalize_observations:
            normalize = running_statistics.normalize
        ppo_network = ppo_networks.make_ppo_networks(
            env.observation_size, per_agent_action_size, preprocess_observations_fn=normalize,
            device=device)
        make_policy = make_joint_inference_fn(ppo_network, agent_names, agent_slices,
                                              env.action_size)

        n = len(agent_names)
        seeds = np.random.SeedSequence(seed).generate_state(3 + 3 * n)
        generator = lambda s: torch.Generator(device=device).manual_seed(int(s))
        gen_env, gen_eval, gen_train = map(generator, seeds[:3])
        agent_gens = [generator(s) for s in seeds[3:]]
        params = {a: _agent_params(ppo_network, agent_gens[3 * i], agent_gens[3 * i + 1])
                  for i, a in enumerate(agent_names)}
        act_gens = tuple(agent_gens[3 * i + 2] for i in range(n))
        leaves = [t for p in params.values() for t in (*p.policy.values(), *p.value.values())]
        state = TrainingState(
            optimizer=gradients.adam(leaves, learning_rate), params=params,
            normalizer_params=running_statistics.init_state((env.observation_size,),
                                                            device=device),
            env_steps=0)
        loss_fn = functools.partial(
            compute_mappo_loss, ppo_network=ppo_network, agent_names=agent_names,
            entropy_cost=entropy_cost, discounting=discounting, reward_scaling=reward_scaling,
            gae_lambda=gae_lambda, clipping_epsilon=clipping_epsilon)
        update_fn = gradients.gradient_update_fn(loss_fn, state.optimizer, has_aux=True)

        def policy_params():
            copy = lambda named: {k: v.detach().clone() for k, v in named.items()}
            return (state.normalizer_params,
                    {a: ppo_losses.PPONetworkParams(policy=copy(p.policy), value=copy(p.value))
                     for a, p in params.items()})

        def training_step(env_state, loss_metrics):
            policy = make_policy((state.normalizer_params, params))
            unrolls = []
            with record_function("mappo/rollout"):
                for _ in range(num_unrolls):
                    env_state, data = acting.generate_unroll(
                        env, env_state, policy, act_gens, unroll_length,
                        extra_fields=("truncation",))
                    unrolls.append(data)
            # [unrolls, T, num_envs, ...] -> [unrolls * num_envs, T, ...]
            data = types.tree_map(
                lambda x: torch.swapaxes(x, 1, 2).reshape((-1,) + (x.shape[1],) + x.shape[3:]),
                types.tree_stack(unrolls))
            state.normalizer_params = running_statistics.update(state.normalizer_params,
                                                                data.observation)
            with record_function("mappo/sgd"):
                for _ in range(num_updates_per_batch):
                    perm = torch.randperm(data.observation.shape[0], generator=gen_train,
                                          device=device)
                    shuffled = types.tree_map(
                        lambda x: x[perm].reshape((num_minibatches, -1) + x.shape[1:]), data)
                    for m in range(num_minibatches):
                        minibatch = types.tree_map(lambda x: x[m], shuffled)
                        _, metrics = update_fn(params, state.normalizer_params, minibatch,
                                               gen_train)
                        loss_metrics.append({k: v.detach() for k, v in metrics.items()})
            state.env_steps += env_step_per_training_step
            return env_state

        env_state = env.reset(gen_env)
        evaluator = acting.Evaluator(
            eval_env, functools.partial(make_policy, deterministic=deterministic_eval),
            num_eval_envs=num_eval_envs, episode_length=episode_length,
            action_repeat=action_repeat, generator=gen_eval)

        metrics = {}
        training_walltime = 0.0
        for _ in range(num_evals_after_init):
            acting.sync(device)
            t = time.time()
            step_ends, loss_metrics = [], []
            for _ in range(num_training_steps_per_epoch):
                with record_function("mappo/training_step"):
                    env_state = training_step(env_state, loss_metrics)
                    acting.sync(device)
                step_ends.append(time.time())
            means = {k: float(torch.stack([m[k] for m in loss_metrics]).mean())
                     for k in loss_metrics[0]}
            epoch_training_time = time.time() - t
            training_walltime += epoch_training_time
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
            with record_function("mappo/eval"):
                metrics = evaluator.run_evaluation(policy_params(), training_metrics)
            progress_fn(state.env_steps, metrics)

        assert state.env_steps >= num_timesteps
        return make_policy, policy_params(), metrics
