"""Shared JAX references for the brax_torch SAC parity tests.

Inputs are numpy arrays from fixed seeds, handed to both packages; the
port's networks carry the JAX-initialised parameters across
(`networks.load_flax_params`).  JAX and torch draw different noise, so the
JAX losses take the port's draws: `GivenNoise` is the JAX NormalTanh
distribution whose `sample_no_postprocessing` uses a given standard normal
draw in place of its key's, and `draws` replays the port's generator.  Each
JAX function is jitted once per process (lru_caches).
"""

import functools

import numpy as np
import torch

from brax_torch.training import running_statistics, types
from brax_torch.training import networks as port_networks
from brax_torch.training.agents.sac import networks as port_sac_networks

# humanoid's observation and action (SAC's critics then take 257 inputs),
# and halfcheetah's
SHAPES = {"humanoid": (240, 17), "halfcheetah": (18, 6)}
REWARD_SCALING, DISCOUNTING = 10.0, 0.99


@functools.lru_cache(maxsize=None)
def jax_networks(obs_size, action_size):
    """The JAX SAC networks (normalising) and their params from key 0."""
    import jax
    from brax_tpu.training import running_statistics as jax_rs
    from brax_tpu.training.agents.sac import networks as jax_sac_networks

    nets = jax_sac_networks.make_sac_networks(obs_size, action_size,
                                              preprocess_observations_fn=jax_rs.normalize)
    key_p, key_q = jax.random.split(jax.random.PRNGKey(0))
    return nets, nets.policy_network.init(key_p), nets.q_network.init(key_q)


def port_networks_from_jax(obs_size, action_size):
    """The port's SAC networks on the CPU holding the JAX params, and those
    params as the port's dicts (policy, q)."""
    nets = port_sac_networks.make_sac_networks(
        obs_size, action_size, preprocess_observations_fn=running_statistics.normalize,
        device="cpu")
    _, jp, jq = jax_networks(obs_size, action_size)
    port_networks.load_flax_params(nets.policy_network.mlp, jp)
    port_networks.load_flax_params(nets.q_network.module, jq)
    return (nets, dict(nets.policy_network.mlp.named_parameters()),
            dict(nets.q_network.module.named_parameters()))


def flax_leaf(params, name):
    """A flax param by the port's name: "hidden_0.kernel" (an MLP) or
    "MLP_1.hidden_0.kernel" (the Q network)."""
    tree = params["params"]
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


def normalizer(obs_size, seed=0):
    """A running-statistics state as (JAX, port)."""
    import jax.numpy as jnp
    from brax_tpu.training import running_statistics as jax_rs

    rs = np.random.RandomState(seed)
    count = np.float32(100.0)
    mean = (rs.normal(size=obs_size) * 0.1).astype(np.float32)
    std = rs.uniform(0.5, 2.0, obs_size).astype(np.float32)
    var = (std * std * count).astype(np.float32)
    jax_state = jax_rs.RunningStatisticsState(
        count=jnp.asarray(count), mean=jnp.asarray(mean), std=jnp.asarray(std),
        summed_variance=jnp.asarray(var))
    return jax_state, running_statistics.RunningStatisticsState.from_numpy(
        count, mean, std, var, device="cpu")


def transitions(obs_size, action_size, batch, seed=1):
    """A numpy Transition batch as SAC samples it: a few episodes ended
    (discount 0), a few truncated."""
    rs = np.random.RandomState(seed)
    f = lambda *shape: rs.normal(size=shape).astype(np.float32)
    return types.Transition(
        observation=f(batch, obs_size),
        action=rs.uniform(-0.99, 0.99, (batch, action_size)).astype(np.float32),
        reward=f(batch),
        discount=(rs.uniform(size=batch) > 0.2).astype(np.float32),
        next_observation=f(batch, obs_size),
        extras={"state_extras": {"truncation": (rs.uniform(size=batch) > 0.8).astype(np.float32)},
                "policy_extras": {}})


def to_torch(tree):
    return types.tree_map(torch.tensor, tree)


def to_jax(tree):
    from brax_tpu.training import types as jax_types

    return jax_types.Transition(*tree)


def draws(seed, shape, count):
    """The port's `count` standard normal draws of `shape` from one CPU
    generator seeded `seed`, in order (its distribution draws so)."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).numpy() for _ in range(count)]


def given_noise_networks(obs_size, action_size, noise):
    """The JAX SAC networks with a distribution that samples `noise`."""
    from brax_tpu.training import distribution as jax_distribution
    from brax_tpu.training.agents.sac import networks as jax_sac_networks

    class GivenNoise(jax_distribution.NormalTanhDistribution):
        def sample_no_postprocessing(self, parameters, seed):
            dist = self.create_dist(parameters)
            return noise * dist.scale + dist.loc

    nets = jax_networks(obs_size, action_size)[0]
    return jax_sac_networks.SACNetworks(
        policy_network=nets.policy_network, q_network=nets.q_network,
        parametric_action_distribution=GivenNoise(event_size=action_size))


def jax_losses(obs_size, action_size, noise):
    """(alpha_loss, critic_loss, actor_loss) of the JAX package, sampling
    `noise`."""
    from brax_tpu.training.agents.sac import losses as jax_sac_losses

    return jax_sac_losses.make_losses(given_noise_networks(obs_size, action_size, noise),
                                      reward_scaling=REWARD_SCALING, discounting=DISCOUNTING,
                                      action_size=action_size)


@functools.lru_cache(maxsize=None)
def jax_loss_grads(obs_size, action_size):
    """(noises, args) -> the three losses and their gradients with respect
    to their first arguments, one draw of noise each."""
    import jax

    def f(noises, log_alpha, policy_params, q_params, target_q_params, alpha, norm, tr):
        key = jax.random.PRNGKey(0)
        alpha_l = jax_losses(obs_size, action_size, noises[0])[0]
        critic_l = jax_losses(obs_size, action_size, noises[1])[1]
        actor_l = jax_losses(obs_size, action_size, noises[2])[2]
        return (jax.value_and_grad(alpha_l)(log_alpha, policy_params, norm, tr, key),
                jax.value_and_grad(critic_l)(q_params, policy_params, norm, target_q_params,
                                             alpha, tr, key),
                jax.value_and_grad(actor_l)(policy_params, norm, q_params, alpha, tr, key))

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def jax_sgd_step(obs_size, action_size, learning_rate, tau):
    """The JAX trainer's sgd_step (brax_tpu/training/agents/sac/train.py:
    380-436) with optax Adam, one device, the losses sampling the given
    noises: (noises, state, norm, tr) -> (state, metrics), state =
    (log_alpha, policy, q, target_q, alpha_opt, policy_opt, q_opt)."""
    import jax
    import jax.numpy as jnp
    import optax

    alpha_opt, policy_opt, q_opt = (optax.adam(3e-4), optax.adam(learning_rate),
                                    optax.adam(learning_rate))

    def step(noises, state, norm, tr):
        log_alpha, policy, q, target_q, a_state, p_state, q_state = state
        key = jax.random.PRNGKey(0)
        alpha_l = jax_losses(obs_size, action_size, noises[0])[0]
        critic_l = jax_losses(obs_size, action_size, noises[1])[1]
        actor_l = jax_losses(obs_size, action_size, noises[2])[2]
        alpha_v, g = jax.value_and_grad(alpha_l)(log_alpha, policy, norm, tr, key)
        upd, a_state = alpha_opt.update(g, a_state)
        new_log_alpha = optax.apply_updates(log_alpha, upd)
        alpha = jnp.exp(log_alpha)
        critic_v, g = jax.value_and_grad(critic_l)(q, policy, norm, target_q, alpha, tr, key)
        upd, q_state = q_opt.update(g, q_state)
        new_q = optax.apply_updates(q, upd)
        actor_v, g = jax.value_and_grad(actor_l)(policy, norm, q, alpha, tr, key)
        upd, p_state = policy_opt.update(g, p_state)
        new_policy = optax.apply_updates(policy, upd)
        new_target = jax.tree_util.tree_map(lambda x, y: x * (1 - tau) + y * tau, target_q, new_q)
        metrics = {"critic_loss": critic_v, "actor_loss": actor_v, "alpha_loss": alpha_v,
                   "alpha": jnp.exp(new_log_alpha)}
        return (new_log_alpha, new_policy, new_q, new_target, a_state, p_state, q_state), metrics

    def init(log_alpha, policy, q):
        return (log_alpha, policy, q, q, alpha_opt.init(log_alpha), policy_opt.init(policy),
                q_opt.init(q))

    return init, jax.jit(step)
