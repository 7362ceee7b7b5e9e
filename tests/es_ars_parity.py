"""The JAX ES and ARS trainers' update, driven on given inputs, for the
tests of the port's trainers on the CPU.

`jax_es_epoch` / `jax_ars_epoch` run the JAX package's own `train` for one
epoch with its randomness and its episode replaced by given numbers: the
policy's initial params (through `network_factory`), the noise (each
`jax.random.normal` draw of the epoch's add_noise, in the params' leaf
order) and the episode's scores, observations and active-step weights (the
shard_mapped episode, `mesh_utils.shard_map`, returns them).  What comes
back is the trainer's (normalizer_params, policy_params) after its update.
The env is the JAX `fast`; its evaluation after the epoch runs the real
env (deterministic, ES's `deterministic_eval`).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

OBS, ACT = 2, 1  # the fast env's widths


@contextlib.contextmanager
def given_randomness(noise, scores, obs, weights):
    """jax.random.normal hands out `noise` (arrays, in order, where the
    requested shape matches) and mesh_utils.shard_map's program returns
    (scores, obs, weights)."""
    from brax_tpu.training import mesh_utils

    real_normal, real_shard_map = jax.random.normal, mesh_utils.shard_map
    queue = [jnp.asarray(n) for n in noise]

    def normal(key, shape=(), dtype=jnp.float32):
        if queue and tuple(shape) == queue[0].shape:
            return queue.pop(0).astype(dtype)
        return real_normal(key, shape, dtype)

    episode = tuple(jnp.asarray(x) for x in (scores, obs, weights))
    jax.random.normal = normal
    mesh_utils.shard_map = lambda f, mesh, in_specs, out_specs: (lambda *args: episode)
    try:
        yield queue
    finally:
        jax.random.normal, mesh_utils.shard_map = real_normal, real_shard_map


def _fixed_init(network, params):
    from brax_tpu.training import networks

    return networks.FeedForwardNetwork(init=lambda key: params, apply=network.apply)


def jax_es_epoch(params, noise, scores, obs, weights, **kw):
    """The JAX ES trainer's (normalizer_params, policy_params) after one
    epoch from flax `params` on the given noise (leaves of (P, ...)) and
    episode; `kw` go to es.train (population_size, fitness_shaping, ...)."""
    from brax_tpu import envs
    from brax_tpu.training.agents.es import networks as es_networks
    from brax_tpu.training.agents.es import train as es

    def factory(*args, **kwargs):
        nets = es_networks.make_es_networks(*args, **kwargs)
        return nets.replace(policy_network=_fixed_init(nets.policy_network, params))

    with given_randomness(noise, scores, obs, weights) as queue:
        _, out, _ = es.train(envs._envs["fast"](), num_timesteps=1, episode_length=4,
                             network_factory=factory, deterministic_eval=True,
                             num_eval_envs=8, **kw)
    assert not queue, "the epoch drew less noise than given"
    return out


def jax_ars_epoch(params, noise, scores, obs, weights, **kw):
    """The JAX ARS trainer's (normalizer_params, W) after one epoch from W =
    `params` on the given noise ((D, obs, act)) and episode."""
    from brax_tpu import envs
    from brax_tpu.training.agents.ars import networks as ars_networks
    from brax_tpu.training.agents.ars import train as ars

    def factory(*args, **kwargs):
        return _fixed_init(ars_networks.make_policy_network(*args, **kwargs), params)

    with given_randomness([noise], scores, obs, weights) as queue:
        _, out, _ = ars.train(envs._envs["fast"](), num_timesteps=1, episode_length=4,
                              network_factory=factory, num_eval_envs=8, **kw)
    assert not queue, "the epoch drew less noise than given"
    return out


def episode(members, steps=6, seed=0):
    """(scores (2M,), obs (T, 2M, OBS), weights (T, 2M)) of a made-up
    episode: some envs end early (their weights drop to 0 and stay)."""
    rs = np.random.RandomState(seed)
    scores = rs.normal(0, 10, 2 * members).astype(np.float32)
    obs = rs.normal(0, 2, (steps, 2 * members, OBS)).astype(np.float32)
    ends = rs.randint(2, steps + 1, 2 * members)
    weights = (np.arange(steps)[:, None] < ends[None]).astype(np.float32)
    return scores, obs, weights
