"""PPO at the fetch recipe's shapes on the CPU, and the registry's
`register` and `create_fn`.

fetch's PPO networks (the recipe's defaults: policy 101 -> 32x4 -> 20,
value 101 -> 256x5 -> 1) are initialised by the JAX package from a key,
carried across by `networks.load_flax_params` and applied to one
minibatch of the recipe (batch 256 x unroll 20 = 5,120 rows) of fetch
observations, against the JAX networks on the same normaliser: f32 at
tests/test_fused_mlp.py's 2e-5, the fused (bf16) route to BF16_REL of the
largest value, as tests/test_torch_ppo.py holds ant's.  One PPO training
step runs at tiny sizes through the fetch env.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.training import fused_mlp as jax_fused
from brax_tpu.training import running_statistics as jax_rs
from brax_tpu.training.agents.ppo import networks as jax_ppo_networks
from brax_torch import envs
from brax_torch.braxlines import defaults
from brax_torch.sim import kernels
from brax_torch.training import fused_mlp, networks, running_statistics
from brax_torch.training.agents.ppo import losses
from brax_torch.training.agents.ppo import networks as ppo_networks

from tests.torch_parity import one_torch_thread  # noqa: F401

OBS, ACT = 101, 10
BF16_REL = 1e-2
RECIPE = defaults.DEFAULT_PPO_PARAMS["fetch"]
ROWS = RECIPE["batch_size"] * RECIPE["unroll_length"]


@functools.lru_cache(maxsize=None)
def _jax_networks():
    nets = jax_ppo_networks.make_ppo_networks(
        OBS, ACT, preprocess_observations_fn=jax_rs.normalize)
    key_p, key_v = jax.random.split(jax.random.PRNGKey(0))
    return nets, nets.policy_network.init(key_p), nets.value_network.init(key_v)


@functools.lru_cache(maxsize=None)
def _observations():
    """(ROWS, OBS) fetch observations: 256 envs over 20 steps of uniform
    actions in [-1, 1], from a reset; and their mean and std."""
    env = envs.create("fetch", batch_size=256, episode_length=1000, device="cpu")
    state = env.reset(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    obs = []
    for _ in range(RECIPE["unroll_length"]):
        state = env.step(state, torch.rand((256, ACT), generator=gen) * 2 - 1)
        obs.append(state.obs)
    obs = torch.cat(obs).numpy()
    return obs, obs.mean(axis=0), obs.std(axis=0) + 1e-2


@functools.lru_cache(maxsize=None)
def _jax_apply(fused: bool):
    nets, _, _ = _jax_networks()
    fn = jax.jit(lambda n, pp, vp, obs: (nets.policy_network.apply(n, pp, obs),
                                        nets.value_network.apply(n, vp, obs)))
    prev = jax_fused.enabled()
    jax_fused.enable(fused)
    try:
        norm, _ = _normalizer()
        _, jp, jv = _jax_networks()
        fn(norm, jp, jv, jnp.zeros((2, OBS)))  # trace now, under the flag
    finally:
        jax_fused.enable(prev)
    return fn


def _normalizer():
    _, mean, std = _observations()
    count = np.float32(ROWS)
    mean, std = mean.astype(np.float32), std.astype(np.float32)
    var = (std * std * count).astype(np.float32)
    jax_state = jax_rs.RunningStatisticsState(
        count=jnp.asarray(count), mean=jnp.asarray(mean), std=jnp.asarray(std),
        summed_variance=jnp.asarray(var))
    return jax_state, running_statistics.RunningStatisticsState.from_numpy(
        count, mean, std, var, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_fetch_networks_match_jax(fused):
    """The policy and value networks at fetch's widths on a minibatch of
    the recipe, JAX's parameters carried across."""
    obs, _, _ = _observations()
    assert obs.shape == (ROWS, OBS) == (5120, 101)
    jn, tn = _normalizer()
    _, jp, jv = _jax_networks()
    want = _jax_apply(fused)(jn, jp, jv, obs)
    nets = ppo_networks.make_ppo_networks(
        OBS, ACT, preprocess_observations_fn=running_statistics.normalize, device="cpu")
    networks.load_flax_params(nets.policy_network.mlp, jp)
    networks.load_flax_params(nets.value_network.mlp, jv)
    params = losses.PPONetworkParams(policy=dict(nets.policy_network.mlp.named_parameters()),
                                     value=dict(nets.value_network.mlp.named_parameters()))
    prev = fused_mlp.enabled()
    fused_mlp.enable(fused)
    try:
        with torch.no_grad():
            got = (nets.policy_network(tn, params.policy, torch.tensor(obs)),
                   nets.value_network(tn, params.value, torch.tensor(obs)))
    finally:
        fused_mlp.enable(prev)
    assert got[0].shape == (ROWS, 2 * ACT) and got[1].shape == (ROWS,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if fused:
            assert np.abs(g.numpy() - w).max() <= BF16_REL * np.abs(w).max()
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)


def test_ppo_trains_fetch():
    """One PPO training step at the fetch recipe's shape (unroll 20 cut to
    2, batch 256 to 4) at tiny sizes: the 101-wide observation, the 10-wide
    action (20 policy outputs)."""
    from brax_torch.training.agents.ppo import train as ppo

    calls = []
    step = kernels.pbd_step_plain

    def counting(sys_, qp, act):
        calls.append(tuple(act.shape))
        return step(sys_, qp, act)

    kernels.pbd_step_plain = counting
    try:
        _, params, metrics = ppo.train(
            "fetch", num_timesteps=16, episode_length=8, num_envs=4, num_eval_envs=2,
            unroll_length=2, batch_size=4, num_minibatches=2, num_updates_per_batch=1,
            num_evals=1, normalize_observations=True, reward_scaling=5.0, discounting=0.997,
            seed=0, device="cpu")
    finally:
        kernels.pbd_step_plain = step
    for key in ("training/total_loss", "training/policy_loss", "training/v_loss",
                "eval/episode_reward"):
        assert np.isfinite(metrics[key]), key
    assert params[1]["hidden_0.kernel"].shape == (OBS, 32)
    assert params[1]["hidden_4.kernel"].shape == (32, 2 * ACT)
    assert calls.count((4, ACT)) == 4 and calls.count((2, ACT)) == 8


def test_register_and_create_fn():
    """`register` adds a factory that `create` wraps as it wraps the
    built-in envs; `create_fn` binds create's arguments."""
    from brax_torch.envs import Fetch, _envs

    made = []

    def factory(batch_size, device, **kwargs):
        made.append((batch_size, kwargs))
        return Fetch(batch_size=batch_size, device=device)

    envs.register("fetch_registered", factory)
    try:
        make = envs.create_fn("fetch_registered", batch_size=3, episode_length=4,
                              device="cpu", legacy_spring=True)
        env = make()
        assert made == [(3, {"legacy_spring": True})]
        state = env.reset(torch.Generator().manual_seed(0))
        state = env.step(state, torch.zeros((3, ACT)))
        assert state.obs.shape == (3, OBS) and type(env.unwrapped).__name__ == "Fetch"
        assert envs.create_fn("fetch", device="cpu")().action_size == ACT
    finally:
        del _envs["fetch_registered"]
