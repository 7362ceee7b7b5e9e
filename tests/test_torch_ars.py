"""The port's ARS trainer (`brax_torch/training/agents/ars`) against the JAX
package's on the CPU, and both trainers' policies from carried-over
params.

One ARS update equals the JAX trainer's to 1e-6 given the same W, the same
directions and the same episode (tests/es_ars_parity.py drives the JAX
`train` itself on them): the normaliser, the top-k selection by max(r+,
r-), the selected rewards' std and the step; and with every score equal,
where the std guard (the JAX comment at tests/test_es_ars_apg.py:111-113)
keeps W finite in both.  A JAX ES policy's flax params and an ARS W, with
a JAX normaliser, load into the port (`networks.flax_param_dict`,
`RunningStatisticsState.from_numpy`) and give the same actions at v1 ant's
widths; both trainers' params survive a pickle round trip and a mesh is
refused.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.training import running_statistics as jax_rs
from brax_tpu.training.agents.ars import networks as jax_ars_networks
from brax_tpu.training.agents.es import networks as jax_es_networks
from brax_torch.training import networks as port_networks
from brax_torch.training import running_statistics
from brax_torch.training.agents.ars import networks as ars_networks
from brax_torch.training.agents.ars import train as ars
from brax_torch.training.agents.es import networks as es_networks
from brax_torch.training.agents.es import train as es

from tests import es_ars_parity as ep
from tests.torch_parity import one_torch_thread  # noqa: F401

D, TOP = 8, 3  # directions: 16 envs (a multiple of the 8 CPU devices)


def _ars_update_matches(scores, obs, weights, seed):
    w0 = torch.from_numpy(np.random.RandomState(seed).normal(0, 0.3, (ep.OBS, ep.ACT))
                          .astype(np.float32))
    _, _, noise = ars.add_noise(w0, 0.2, D, torch.Generator().manual_seed(seed))
    want_norm, want_w = ep.jax_ars_epoch(w0.numpy(), noise.numpy(), scores, obs, weights,
                                         number_of_directions=D, top_directions=TOP,
                                         step_size=0.3, exploration_noise_std=0.2,
                                         normalize_observations=True)
    got_w, _ = ars.ars_update(w0, noise, torch.from_numpy(scores), TOP, 0.3)
    norm = running_statistics.update(running_statistics.init_state((ep.OBS,), device="cpu"),
                                     torch.from_numpy(obs).reshape(-1, ep.OBS),
                                     weights=torch.from_numpy(weights).reshape(-1))
    assert bool(torch.isfinite(got_w).all())
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6)
    for f in ("count", "mean", "std", "summed_variance"):
        np.testing.assert_allclose(getattr(norm, f).numpy(), np.asarray(getattr(want_norm, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    return got_w, w0


def test_ars_update_matches_jax():
    scores, obs, weights = ep.episode(D, seed=1)
    got, w0 = _ars_update_matches(scores, obs, weights, seed=2)
    assert not torch.equal(got, w0)
    # every score equal: the std of the selected rewards is 0, counted as 1,
    # and the antithetic differences are 0, so W stays
    got, w0 = _ars_update_matches(np.full(2 * D, 3.0, np.float32), obs, weights, seed=3)
    torch.testing.assert_close(got, w0, rtol=0, atol=0)


def test_carried_params_act_alike_and_round_trip():
    obs_size, act_size = 87, 8
    rs = np.random.RandomState(4)
    obs = rs.normal(0, 3, (16, obs_size)).astype(np.float32)
    mean = rs.normal(0, 1, obs_size).astype(np.float32)
    std = rs.uniform(0.5, 2, obs_size).astype(np.float32)
    jnorm = jax_rs.RunningStatisticsState(count=jnp.float32(100.0), mean=jnp.asarray(mean),
                                          std=jnp.asarray(std),
                                          summed_variance=jnp.asarray(std ** 2 * 100))
    norm = running_statistics.RunningStatisticsState.from_numpy(
        100.0, mean, std, std ** 2 * 100, device="cpu")

    # ES: the JAX flax params of its (32,) * 4 relu MLP
    jnets = jax_es_networks.make_es_networks(obs_size, act_size,
                                             preprocess_observations_fn=jax_rs.normalize)
    jparams = jnets.policy_network.init(jax.random.PRNGKey(5))
    want = jax_es_networks.make_inference_fn(jnets)((jnorm, jparams), deterministic=True)(
        jnp.asarray(obs), jax.random.PRNGKey(0))[0]
    nets = es_networks.make_es_networks(obs_size, act_size,
                                        preprocess_observations_fn=running_statistics.normalize,
                                        device="cpu")
    params = (norm, port_networks.flax_param_dict(jparams))
    make_policy = es_networks.make_inference_fn(nets)
    got = make_policy(params, deterministic=True)(torch.from_numpy(obs), None)[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    again = pickle.loads(pickle.dumps(params))
    torch.testing.assert_close(make_policy(again, deterministic=True)(torch.from_numpy(obs),
                                                                       None)[0], got)
    # the population's batched product is the policy, member by member
    pop = {k: v[None].repeat(16, *([1] * v.dim())) for k, v in params[1].items()}
    logits = es_networks.population_apply(nets.policy_network, norm, pop, torch.from_numpy(obs))
    torch.testing.assert_close(nets.parametric_action_distribution.mode(logits), got)

    # ARS: an (obs, act) matrix
    w = rs.normal(0, 0.1, (obs_size, act_size)).astype(np.float32)
    jnet = jax_ars_networks.make_policy_network(obs_size, act_size,
                                                preprocess_observations_fn=jax_rs.normalize)
    want = jax_ars_networks.make_inference_fn(jnet)((jnorm, jnp.asarray(w)))(
        jnp.asarray(obs), None)[0]
    net = ars_networks.make_policy_network(obs_size, act_size,
                                           preprocess_observations_fn=running_statistics.normalize,
                                           device="cpu")
    params = (norm, port_networks.flax_param_dict(w))
    make_policy = ars_networks.make_inference_fn(net)
    got = make_policy(params)(torch.from_numpy(obs))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    torch.testing.assert_close(make_policy(pickle.loads(pickle.dumps(params)))(
        torch.from_numpy(obs))[0], got)

    # the trainers' own params after a short run on fast, as the JAX
    # tests/test_es_ars_apg.py round-trips them
    zero = torch.zeros((2, 2))
    for trainer, kw in ((es, {"deterministic": True}), (ars, {})):
        make_policy, params, _ = trainer.train("fast", num_timesteps=128, episode_length=16,
                                               normalize_observations=True, num_eval_envs=4,
                                               device="cpu")
        act = make_policy(params, **kw)(zero, None)[0]
        assert bool(torch.isfinite(act).all())
        torch.testing.assert_close(make_policy(pickle.loads(pickle.dumps(params)), **kw)(
            zero, None)[0], act)
        with pytest.raises(NotImplementedError):
            trainer.train("fast", mesh=object(), device="cpu")
