"""The port's ES trainer (`brax_torch/training/agents/es`) against the JAX
package's, on the CPU.

The fitness shapings equal JAX's on shared scores (with ties).  One
epoch's update equals the JAX trainer's to 1e-6 given the same params, the
same noise and the same episode (tests/es_ars_parity.py drives the JAX
`train` itself on them): the normaliser's weighted update, the shaped
pair weights, `compute_delta` with `l2coeff` and the Adam step, for the
original shaping with centred fitness and for the centred rank.
"""

import jax
import numpy as np
import torch

from brax_tpu.training.agents.es import train as jax_es
from brax_torch.training import gradients, running_statistics
from brax_torch.training import networks as port_networks
from brax_torch.training.agents.es import networks as es_networks
from brax_torch.training.agents.es import train as es

from tests import es_ars_parity as ep
from tests.torch_parity import one_torch_thread  # noqa: F401

P = 8  # population: 16 envs (a multiple of the 8 CPU devices tests/conftest.py makes)


def test_fitness_shaping_matches_jax():
    rs = np.random.RandomState(0)
    for x in (rs.normal(0, 5, 16).astype(np.float32),
              np.array([3.0, 1.0, 3.0, -2.0, 1.0, 1.0, 0.5, 3.0], np.float32)):
        for shaping in ("ORIGINAL", "CENTERED_RANK", "WIERSTRA"):
            got = es.FitnessShaping[shaping].value(torch.from_numpy(x))
            want = np.asarray(jax_es.FitnessShaping[shaping].value(jax.numpy.asarray(x)))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, atol=1e-7, err_msg=shaping)


def _flax_params(policy):
    """The port's {hidden_i.kernel: ...} as flax's {"params": {"hidden_i": ...}}."""
    layers = {}
    for name, v in policy.items():
        layer, leaf = name.split(".")
        layers.setdefault(layer, {})[leaf] = v.detach().numpy()
    return {"params": layers}


def test_es_update_matches_jax():
    for shaping, center, l2coeff in (("ORIGINAL", True, 0.05), ("CENTERED_RANK", False, 0.0)):
        _update_matches(shaping, center, l2coeff)


def _update_matches(shaping, center, l2coeff):
    nets = es_networks.make_es_networks(ep.OBS, ep.ACT, device="cpu")
    policy = nets.policy_network.init(torch.Generator().manual_seed(1))
    flax = _flax_params(policy)
    gen = torch.Generator().manual_seed(2)
    _, _, noise = es.add_noise(policy, 0.1, P, gen)
    paths = [tuple(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(flax)[0]]
    leaves = [noise[f"{layer}.{leaf}"].numpy() for _, layer, leaf in paths]
    scores, obs, weights = ep.episode(P)
    lr = 0.01
    want_norm, want_params = ep.jax_es_epoch(
        flax, leaves, scores, obs, weights, population_size=P, learning_rate=lr,
        fitness_shaping=jax_es.FitnessShaping[shaping], center_fitness=center, l2coeff=l2coeff,
        normalize_observations=True)

    optimizer = gradients.adam(list(policy.values()), lr)
    with torch.no_grad():
        es.es_update(policy, noise, torch.from_numpy(scores), optimizer,
                     es.FitnessShaping[shaping], center, l2coeff)
        norm = running_statistics.update(
            running_statistics.init_state((ep.OBS,), device="cpu"),
            torch.from_numpy(obs).reshape(-1, ep.OBS),
            weights=torch.from_numpy(weights).reshape(-1))
    want = port_networks.flax_param_dict(want_params)
    assert sorted(want) == sorted(policy)
    for k, v in want.items():
        np.testing.assert_allclose(policy[k].detach().numpy(), v.numpy(), atol=1e-6, err_msg=k)
    for f in ("count", "mean", "std", "summed_variance"):
        np.testing.assert_allclose(getattr(norm, f).numpy(), np.asarray(getattr(want_norm, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
