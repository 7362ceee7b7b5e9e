"""ES network bundle, inference factory and the population's policy.

Counterpart of `brax_tpu/training/agents/es/networks.py`: a (32,) * 4 relu
policy MLP with a NormalTanh head, the bundle and inference factory APG's
(`apg/networks.py`) with relu in place of swish.  `population_apply` runs
one set of parameters per env (the population's members, each a leading
row of every parameter) as batched products (`torch.baddbmm`), as the JAX
trainer vmaps the network's apply over its members.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from brax_torch.training import networks, types
from brax_torch.training.agents.apg import networks as apg_networks
from brax_torch.training.agents.apg.networks import APGNetworks as ESNetworks  # noqa: F401
from brax_torch.training.agents.apg.networks import make_inference_fn  # noqa: F401

Tensor = torch.Tensor


def make_es_networks(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (32,) * 4,
    activation=F.relu,
    device="cuda",
) -> ESNetworks:
    """Policy MLP with a NormalTanh head."""
    return apg_networks.make_apg_networks(observation_size, action_size,
                                          preprocess_observations_fn, hidden_layer_sizes,
                                          activation, device)


def population_apply(network: networks.FeedForwardNetwork, processor_params,
                     params: Mapping[str, Tensor], obs: Tensor) -> Tensor:
    """The policy MLP with member i's parameters (row i of every tensor of
    `params`: kernels (M, d_in, d_out), biases (M, d_out)) on env i's
    observation (obs (M, obs_size)): (M, d_last)."""
    mlp = network.mlp
    hidden = network.preprocess_observations_fn(obs, processor_params)[:, None, :]
    n = len(mlp.layer_sizes)
    for i in range(n):
        kernel = params[f"hidden_{i}.kernel"]
        if mlp.bias:
            hidden = torch.baddbmm(params[f"hidden_{i}.bias"][:, None, :], hidden, kernel)
        else:
            hidden = torch.bmm(hidden, kernel)
        if i != n - 1 or mlp.activate_final:
            hidden = mlp.activation(hidden)
    return hidden[:, 0]
