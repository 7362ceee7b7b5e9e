"""APG network bundle and inference factory.

Counterpart of `brax_tpu/training/agents/apg/networks.py`: a 32x4 swish
policy MLP with a NormalTanh head.  Its samples are reparametrised (the
normal's noise times its scale plus its mean, then tanh), so the gradient
of a rollout's reward reaches the policy through the actions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from brax_torch.training import distribution, networks, types


@dataclass
class APGNetworks:
    policy_network: networks.FeedForwardNetwork
    parametric_action_distribution: distribution.ParametricDistribution


def make_inference_fn(apg_networks: APGNetworks):
    """Creates the params -> policy function for APG.

    params is (normalizer_params, policy_params); the policy maps
    (observations, generator) to (actions, {}), differentiable in the
    observations and the policy params.
    """

    def make_policy(params: types.PolicyParams, deterministic: bool = False) -> types.Policy:
        def policy(observations: types.Observation, generator: torch.Generator):
            logits = apg_networks.policy_network(*params, observations)
            if deterministic:
                return apg_networks.parametric_action_distribution.mode(logits), {}
            return apg_networks.parametric_action_distribution.sample(logits, generator), {}

        return policy

    return make_policy


def make_apg_networks(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (32,) * 4,
    activation=F.silu,
    device="cuda",
) -> APGNetworks:
    """Policy MLP with a NormalTanh head."""
    parametric_action_distribution = distribution.NormalTanhDistribution(event_size=action_size)
    policy_network = networks.make_policy_network(
        parametric_action_distribution.param_size,
        observation_size,
        preprocess_observations_fn=preprocess_observations_fn,
        hidden_layer_sizes=hidden_layer_sizes,
        activation=activation,
        device=device,
    )
    return APGNetworks(policy_network=policy_network,
                       parametric_action_distribution=parametric_action_distribution)
