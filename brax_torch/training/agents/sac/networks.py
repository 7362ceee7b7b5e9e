"""SAC network bundle and inference factory.

Counterpart of `brax_tpu/training/agents/sac/networks.py`, with the same
default sizes: a (256, 256) relu policy with a NormalTanh head and twin
(256, 256) relu critics over the observation and the action.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from brax_torch.training import distribution, networks, types


@dataclass
class SACNetworks:
    policy_network: networks.FeedForwardNetwork
    q_network: networks.QNetwork
    parametric_action_distribution: distribution.ParametricDistribution


def make_inference_fn(sac_networks: SACNetworks):
    """Creates the params -> policy function for the SAC agent.

    params is (normalizer_params, policy_params); the policy maps
    (observations, generator) to (actions, {}).
    """

    def make_policy(params: types.PolicyParams, deterministic: bool = False) -> types.Policy:
        def policy(observations: types.Observation, generator: torch.Generator):
            logits = sac_networks.policy_network(*params, observations)
            if deterministic:
                return sac_networks.parametric_action_distribution.mode(logits), {}
            return sac_networks.parametric_action_distribution.sample(logits, generator), {}

        return policy

    return make_policy


def make_sac_networks(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (256, 256),
    activation=F.relu,
    device="cuda",
) -> SACNetworks:
    """Policy + twin-Q relu MLPs with a NormalTanh head."""
    parametric_action_distribution = distribution.NormalTanhDistribution(event_size=action_size)
    policy_network = networks.make_policy_network(
        parametric_action_distribution.param_size,
        observation_size,
        preprocess_observations_fn=preprocess_observations_fn,
        hidden_layer_sizes=hidden_layer_sizes,
        activation=activation,
        device=device,
    )
    q_network = networks.make_q_network(
        observation_size,
        action_size,
        preprocess_observations_fn=preprocess_observations_fn,
        hidden_layer_sizes=hidden_layer_sizes,
        activation=activation,
        device=device,
    )
    return SACNetworks(
        policy_network=policy_network,
        q_network=q_network,
        parametric_action_distribution=parametric_action_distribution,
    )
