"""PPO network bundle and inference factory.

Counterpart of `brax_tpu/training/agents/ppo/networks.py`, with the same
default sizes: policy 32x4 and value 256x5 swish MLPs, NormalTanh head.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from brax_torch.training import distribution, networks, types


@dataclass
class PPONetworks:
    policy_network: networks.FeedForwardNetwork
    value_network: networks.FeedForwardNetwork
    parametric_action_distribution: distribution.ParametricDistribution


def make_inference_fn(ppo_networks: PPONetworks):
    """Creates the params -> policy function for the PPO agent.

    params is (normalizer_params, policy_params); the policy maps
    (observations, generator) to (actions, extras).
    """

    def make_policy(params: types.PolicyParams, deterministic: bool = False) -> types.Policy:
        policy_network = ppo_networks.policy_network
        parametric_action_distribution = ppo_networks.parametric_action_distribution

        def policy(observations: types.Observation, generator: torch.Generator):
            logits = policy_network(*params, observations)
            if deterministic:
                return parametric_action_distribution.mode(logits), {}
            raw_actions = parametric_action_distribution.sample_no_postprocessing(
                logits, generator)
            log_prob = parametric_action_distribution.log_prob(logits, raw_actions)
            postprocessed_actions = parametric_action_distribution.postprocess(raw_actions)
            return postprocessed_actions, {"log_prob": log_prob, "raw_action": raw_actions}

        return policy

    return make_policy


def make_ppo_networks(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    policy_hidden_layer_sizes: Sequence[int] = (32,) * 4,
    value_hidden_layer_sizes: Sequence[int] = (256,) * 5,
    activation=F.silu,
    device="cuda",
) -> PPONetworks:
    """Policy (32x4) + value (256x5) swish MLPs with a NormalTanh head."""
    parametric_action_distribution = distribution.NormalTanhDistribution(event_size=action_size)
    policy_network = networks.make_policy_network(
        parametric_action_distribution.param_size,
        observation_size,
        preprocess_observations_fn=preprocess_observations_fn,
        hidden_layer_sizes=policy_hidden_layer_sizes,
        activation=activation,
        device=device,
    )
    value_network = networks.make_value_network(
        observation_size,
        preprocess_observations_fn=preprocess_observations_fn,
        hidden_layer_sizes=value_hidden_layer_sizes,
        activation=activation,
        device=device,
    )
    return PPONetworks(
        policy_network=policy_network,
        value_network=value_network,
        parametric_action_distribution=parametric_action_distribution,
    )
