"""ARS linear policy network.

Counterpart of `brax_tpu/training/agents/ars/networks.py`: one linear map,
obs -> preprocess -> obs @ W with W (observation_size, action_size),
starting at zero.  `population_apply` runs one W per env (the
population's members, W (M, observation_size, action_size)) as a batched
product, as the JAX trainer vmaps the apply over its members.
"""

from __future__ import annotations

import torch

from brax_torch.training import types

Tensor = torch.Tensor


class ARSNetwork:
    """The linear policy, called as net(processor_params, policy_params, obs)."""

    def __init__(self, observation_size: int, action_size: int,
                 preprocess_observations_fn: types.PreprocessObservationFn, device="cuda"):
        self.observation_size, self.action_size = observation_size, action_size
        self.preprocess_observations_fn = preprocess_observations_fn
        self.device = torch.device(device)

    def init(self, generator=None) -> Tensor:
        return torch.zeros((self.observation_size, self.action_size), device=self.device)

    def __call__(self, processor_params, policy_params: Tensor, obs: Tensor) -> Tensor:
        return self.preprocess_observations_fn(obs, processor_params) @ policy_params

    def population_apply(self, processor_params, policy_params: Tensor, obs: Tensor) -> Tensor:
        """Member i's W (policy_params[i]) on env i's observation (obs (M, obs))."""
        obs = self.preprocess_observations_fn(obs, processor_params)
        return torch.bmm(obs[:, None, :], policy_params)[:, 0]


def make_policy_network(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    device="cuda",
) -> ARSNetwork:
    """A single linear layer policy (the ARS paper's policy class)."""
    return ARSNetwork(observation_size, action_size, preprocess_observations_fn, device)


def make_inference_fn(policy_network: ARSNetwork):
    """Creates the params -> policy function for ARS; params is
    (normalizer_params, W).  The policy is deterministic."""

    def make_policy(params: types.PolicyParams) -> types.Policy:
        def policy(observations: types.Observation, unused_generator=None):
            return policy_network(*params, observations), {}

        return policy

    return make_policy
