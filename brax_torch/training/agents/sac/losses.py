"""SAC losses: the entropy temperature's, the twin-Q TD critic's and the
reparameterised actor's.

Counterpart of `brax_tpu/training/agents/sac/losses.py`.  Each loss's first
argument is the one differentiated (`gradients.loss_and_grads`); every
other network's forward that JAX does not differentiate runs under
`torch.no_grad`: the policy in the temperature and critic losses, and the
target critics.  Noise comes from a `torch.Generator` through the
distribution, one draw of [batch, action_size] per loss.
"""

from __future__ import annotations

from typing import Any

import torch

from brax_torch.training import types
from brax_torch.training.agents.sac import networks as sac_networks

Tensor = torch.Tensor
Transition = types.Transition


def make_losses(sac_network: sac_networks.SACNetworks, reward_scaling: float,
                discounting: float, action_size: int):
    """Creates the SAC losses (alpha_loss, critic_loss, actor_loss)."""
    target_entropy = -0.5 * action_size
    policy_network = sac_network.policy_network
    q_network = sac_network.q_network
    parametric_action_distribution = sac_network.parametric_action_distribution

    def alpha_loss(log_alpha: Tensor, policy_params, normalizer_params: Any,
                   transitions: Transition, generator: torch.Generator) -> Tensor:
        """Entropy temperature loss."""
        with torch.no_grad():
            dist_params = policy_network(normalizer_params, policy_params,
                                         transitions.observation)
            action = parametric_action_distribution.sample_no_postprocessing(dist_params,
                                                                             generator)
            log_prob = parametric_action_distribution.log_prob(dist_params, action)
        alpha = torch.exp(log_alpha)
        return torch.mean(alpha * (-log_prob - target_entropy))

    def critic_loss(q_params, policy_params, normalizer_params: Any, target_q_params,
                    alpha: Tensor, transitions: Transition,
                    generator: torch.Generator) -> Tensor:
        q_old_action = q_network(normalizer_params, q_params, transitions.observation,
                                 transitions.action)
        with torch.no_grad():
            next_dist_params = policy_network(normalizer_params, policy_params,
                                              transitions.next_observation)
            next_action = parametric_action_distribution.sample_no_postprocessing(
                next_dist_params, generator)
            next_log_prob = parametric_action_distribution.log_prob(next_dist_params,
                                                                    next_action)
            next_action = parametric_action_distribution.postprocess(next_action)
            next_q = q_network(normalizer_params, target_q_params,
                               transitions.next_observation, next_action)
            next_v = torch.amin(next_q, dim=-1) - alpha * next_log_prob
            target_q = (transitions.reward * reward_scaling
                        + transitions.discount * discounting * next_v)
        q_error = q_old_action - target_q.unsqueeze(-1)
        # on truncated (not failed) episodes the bootstrap target is wrong:
        # mask those TD errors out
        truncation = transitions.extras["state_extras"]["truncation"]
        q_error = q_error * (1 - truncation).unsqueeze(-1)
        return 0.5 * torch.mean(torch.square(q_error))

    def actor_loss(policy_params, normalizer_params: Any, q_params, alpha: Tensor,
                   transitions: Transition, generator: torch.Generator) -> Tensor:
        dist_params = policy_network(normalizer_params, policy_params, transitions.observation)
        action = parametric_action_distribution.sample_no_postprocessing(dist_params, generator)
        log_prob = parametric_action_distribution.log_prob(dist_params, action)
        action = parametric_action_distribution.postprocess(action)
        q_action = q_network(normalizer_params, q_params, transitions.observation, action)
        min_q = torch.amin(q_action, dim=-1)
        return torch.mean(alpha * log_prob - min_q)

    return alpha_loss, critic_loss, actor_loss
