"""PPO loss: GAE + clipped surrogate + value + entropy.

Counterpart of `brax_tpu/training/agents/ppo/losses.py`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from brax_torch.training import types
from brax_torch.training.agents.ppo import networks as ppo_networks

Tensor = torch.Tensor


class PPONetworkParams(NamedTuple):
    """Learner parameters: name -> tensor mappings of the two networks."""

    policy: Dict[str, Tensor]
    value: Dict[str, Tensor]


@torch.no_grad()
def compute_gae(
    truncation: Tensor,
    termination: Tensor,
    rewards: Tensor,
    values: Tensor,
    bootstrap_value: Tensor,
    lambda_: float = 1.0,
    discount: float = 0.99,
) -> Tuple[Tensor, Tensor]:
    """Generalized Advantage Estimation over [T, B] tensors (reverse loop
    over T); both outputs are detached."""
    truncation_mask = 1 - truncation
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rewards + discount * (1 - termination) * values_t_plus_1 - values
    deltas = deltas * truncation_mask

    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v_xs = [None] * truncation_mask.shape[0]
    for t in range(truncation_mask.shape[0] - 1, -1, -1):
        acc = deltas[t] + discount * (1 - termination[t]) * truncation_mask[t] * lambda_ * acc
        vs_minus_v_xs[t] = acc
    vs = torch.stack(vs_minus_v_xs) + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    advantages = (rewards + discount * (1 - termination) * vs_t_plus_1 - values) * truncation_mask
    return vs, advantages


def compute_ppo_loss(
    params: PPONetworkParams,
    normalizer_params: Any,
    data: types.Transition,
    generator: torch.Generator,
    ppo_network: ppo_networks.PPONetworks,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    reward_scaling: float = 1.0,
    gae_lambda: float = 0.95,
    clipping_epsilon: float = 0.3,
    normalize_advantage: bool = True,
) -> Tuple[Tensor, types.Metrics]:
    """Clipped-surrogate PPO loss over [B, T] transition batches."""
    parametric_action_distribution = ppo_network.parametric_action_distribution
    policy_apply = ppo_network.policy_network
    value_apply = ppo_network.value_network

    # time dimension first
    data = types.tree_map(lambda x: torch.swapaxes(x, 0, 1), data)
    policy_logits = policy_apply(normalizer_params, params.policy, data.observation)
    baseline = value_apply(normalizer_params, params.value, data.observation)
    bootstrap_value = value_apply(normalizer_params, params.value, data.next_observation[-1])

    rewards = data.reward * reward_scaling
    truncation = data.extras["state_extras"]["truncation"]
    termination = (1 - data.discount) * (1 - truncation)

    target_action_log_probs = parametric_action_distribution.log_prob(
        policy_logits, data.extras["policy_extras"]["raw_action"])
    behaviour_action_log_probs = data.extras["policy_extras"]["log_prob"]

    vs, advantages = compute_gae(
        truncation=truncation,
        termination=termination,
        rewards=rewards,
        values=baseline,
        bootstrap_value=bootstrap_value,
        lambda_=gae_lambda,
        discount=discounting,
    )
    if normalize_advantage:
        # jnp.std is the population std (ddof 0)
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
    rho_s = torch.exp(target_action_log_probs - behaviour_action_log_probs)

    surrogate_loss1 = rho_s * advantages
    surrogate_loss2 = torch.clamp(rho_s, 1 - clipping_epsilon, 1 + clipping_epsilon) * advantages
    policy_loss = -torch.mean(torch.minimum(surrogate_loss1, surrogate_loss2))

    v_error = vs - baseline
    v_loss = torch.mean(v_error * v_error) * 0.5 * 0.5

    entropy = torch.mean(parametric_action_distribution.entropy(policy_logits, generator))
    entropy_loss = entropy_cost * -entropy

    total_loss = policy_loss + v_loss + entropy_loss
    return total_loss, {
        "total_loss": total_loss,
        "policy_loss": policy_loss,
        "v_loss": v_loss,
        "entropy_loss": entropy_loss,
    }
