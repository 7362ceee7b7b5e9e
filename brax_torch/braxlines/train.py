"""Training entry points for skill discovery and adversarial IRL.

Counterpart of `brax_tpu/braxlines/train.py`.  Both ride the port's PPO
trainer through its auxiliary-learner hooks: the discriminator trains on
each collected batch (`extra_loss_fn`), and the batch's rewards are
relabelled from it (`reward_relabel_fn`) before the policy update.
`environment` is what `ppo.train` takes: an env name of `brax_torch.envs`
or a factory `(batch_size, device) -> Env` of the unwrapped env.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from brax_torch import envs
from brax_torch.braxlines.discriminators import IRLDiscriminator, SkillDiscriminator
from brax_torch.braxlines.wrappers import SkillWrapper
from brax_torch.training.agents.ppo import train as ppo


def _disc_generator(seed: int, device) -> torch.Generator:
    """The discriminator's initial draw (the JAX package's PRNGKey(seed + 1))."""
    return torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence(seed + 1).generate_state(1)[0]))


def train_vgcrl(environment: Union[str, envs.EnvFactory], disc: SkillDiscriminator,
                env_reward_multiplier: float = 0.0, seed: int = 0, device="cuda",
                **ppo_kwargs):
    """Skill discovery (the VGCRL/DIAYN family).

    The policy sees obs ++ z; its reward is log q(z|s) from the
    discriminator, which trains at the same time to predict z from the
    visited states.  Returns (make_policy, (normalizer, policy, disc_params),
    metrics).
    """
    make_env = envs.factory(environment)
    obs_size = None

    def skill_env(batch_size, dev):
        nonlocal obs_size
        inner = make_env(batch_size, dev)
        obs_size = inner.observation_size
        return SkillWrapper(inner, disc)

    def extra_loss_fn(disc_params, transitions, generator):
        obs = transitions.observation
        return disc.loss(disc_params, obs[..., :obs_size], obs[..., obs_size:])

    def reward_relabel_fn(disc_params, transitions):
        obs = transitions.next_observation
        r = disc.reward(disc_params, obs[..., :obs_size], obs[..., obs_size:])
        return r + env_reward_multiplier * transitions.reward

    disc_params = disc.init(_disc_generator(seed, disc.device))
    return ppo.train(skill_env, seed=seed, device=device, extra_params=disc_params,
                     extra_loss_fn=extra_loss_fn, reward_relabel_fn=reward_relabel_fn,
                     **ppo_kwargs)


def train_irl(environment: Union[str, envs.EnvFactory], disc: IRLDiscriminator,
              env_reward_multiplier: float = 0.0, seed: int = 0, device="cuda",
              **ppo_kwargs):
    """Adversarial imitation / state-marginal matching (GAIL/AIRL/FAIRL).

    The discriminator separates `disc.target_data` from on-policy data; the
    policy maximises the discriminator's reward.  Returns (make_policy,
    (normalizer, policy, disc_params), metrics).
    """
    assert disc.target_data is not None, "set disc.target_data first"
    # early discriminator rewards are near-constant; advantage normalisation
    # would amplify their noise into full-scale updates, so it defaults off
    ppo_kwargs.setdefault("normalize_advantage", False)

    def extra_loss_fn(disc_params, transitions, generator):
        data = disc.obs_act2data(transitions.observation, transitions.action)
        return disc.loss(disc_params, data.reshape(-1, data.shape[-1]), generator)

    def reward_relabel_fn(disc_params, transitions):
        data = disc.obs_act2data(transitions.observation, transitions.action)
        return disc.reward(disc_params, data) + env_reward_multiplier * transitions.reward

    disc_params = disc.init(_disc_generator(seed, disc.device))
    return ppo.train(environment, seed=seed, device=device, extra_params=disc_params,
                     extra_loss_fn=extra_loss_fn, reward_relabel_fn=reward_relabel_fn,
                     **ppo_kwargs)
