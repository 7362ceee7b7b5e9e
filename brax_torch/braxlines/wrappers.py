"""Env wrappers for skill-conditioned policies.

Counterpart of `brax_tpu/braxlines/wrappers.py`, batch-first.
`SkillWrapper` draws a skill z per env from the discriminator's prior at
reset, appends it to the observations and keeps it over the episode (in
`state.info["skill_z"]`).  The reward stays the env's own: the trainer
relabels the skill reward on collected batches (`brax_torch.braxlines.train`).
"""

from __future__ import annotations

import torch

from brax_torch.braxlines.discriminators import SkillDiscriminator
from brax_torch.envs import base


class SkillWrapper(base.Wrapper):
    def __init__(self, env: base.Env, disc: SkillDiscriminator):
        super().__init__(env)
        self.disc = disc
        # the env's own width, read once (a v1 env reads it from a reset)
        self._env_obs_size = env.observation_size

    @property
    def observation_size(self) -> int:
        return self._env_obs_size + self.disc.z_size

    def reset(self, rng: torch.Generator) -> base.State:
        state = self.env.reset(rng)
        z = self.disc.sample_p(rng, state.obs.shape[0]).to(state.obs.device)
        obs = torch.cat([state.obs, z], dim=-1)
        return state.replace(obs=obs, reward=torch.zeros_like(state.reward),
                             info=dict(state.info, skill_z=z))

    def step(self, state: base.State, action: torch.Tensor) -> base.State:
        z = state.info["skill_z"]
        inner = state.replace(obs=state.obs[..., :self._env_obs_size])
        nstate = self.env.step(inner, action)
        obs = torch.cat([nstate.obs, z], dim=-1)
        return nstate.replace(obs=obs, info=dict(nstate.info, skill_z=z))
