"""HumanoidStandup: a humanoid rewarded for standing up from the ground,
batch-first.

Counterpart of `brax_tpu/envs/humanoid_standup.py`.  It shares the humanoid
observation (240 wide, the torso's x and y always left out) and draws its
reset noise in +-0.01.
"""

from __future__ import annotations

import torch

from brax_torch.envs import base
from brax_torch.envs.assets.humanoid_standup import (
    humanoid_standup_config, humanoid_standup_config_spring)
from brax_torch.envs.humanoid import HumanoidLegacy
from brax_torch.sim.types import Tensor


class HumanoidStandup(HumanoidLegacy):

    def __init__(self, legacy_spring=False, batch_size=1, device="cuda", **kwargs):
        config = humanoid_standup_config_spring() if legacy_spring else humanoid_standup_config()
        super().__init__(reset_noise_scale=1e-2, exclude_current_positions_from_observation=True,
                         batch_size=batch_size, device=device, config=config)

    def reset_from_noise(self, qpos_noise: Tensor, qvel_noise: Tensor) -> base.State:
        """The reset state for given joint-angle and joint-velocity noise (N, ndof)."""
        state = super().reset_from_noise(qpos_noise, qvel_noise)
        zero = state.reward
        return state.replace(metrics={"reward_linup": zero, "reward_quadctrl": zero})

    def step(self, state: base.State, action: Tensor) -> base.State:
        qp, _ = self.sys.step(state.qp, action)
        pos_after = qp.pos[:, 0, 2]  # z coordinate of torso
        uph_cost = (pos_after - 0) / self.art.config.dt
        quad_ctrl_cost = 0.01 * torch.sum(torch.square(action), dim=-1)
        obs = self._get_obs(qp, action)
        reward = uph_cost + 1 - quad_ctrl_cost
        metrics = dict(state.metrics, reward_linup=uph_cost, reward_quadctrl=-quad_ctrl_cost)
        return state.replace(qp=qp, obs=obs, reward=reward, metrics=metrics)
