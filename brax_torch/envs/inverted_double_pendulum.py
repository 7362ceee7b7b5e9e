"""InvertedDoublePendulum: a cart balancing a two-link pole, batch-first.

Counterpart of `brax_tpu/envs/inverted_double_pendulum.py`.  `reset` draws
the joint noise (+-0.01) and hands it to `reset_from_noise`, as
InvertedPendulum does.  The action is 1 wide (the cart's thruster, its
columns clipped to that width).  The observation (8 wide) is the cart's x,
the sines and cosines of the two joint angles, the cart's x velocity and
the joint velocities.  The reward is 10 less the tip's distance from
(0, 2) in x-z (x weighted 0.01) and the joint velocities' penalty; an
episode is done when the tip falls to z <= 1.
"""

from __future__ import annotations

import torch

from brax_torch.envs import base
from brax_torch.envs.assets.inverted_double_pendulum import (
    inverted_double_pendulum_config, inverted_double_pendulum_config_spring)
from brax_torch.envs.inverted_pendulum import NOISE, joint_noise
from brax_torch.sim.types import QP, Tensor


class InvertedDoublePendulum(base.Env):

    def __init__(self, legacy_spring=False, batch_size=1, device="cuda", **kwargs):
        config = (inverted_double_pendulum_config_spring() if legacy_spring
                  else inverted_double_pendulum_config())
        super().__init__(config=config, batch_size=batch_size, device=device)
        self._tip = torch.tensor([0.0, 0.0, 0.3], device=self.device)

    def reset(self, rng: torch.Generator) -> base.State:
        qpos_noise = joint_noise(self, rng, NOISE)
        return self.reset_from_noise(qpos_noise, joint_noise(self, rng, NOISE))

    def reset_from_noise(self, qpos_noise: Tensor, qvel_noise: Tensor) -> base.State:
        """The reset state for given joint-angle and joint-velocity noise (N, ndof)."""
        qp = self.default_qp(joint_angle=self.default_angle() + qpos_noise,
                             joint_velocity=qvel_noise)
        zero = torch.zeros(qp.pos.shape[0], device=self.device)
        return base.State(qp, self._get_obs(qp, *self.sys.joint_angle_vel(qp)), zero, zero, {})

    def step(self, state: base.State, action: Tensor) -> base.State:
        qp, _ = self.sys.step(state.qp, action)
        joint_angle, joint_vel = self.sys.joint_angle_vel(qp)

        pole = QP(pos=qp.pos[:, 2], rot=qp.rot[:, 2], vel=qp.vel[:, 2], ang=qp.ang[:, 2])
        tip_pos, _ = pole.to_world(self._tip)
        x, y = tip_pos[:, 0], tip_pos[:, 2]
        dist_penalty = 0.01 * x**2 + (y - 2) ** 2
        v1, v2 = joint_vel[:, 0], joint_vel[:, 1]
        vel_penalty = 1e-3 * v1**2 + 5e-3 * v2**2
        alive_bonus = 10.0

        reward = alive_bonus - dist_penalty - vel_penalty
        done = torch.where(y <= 1, 1.0, 0.0)
        obs = self._get_obs(qp, joint_angle, joint_vel)
        return state.replace(qp=qp, obs=obs, reward=reward, done=done)

    @property
    def action_size(self) -> int:
        return 1

    def _get_obs(self, qp: QP, joint_angle: Tensor, joint_vel: Tensor) -> Tensor:
        qpos = [qp.pos[:, 0, :1], torch.sin(joint_angle), torch.cos(joint_angle)]
        qvel = [qp.vel[:, 0, :1], joint_vel]
        return torch.cat(qpos + qvel, dim=-1)
