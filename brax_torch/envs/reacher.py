"""Reacher: a 2-link arm reaching a random target, batch-first.

Counterpart of `brax_tpu/envs/reacher.py`.  `reset` draws the joint noise
(angles +-0.1, velocities +-0.005) and the target's two uniform draws from
a `torch.Generator` and hands them to `reset_from_noise`, which is
deterministic, so a test can feed the same draws to this env and to the
JAX one.  The target lies in a circle of radius 0.2, 0.01 above the floor.
The observation (11 wide) is the cosines and sines of the joint angles, the
target's x and y, the arm tip's x and y velocity and the vector from the
target to the tip; the reward is minus the tip's distance to the target and
the action's squared size.
"""

from __future__ import annotations

import math

import torch

from brax_torch import maths
from brax_torch.envs import base
from brax_torch.envs.assets.reacher import reacher_config, reacher_config_spring
from brax_torch.sim.config import Config
from brax_torch.sim.types import QP, Tensor

_METRICS = ("reward_dist", "reward_ctrl")


class Reacher(base.Env):
    name = "reacher"
    metric_names = _METRICS

    def __init__(self, legacy_spring=False, batch_size=1, device="cuda", **kwargs):
        super().__init__(config=self.scene(legacy_spring), batch_size=batch_size, device=device)
        self._target_idx = self.art.body_index["target"]
        self._arm_idx = self.art.body_index["body1"]
        self._tip = torch.tensor([0.11, 0.0, 0.0], device=self.device)

    @staticmethod
    def scene(legacy_spring: bool = False) -> Config:
        return reacher_config_spring() if legacy_spring else reacher_config()

    def reset(self, rng: torch.Generator) -> base.State:
        n, nd = self.batch_size, self.sys.num_joint_dof
        uniform = lambda shape, scale: (
            torch.rand(shape, generator=rng, device=self.device) * (2 * scale) - scale)
        qpos_noise = uniform((n, nd), 0.1)
        qvel_noise = uniform((n, nd), 0.005)
        target_draws = torch.rand((n, 2), generator=rng, device=self.device)
        return self.reset_from_noise(qpos_noise, qvel_noise, target_draws)

    def reset_from_noise(self, qpos_noise: Tensor, qvel_noise: Tensor,
                         target_draws: Tensor) -> base.State:
        """The reset state for given joint-angle and joint-velocity noise
        (N, ndof) and the target's draws (N, 2), uniform in [0, 1): its
        distance from the origin and its angle."""
        qp = self.default_qp(joint_angle=self.default_angle() + qpos_noise,
                             joint_velocity=qvel_noise)
        pos = qp.pos.clone()
        pos[:, self._target_idx] = self._target(target_draws)
        qp = QP(pos=pos, rot=qp.rot, vel=qp.vel, ang=qp.ang)
        zero = torch.zeros(qp.pos.shape[0], device=self.device)
        return base.State(qp, self._get_obs(qp), zero, zero,
                          {name: zero for name in self.metric_names})

    def _target(self, draws: Tensor) -> Tensor:
        """A target in a circle of radius 0.2, slightly above the xy plane."""
        dist = 0.2 * draws[:, 0]
        ang = math.pi * 2.0 * draws[:, 1]
        return torch.stack([dist * torch.cos(ang), dist * torch.sin(ang),
                            torch.full_like(dist, 0.01)], dim=-1)

    def step(self, state: base.State, action: Tensor) -> base.State:
        qp, _ = self.sys.step(state.qp, action)
        obs = self._get_obs(qp)
        reward_dist = -maths.safe_norm(obs[:, -3:])
        reward_ctrl = -torch.square(action).sum(dim=-1)
        metrics = dict(state.metrics, reward_dist=reward_dist, reward_ctrl=reward_ctrl)
        return state.replace(qp=qp, obs=obs, reward=reward_dist + reward_ctrl, metrics=metrics)

    def _get_obs(self, qp: QP) -> Tensor:
        """Egocentric observation of target and arm body."""
        joint_angle, _ = self.sys.joint_angle_vel(qp)
        a = self._arm_idx
        arm = QP(pos=qp.pos[:, a], rot=qp.rot[:, a], vel=qp.vel[:, a], ang=qp.ang[:, a])
        tip_pos, tip_vel = arm.to_world(self._tip)
        target = qp.pos[:, self._target_idx]
        return torch.cat([torch.cos(joint_angle), torch.sin(joint_angle), target[:, :2],
                          tip_vel[:, :2], tip_pos - target], dim=-1)
