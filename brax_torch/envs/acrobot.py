"""Acrobot: a two-link pendulum swung by a single elbow actuator,
batch-first.

Counterpart of `brax_tpu/envs/acrobot.py`.  `reset` draws the joint noise
(angles and velocities, +-0.01) from a `torch.Generator` and hands it to
`reset_from_noise`, which is deterministic, so a test can feed the same
noise to this env and to the JAX one.  The action is 1 wide: the torque on
the second hinge.  The observation (4 wide) is the two joint angles and
velocities; the reward is an alive bonus of 10 less the squared angles and
1e-3 of the squared joint velocities.  An episode never ends early.
"""

from __future__ import annotations

import torch

from brax_torch.envs import base
from brax_torch.envs.assets.acrobot import acrobot_config
from brax_torch.envs.inverted_pendulum import NOISE, joint_noise
from brax_torch.sim.types import QP, Tensor

_METRICS = ("dist_penalty", "vel_penalty", "alive_bonus", "r_tot")


class Acrobot(base.Env):
    name = "acrobot"

    def __init__(self, legacy_spring=False, batch_size=1, device="cuda", **kwargs):
        # legacy_spring is taken and ignored, as the JAX env ignores it: the
        # scene has no spring config
        super().__init__(config=acrobot_config(), batch_size=batch_size, device=device)

    def reset(self, rng: torch.Generator) -> base.State:
        qpos_noise = joint_noise(self, rng, NOISE)
        return self.reset_from_noise(qpos_noise, joint_noise(self, rng, NOISE))

    def reset_from_noise(self, qpos_noise: Tensor, qvel_noise: Tensor) -> base.State:
        """The reset state for given joint-angle and joint-velocity noise (N, ndof)."""
        qp = self.default_qp(joint_angle=self.default_angle() + qpos_noise,
                             joint_velocity=qvel_noise)
        zero = torch.zeros(qp.pos.shape[0], device=self.device)
        return base.State(qp, self._get_obs(qp), zero, zero, {name: zero for name in _METRICS})

    def step(self, state: base.State, action: Tensor) -> base.State:
        qp, _ = self.sys.step(state.qp, action)
        joint_angle, joint_vel = self.sys.joint_angle_vel(qp)
        dist_penalty = joint_angle[:, 0] ** 2 + joint_angle[:, 1] ** 2
        vel_penalty = 1e-3 * (joint_vel[:, 0] ** 2 + joint_vel[:, 1] ** 2)
        reward = 10.0 - dist_penalty - vel_penalty
        metrics = dict(state.metrics, dist_penalty=dist_penalty, vel_penalty=vel_penalty,
                       r_tot=reward)
        return state.replace(qp=qp, obs=torch.cat([joint_angle, joint_vel], dim=-1),
                             reward=reward, done=torch.zeros_like(state.done), metrics=metrics)

    @property
    def action_size(self) -> int:
        return 1

    def _get_obs(self, qp: QP) -> Tensor:
        return torch.cat(self.sys.joint_angle_vel(qp), dim=-1)
