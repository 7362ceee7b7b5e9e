"""Hopper: a 2D one-legged robot rewarded for hopping in +x, batch-first.

Counterpart of `brax_tpu/envs/hopper.py`; `Walker2d` (brax_torch/envs/
walker2d.py) is the same env on another scene.  `reset` draws the joint
noise (angles and velocities, +-reset_noise_scale) from a
`torch.Generator` and hands it to `reset_from_noise`, which is
deterministic, so a test can feed the same noise to this env and to the
JAX one.  The observation (11 wide) is the torso's z, its pitch (the Euler
angle about y), the 3 joint angles, the torso's x and z velocity, its
angular velocity about y and the 3 joint velocities.  An env is healthy
while the torso's z and pitch lie inside their ranges; with
terminate_when_unhealthy an unhealthy env is done.  Its scene has one-way
capsule-plane contacts of the leg with the floor.  legacy_spring is taken
and ignored, as the JAX env takes it through **kwargs: the scene has no
spring config.
"""

from __future__ import annotations

import torch

from brax_torch import maths
from brax_torch.envs import base
from brax_torch.envs.assets.hopper import hopper_config
from brax_torch.envs.inverted_pendulum import joint_noise
from brax_torch.sim.types import QP, Tensor

_METRICS = ("reward_forward", "reward_ctrl", "reward_healthy", "x_position", "x_velocity")


class Hopper(base.Env):
    config = staticmethod(hopper_config)

    def __init__(
        self,
        forward_reward_weight=1.0,
        ctrl_cost_weight=1e-3,
        healthy_reward=1.0,
        terminate_when_unhealthy=True,
        healthy_z_range=(0.7, float("inf")),
        healthy_angle_range=(-0.2, 0.2),
        reset_noise_scale=5e-3,
        exclude_current_positions_from_observation=True,
        batch_size=1,
        device="cuda",
        **kwargs,
    ):
        super().__init__(config=self.config(), batch_size=batch_size, device=device)
        self._forward_reward_weight = forward_reward_weight
        self._ctrl_cost_weight = ctrl_cost_weight
        self._healthy_reward = healthy_reward
        self._terminate_when_unhealthy = terminate_when_unhealthy
        self._healthy_z_range = healthy_z_range
        self._healthy_angle_range = healthy_angle_range
        self._reset_noise_scale = reset_noise_scale
        self._exclude_current_positions_from_observation = (
            exclude_current_positions_from_observation
        )

    def reset(self, rng: torch.Generator) -> base.State:
        qpos_noise = joint_noise(self, rng, self._reset_noise_scale)
        return self.reset_from_noise(qpos_noise, joint_noise(self, rng, self._reset_noise_scale))

    def reset_from_noise(self, qpos_noise: Tensor, qvel_noise: Tensor) -> base.State:
        """The reset state for given joint-angle and joint-velocity noise (N, ndof)."""
        qp = self.default_qp(joint_angle=self.default_angle() + qpos_noise,
                             joint_velocity=qvel_noise)
        zero = torch.zeros(qp.pos.shape[0], device=self.device)
        return base.State(qp, self._get_obs(qp), zero, zero, {name: zero for name in _METRICS})

    def step(self, state: base.State, action: Tensor) -> base.State:
        qp, _ = self.sys.step(state.qp, action)
        x_velocity = (qp.pos[:, 0, 0] - state.qp.pos[:, 0, 0]) / self.art.config.dt
        forward_reward = self._forward_reward_weight * x_velocity

        min_z, max_z = self._healthy_z_range
        min_angle, max_angle = self._healthy_angle_range
        z = qp.pos[:, 0, 2]
        ang_y = maths.quat_to_euler(qp.rot[:, 0])[:, 1]
        is_healthy = 1.0 - ((z < min_z) | (z > max_z) | (ang_y > max_angle)
                            | (ang_y < min_angle)).to(z.dtype)
        if self._terminate_when_unhealthy:
            healthy_reward = torch.full_like(z, self._healthy_reward)
            done = 1.0 - is_healthy
        else:
            healthy_reward = self._healthy_reward * is_healthy
            done = torch.zeros_like(z)
        ctrl_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        reward = forward_reward + healthy_reward - ctrl_cost
        metrics = dict(state.metrics, reward_forward=forward_reward, reward_ctrl=-ctrl_cost,
                       reward_healthy=healthy_reward, x_position=qp.pos[:, 0, 0],
                       x_velocity=x_velocity)
        return state.replace(qp=qp, obs=self._get_obs(qp), reward=reward, done=done,
                             metrics=metrics)

    def _get_obs(self, qp: QP) -> Tensor:
        joint_angle, joint_vel = self.sys.joint_angle_vel(qp)
        ang_y = maths.quat_to_euler(qp.rot[:, 0])[:, 1:2]
        xz = [0, 2]
        if self._exclude_current_positions_from_observation:
            qpos = [qp.pos[:, 0, 2:], ang_y, joint_angle]
        else:
            qpos = [qp.pos[:, 0, xz], ang_y, joint_angle]
        qvel = [qp.vel[:, 0, xz], qp.ang[:, 0, 1:2], joint_vel]
        return torch.cat(qpos + qvel, dim=-1)
