"""Ant: a 4-legged robot rewarded for running in +x, batch-first.

Counterpart of `brax_tpu/envs/ant.py`.  `reset` draws the joint noise from a
`torch.Generator` and hands it to `reset_from_noise`, which is deterministic,
so a test can feed the same noise to this env and to the JAX one.
"""

from __future__ import annotations

import torch

from brax_torch.envs import base
from brax_torch.envs.assets.ant import ant_config, ant_config_spring
from brax_torch.sim.types import QP, Info, Tensor


class Ant(base.Env):

    def __init__(
        self,
        ctrl_cost_weight=0.5,
        use_contact_forces=False,
        contact_cost_weight=5e-4,
        healthy_reward=1.0,
        terminate_when_unhealthy=True,
        healthy_z_range=(0.2, 1.0),
        reset_noise_scale=0.1,
        exclude_current_positions_from_observation=True,
        legacy_spring=False,
        batch_size=1,
        device="cuda",
    ):
        config = ant_config_spring() if legacy_spring else ant_config()
        super().__init__(config=config, batch_size=batch_size, device=device)
        self._ctrl_cost_weight = ctrl_cost_weight
        self._use_contact_forces = use_contact_forces
        self._contact_cost_weight = contact_cost_weight
        self._healthy_reward = healthy_reward
        self._terminate_when_unhealthy = terminate_when_unhealthy
        self._healthy_z_range = healthy_z_range
        self._reset_noise_scale = reset_noise_scale
        self._exclude_current_positions_from_observation = (
            exclude_current_positions_from_observation
        )

    def reset(self, rng: torch.Generator) -> base.State:
        shape = (self.batch_size, self.sys.num_joint_dof)
        low, hi = -self._reset_noise_scale, self._reset_noise_scale
        noise = lambda: torch.rand(shape, generator=rng, device=self.device) * (hi - low) + low
        qpos_noise = noise()
        return self.reset_from_noise(qpos_noise, noise())

    def reset_from_noise(self, qpos_noise: Tensor, qvel_noise: Tensor) -> base.State:
        """The reset state for given joint-angle and joint-velocity noise (N, ndof)."""
        qpos = self.default_angle() + qpos_noise
        qp = self.default_qp(joint_angle=qpos, joint_velocity=qvel_noise)
        obs = self._get_obs(qp, self.sys.info(qp))
        zero = torch.zeros(qpos.shape[0], device=self.device)
        metrics = {
            name: zero
            for name in (
                "reward_forward", "reward_survive", "reward_ctrl", "reward_contact",
                "x_position", "y_position", "distance_from_origin", "x_velocity",
                "y_velocity", "forward_reward",
            )
        }
        return base.State(qp, obs, zero, zero, metrics)

    def step(self, state: base.State, action: Tensor) -> base.State:
        qp, info = self.sys.step(state.qp, action)

        velocity = (qp.pos[:, 0] - state.qp.pos[:, 0]) / self.art.config.dt
        forward_reward = velocity[:, 0]

        min_z, max_z = self._healthy_z_range
        z = qp.pos[:, 0, 2]
        is_healthy = torch.where((z < min_z) | (z > max_z), 0.0, 1.0)
        if self._terminate_when_unhealthy:
            healthy_reward = torch.full_like(z, self._healthy_reward)
        else:
            healthy_reward = self._healthy_reward * is_healthy
        ctrl_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        contact_cost = self._contact_cost_weight * torch.sum(
            torch.square(torch.clamp(info.contact.vel, -1, 1)), dim=(-2, -1)
        )
        obs = self._get_obs(qp, info)
        reward = forward_reward + healthy_reward - ctrl_cost - contact_cost
        if self._terminate_when_unhealthy:
            done = 1.0 - is_healthy
        else:
            done = torch.zeros_like(is_healthy)
        metrics = dict(
            state.metrics,
            reward_forward=forward_reward,
            reward_survive=healthy_reward,
            reward_ctrl=-ctrl_cost,
            reward_contact=-contact_cost,
            x_position=qp.pos[:, 0, 0],
            y_position=qp.pos[:, 0, 1],
            distance_from_origin=torch.linalg.vector_norm(qp.pos[:, 0], dim=-1),
            x_velocity=velocity[:, 0],
            y_velocity=velocity[:, 1],
            forward_reward=forward_reward,
        )
        return state.replace(qp=qp, obs=obs, reward=reward, done=done, metrics=metrics)

    def _get_obs(self, qp: QP, info: Info) -> Tensor:
        joint_angle, joint_vel = self.sys.joint_angle_vel(qp)
        if self._exclude_current_positions_from_observation:
            qpos = [qp.pos[:, 0, 2:], qp.rot[:, 0], joint_angle]
        else:
            qpos = [qp.pos[:, 0], qp.rot[:, 0], joint_angle]
        qvel = [qp.vel[:, 0], qp.ang[:, 0], joint_vel]
        if self._use_contact_forces:
            n = qp.pos.shape[0]
            cfrc = [
                torch.clamp(info.contact.vel, -1, 1).reshape(n, -1),
                torch.clamp(info.contact.ang, -1, 1).reshape(n, -1),
            ]
        else:
            cfrc = []
        return torch.cat(qpos + qvel + cfrc, dim=-1)
