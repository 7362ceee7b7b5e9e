"""Halfcheetah: a 2D cheetah rewarded for running in +x, batch-first.

Counterpart of `brax_tpu/envs/halfcheetah.py`.  `reset` draws the joint
noise from a `torch.Generator` and hands it to `reset_from_noise`, which is
deterministic, so a test can feed the same noise to this env and to the JAX
one.  The observation (18 wide) is the torso's z, its rotation's w and y,
the 6 joint angles, the torso's x and z velocity, its angular velocity
about y and the 6 joint velocities.  Its scene has one two-way
capsule-capsule pair (the back foot against the front foot) beside its
capsule-plane contacts with the floor.
"""

from __future__ import annotations

import torch

from brax_torch.envs import base
from brax_torch.envs.assets.half_cheetah import halfcheetah_config, halfcheetah_config_spring
from brax_torch.sim.types import QP, Tensor

_METRICS = ("x_position", "x_velocity", "reward_ctrl", "reward_run")


class Halfcheetah(base.Env):

    def __init__(
        self,
        forward_reward_weight=1.0,
        ctrl_cost_weight=0.1,
        reset_noise_scale=0.1,
        legacy_spring=False,
        exclude_current_positions_from_observation=True,
        batch_size=1,
        device="cuda",
    ):
        config = halfcheetah_config_spring() if legacy_spring else halfcheetah_config()
        super().__init__(config=config, batch_size=batch_size, device=device)
        self._forward_reward_weight = forward_reward_weight
        self._ctrl_cost_weight = ctrl_cost_weight
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
        qp = self.default_qp(joint_angle=self.default_angle() + qpos_noise,
                             joint_velocity=qvel_noise)
        zero = torch.zeros(qp.pos.shape[0], device=self.device)
        return base.State(qp, self._get_obs(qp), zero, zero, {name: zero for name in _METRICS})

    def step(self, state: base.State, action: Tensor) -> base.State:
        qp, _ = self.sys.step(state.qp, action)
        velocity = (qp.pos[:, 0] - state.qp.pos[:, 0]) / self.art.config.dt
        forward_reward = self._forward_reward_weight * velocity[:, 0]
        ctrl_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        metrics = dict(state.metrics, x_position=qp.pos[:, 0, 0], x_velocity=velocity[:, 0],
                       reward_run=forward_reward, reward_ctrl=-ctrl_cost)
        return state.replace(qp=qp, obs=self._get_obs(qp), reward=forward_reward - ctrl_cost,
                             metrics=metrics)

    def _get_obs(self, qp: QP) -> Tensor:
        joint_angle, joint_vel = self.sys.joint_angle_vel(qp)
        xz, wy = [0, 2], [0, 2]
        if self._exclude_current_positions_from_observation:
            qpos = [qp.pos[:, 0, 2:], qp.rot[:, 0, wy], joint_angle]
        else:
            qpos = [qp.pos[:, 0, xz], qp.rot[:, 0, wy], joint_angle]
        qvel = [qp.vel[:, 0, xz], qp.ang[:, 0, 1:2], joint_vel]
        return torch.cat(qpos + qvel, dim=-1)
