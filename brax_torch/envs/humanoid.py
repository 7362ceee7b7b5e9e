"""Humanoid: a bipedal humanoid rewarded for walking in +x, batch-first.

Counterpart of `brax_tpu/envs/humanoid.py`, in its two variants:
`Humanoid`, the fork's humanoid_new (healthy z 1.1-2.0), which the registry
names "humanoid", and `HumanoidLegacy` (healthy z 0.8-2.1).  `reset` draws
the joint noise from a `torch.Generator` and hands it to `reset_from_noise`,
which is deterministic, so a test can feed the same noise to this env and
to the JAX one.

The observation (240 wide) is qpos (22) and qvel (23) with the 17 free
joint dofs, the CoM-frame inertia (99) and velocity (66) blocks of the 11
bodies before the floor, and the actuator torques (30: 10 actuators x 3
dofs).  That last block gathers the action as the JAX env does, with
`jnp.take(..., mode="clip")`, so a padded dof's -1 index reads column 0;
the port keeps that, unmasked.
"""

from __future__ import annotations

import numpy as np
import torch

from brax_torch import maths
from brax_torch.envs import base
from brax_torch.envs.assets.humanoid import humanoid_config
from brax_torch.envs.assets.humanoid_new import humanoid_new_config
from brax_torch.sim.config import Config
from brax_torch.sim.types import QP, Tensor

_METRICS = ("forward_reward", "reward_linvel", "reward_quadctrl", "reward_alive", "x_position",
            "y_position", "distance_from_origin", "x_velocity", "y_velocity")


def _no_legacy_spring(legacy_spring: bool, name: str) -> None:
    if legacy_spring:
        raise NotImplementedError(
            f"legacy_spring {name} is not ported yet (see ROADMAP.md, queue A item 6)")


class HumanoidLegacy(base.Env):
    """The pre-fork humanoid."""

    def __init__(
        self,
        forward_reward_weight=1.25,
        ctrl_cost_weight=0.1,
        healthy_reward=5.0,
        terminate_when_unhealthy=True,
        healthy_z_range=(0.8, 2.1),
        reset_noise_scale=1e-2,
        exclude_current_positions_from_observation=True,
        legacy_spring=False,
        batch_size=1,
        device="cuda",
        config: Config = None,
    ):
        _no_legacy_spring(legacy_spring, "humanoid")
        super().__init__(config=config or humanoid_config(), batch_size=batch_size,
                         device=device)
        self._forward_reward_weight = forward_reward_weight
        self._ctrl_cost_weight = ctrl_cost_weight
        self._healthy_reward = healthy_reward
        self._terminate_when_unhealthy = terminate_when_unhealthy
        self._healthy_z_range = healthy_z_range
        self._reset_noise_scale = reset_noise_scale
        self._exclude_current_positions_from_observation = (
            exclude_current_positions_from_observation
        )
        # the actuators' action columns as jnp.take(mode="clip") reads them
        # (a padded dof's -1 reads column 0), and each column's strength
        n_act = self.action_size
        self._qfrc_index = [
            torch.as_tensor(np.clip(a.act_index, 0, n_act - 1).reshape(-1), device=self.device)
            for a in self.sys.actuator_groups]
        self._qfrc_strength = [torch.repeat_interleave(a.strength, a.act_index.shape[-1])
                               for a in self.sys.actuator_groups]

    def reset(self, rng: torch.Generator) -> base.State:
        qpos_noise = self._noise(rng)
        return self.reset_from_noise(qpos_noise, self._noise(rng))

    def _reset_qp(self, qpos_noise: Tensor, qvel_noise: Tensor) -> QP:
        qpos = self.default_angle() + qpos_noise
        return self.default_qp(joint_angle=qpos, joint_velocity=qvel_noise)

    def reset_from_noise(self, qpos_noise: Tensor, qvel_noise: Tensor) -> base.State:
        """The reset state for given joint-angle and joint-velocity noise (N, ndof)."""
        qp = self._reset_qp(qpos_noise, qvel_noise)
        n = qp.pos.shape[0]
        obs = self._get_obs(qp, torch.zeros((n, self.action_size), device=self.device))
        zero = torch.zeros(n, device=self.device)
        return base.State(qp, obs, zero, zero, {name: zero for name in _METRICS})

    def step(self, state: base.State, action: Tensor) -> base.State:
        qp, _ = self.sys.step(state.qp, action)

        com_before = self._center_of_mass(state.qp)
        com_after = self._center_of_mass(qp)
        velocity = (com_after - com_before) / self.art.config.dt
        forward_reward = self._forward_reward_weight * velocity[:, 0]

        min_z, max_z = self._healthy_z_range
        z = qp.pos[:, 0, 2]
        is_healthy = torch.where((z < min_z) | (z > max_z), 0.0, 1.0)
        if self._terminate_when_unhealthy:
            healthy_reward = torch.full_like(z, self._healthy_reward)
        else:
            healthy_reward = self._healthy_reward * is_healthy
        ctrl_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        obs = self._get_obs(qp, action)
        reward = forward_reward + healthy_reward - ctrl_cost
        if self._terminate_when_unhealthy:
            done = 1.0 - is_healthy
        else:
            done = torch.zeros_like(is_healthy)
        metrics = dict(
            state.metrics,
            forward_reward=forward_reward,
            reward_linvel=forward_reward,
            reward_quadctrl=-ctrl_cost,
            reward_alive=healthy_reward,
            x_position=com_after[:, 0],
            y_position=com_after[:, 1],
            distance_from_origin=torch.linalg.vector_norm(com_after, dim=-1),
            x_velocity=velocity[:, 0],
            y_velocity=velocity[:, 1],
        )
        return state.replace(qp=qp, obs=obs, reward=reward, done=done, metrics=metrics)

    def _get_obs(self, qp: QP, action: Tensor) -> Tensor:
        """qpos/qvel + CoM inertia/velocity blocks + actuator torques."""
        n = qp.pos.shape[0]
        joint_angle, joint_vel = self.sys.joint_angle_vel(qp)
        if self._exclude_current_positions_from_observation:
            qpos = [qp.pos[:, 0, 2:], qp.rot[:, 0], joint_angle]
        else:
            qpos = [qp.pos[:, 0], qp.rot[:, 0], joint_angle]
        qvel = [qp.vel[:, 0], qp.ang[:, 0], joint_vel]

        com = self._center_of_mass(qp)
        mass = self.sys.mass
        mass_sum = torch.sum(mass[:-1])
        inertia_diag = 1.0 / self.sys.inv_inertia  # (nb, 3)

        d = qp.pos - com[:, None]  # (N, nb, 3)
        d_norm_sq = torch.sum(d * d, dim=-1)  # (N, nb)
        eye = torch.eye(3, device=self.device)
        com_inr = mass[:, None, None] * eye * d_norm_sq[..., None, None]
        com_inr = com_inr + (torch.diag_embed(inertia_diag) - d[..., :, None] * d[..., None, :])
        com_vel = mass[:, None] * qp.vel / mass_sum
        com_ang = maths.cross(d, qp.vel) / (1e-7 + d_norm_sq[..., None])

        cinert = [com_inr[:, :-1].reshape(n, -1)]
        cvel = [com_vel[:, :-1].reshape(n, -1), com_ang[:, :-1].reshape(n, -1)]
        qfrc_actuator = [action[:, idx] * strength
                         for idx, strength in zip(self._qfrc_index, self._qfrc_strength)]
        return torch.cat(qpos + qvel + cinert + cvel + qfrc_actuator, dim=-1)

    def _center_of_mass(self, qp: QP) -> Tensor:
        mass, pos = self.sys.mass[:-1], qp.pos[:, :-1]
        return torch.sum(mass[:, None] * pos, dim=-2) / torch.sum(mass)

    def _noise(self, rng: torch.Generator) -> Tensor:
        low, hi = -self._reset_noise_scale, self._reset_noise_scale
        shape = (self.batch_size, self.sys.num_joint_dof)
        return torch.rand(shape, generator=rng, device=self.device) * (hi - low) + low


class Humanoid(HumanoidLegacy):
    """The fork's humanoid_new: healthy z 1.1-2.0."""

    def __init__(
        self,
        forward_reward_weight=1.25,
        ctrl_cost_weight=0.1,
        healthy_reward=5.0,
        terminate_when_unhealthy=True,
        healthy_z_range=(1.1, 2.0),
        reset_noise_scale=1e-2,
        exclude_current_positions_from_observation=True,
        batch_size=1,
        device="cuda",
        **kwargs,
    ):
        super().__init__(
            forward_reward_weight=forward_reward_weight, ctrl_cost_weight=ctrl_cost_weight,
            healthy_reward=healthy_reward, terminate_when_unhealthy=terminate_when_unhealthy,
            healthy_z_range=healthy_z_range, reset_noise_scale=reset_noise_scale,
            exclude_current_positions_from_observation=(
                exclude_current_positions_from_observation),
            batch_size=batch_size, device=device, config=humanoid_new_config())
        self.target_radius = 0.1
        self.target_distance = 10
        # the scene has no Target body (it is commented out of the reference
        # config), so target_idx is None, as in the JAX env
        self.target_idx = self.art.body_index.get("Target")
        self.torso_idx = self.art.body_index["torso"]
