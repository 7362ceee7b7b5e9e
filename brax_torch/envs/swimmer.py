"""Swimmer: a 3-link swimmer in a viscous fluid rewarded for swimming +x,
batch-first.

Counterpart of `brax_tpu/envs/swimmer.py`.  The fluid is modelled as a drag
force on each link, computed here on the batch from the state before the
step and fed to the scene's three viscosity thrusters: the env appends
their 9 columns to the 2-wide action, so that the physics step reads 11.
`reset` draws the joint noise (+-0.1) and hands it to `reset_from_noise`,
which is deterministic, so a test can feed the same noise to this env and
to the JAX one.  The observation (8 wide) is the torso's angle about z, the
2 joint angles, the torso's x and y velocity, its angular velocity about z
and the 2 joint velocities.
"""

from __future__ import annotations

import math

import torch

from brax_torch import maths
from brax_torch.envs import base
from brax_torch.envs.assets.swimmer import swimmer_config
from brax_torch.envs.inverted_pendulum import joint_noise
from brax_torch.sim.types import QP, Tensor

_METRICS = ("reward_fwd", "reward_ctrl", "x_position", "y_position", "distance_from_origin",
            "x_velocity", "y_velocity", "forward_reward")


class Swimmer(base.Env):

    def __init__(
        self,
        forward_reward_weight=1.0,
        ctrl_cost_weight=1e-4,
        reset_noise_scale=0.1,
        exclude_current_positions_from_observation=True,
        batch_size=1,
        device="cuda",
        **kwargs,
    ):
        super().__init__(config=swimmer_config(), batch_size=batch_size, device=device)
        self._forward_reward_weight = forward_reward_weight
        self._ctrl_cost_weight = ctrl_cost_weight
        self._reset_noise_scale = reset_noise_scale
        self._exclude_current_positions_from_observation = (
            exclude_current_positions_from_observation
        )

        # the drag model, in float32 as the JAX env computes it
        viscosity = 0.1
        density = 10.0
        inertia = (0.1727875959474387, 3.5709436495803999, 3.5709436495803999)
        body_mass = 34.557519189487735
        inertia = torch.tensor(
            [
                inertia[1] + inertia[2] - inertia[0],
                inertia[0] + inertia[1] - inertia[2],
                inertia[0] + inertia[2] - inertia[1],
            ],
            device=self.device,
        )
        inertia = torch.sqrt(inertia / (body_mass * 6))
        self._spherical_drag = -3 * math.pi * torch.mean(inertia) * viscosity
        self._fix_drag = 0.5 * density * torch.stack(
            [inertia[1] * inertia[2], inertia[0] * inertia[2], inertia[0] * inertia[1]]
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
        force = self._get_viscous_force(state.qp)
        act = torch.cat([action, force.reshape(force.shape[0], -1)], dim=-1)
        qp, _ = self.sys.step(state.qp, act)

        com_before = self._center_of_mass(state.qp)
        com_after = self._center_of_mass(qp)
        velocity = (com_after - com_before) / self.art.config.dt
        forward_reward = self._forward_reward_weight * velocity[:, 0]
        ctrl_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)

        reward = forward_reward - ctrl_cost
        metrics = dict(
            state.metrics,
            reward_fwd=forward_reward,
            reward_ctrl=-ctrl_cost,
            x_position=com_after[:, 0],
            y_position=com_after[:, 1],
            distance_from_origin=torch.linalg.vector_norm(qp.pos[:, 0], dim=-1),
            x_velocity=velocity[:, 0],
            y_velocity=velocity[:, 1],
            forward_reward=forward_reward,
        )
        return state.replace(qp=qp, obs=self._get_obs(qp), reward=reward, metrics=metrics)

    @property
    def action_size(self) -> int:
        return 2

    def _get_viscous_force(self, qp: QP) -> Tensor:
        """(N, 3, 3): each link's drag, clipped to +-5.  As in the JAX env, the
        quadratic term subtracts the diagonal of the links' local terms (link
        k's axis k) from every link."""
        vel = qp.vel[:, :-1]
        rot = qp.rot[:, :-1]
        force = vel * self._spherical_drag
        vel_local = maths.inv_rotate(vel, rot)
        quadratic = self._fix_drag * torch.abs(vel_local) * vel_local
        force = force - torch.diagonal(quadratic, dim1=-2, dim2=-1)[:, None, :]
        force = maths.rotate(force, rot)
        return torch.clamp(force, -5.0, 5.0)

    def _get_obs(self, qp: QP) -> Tensor:
        joint_angle, joint_vel = self.sys.joint_angle_vel(qp)
        ang_z = maths.quat_to_euler(qp.rot[:, 0])[:, 2:3]
        if self._exclude_current_positions_from_observation:
            qpos = [ang_z, joint_angle]
        else:
            qpos = [qp.pos[:, 0, :2], ang_z, joint_angle]
        qvel = [qp.vel[:, 0, :2], qp.ang[:, 0, 2:], joint_vel]
        return torch.cat(qpos + qvel, dim=-1)

    def _center_of_mass(self, qp: QP) -> Tensor:
        mass, pos = self.sys.mass[:-1], qp.pos[:, :-1]
        return torch.sum(mass[:, None] * pos, dim=-2) / torch.sum(mass)
