"""Ant on the v2 generalized pipeline, batch-first.

Counterpart of `brax_tpu/v2/envs/ant.py`: forward-progress reward, healthy
z-range termination, control cost; obs = q[2:] and qd (27 wide).  `reset`
draws its noise from a `torch.Generator` and hands it to
`reset_from_noise`, which is deterministic, so a test can feed one noise
to this env and to the JAX one.
"""

from __future__ import annotations

import torch

from brax_torch import maths
from brax_torch.v2 import mjcf
from brax_torch.v2.base import Tensor
from brax_torch.v2.envs import assets, env


class Ant(env.PipelineEnv):
    """Quadruped running toward +x."""

    def __init__(self, ctrl_cost_weight=0.5, use_contact_forces=False, contact_cost_weight=5e-4,
                 healthy_reward=1.0, terminate_when_unhealthy=True, healthy_z_range=(0.2, 1.0),
                 contact_force_range=(-1.0, 1.0), reset_noise_scale=0.1,
                 exclude_current_positions_from_observation=True, backend="generalized",
                 n_frames=5, batch_size=1, device="cuda", use_kernel=True):
        if use_contact_forces:
            raise NotImplementedError("use_contact_forces not implemented")
        super().__init__(sys=mjcf.loads(assets.ant_xml()), backend=backend, n_frames=n_frames,
                         batch_size=batch_size, device=device, use_kernel=use_kernel)
        self._ctrl_cost_weight = ctrl_cost_weight
        self._contact_cost_weight = contact_cost_weight
        self._healthy_reward = healthy_reward
        self._terminate_when_unhealthy = terminate_when_unhealthy
        self._healthy_z_range = healthy_z_range
        self._contact_force_range = contact_force_range
        self._reset_noise_scale = reset_noise_scale
        self._exclude_current_positions_from_observation = (
            exclude_current_positions_from_observation)

    def reset(self, rng: torch.Generator) -> env.State:
        n, s = self.batch_size, self._reset_noise_scale
        q_noise = torch.rand((n, self.sys.q_size()), generator=rng, device=self.device) * 2 * s - s
        qd = s * torch.randn((n, self.sys.qd_size()), generator=rng, device=self.device)
        return self.reset_from_noise(q_noise, qd)

    def reset_from_noise(self, q_noise: Tensor, qd: Tensor) -> env.State:
        """The reset state at q = init_q + q_noise (N, nq) and velocity qd (N, nd)."""
        pipeline_state = self.pipeline_init(self.sys.init_q + q_noise, qd)
        zero = torch.zeros((self.batch_size,), device=self.device)
        metrics = {k: zero for k in (
            "reward_forward", "reward_survive", "reward_ctrl", "reward_contact", "x_position",
            "y_position", "distance_from_origin", "x_velocity", "y_velocity", "forward_reward")}
        return env.State(pipeline_state, self._get_obs(pipeline_state), zero, zero, metrics)

    def step(self, state: env.State, action: Tensor) -> env.State:
        pipeline_state0 = state.pipeline_state
        pipeline_state = self.pipeline_step(pipeline_state0, action)
        torso = pipeline_state.x.pos[:, 0]
        velocity = (torso - pipeline_state0.x.pos[:, 0]) / self.dt
        forward_reward = velocity[:, 0]
        min_z, max_z = self._healthy_z_range
        one, zero = torch.ones_like(forward_reward), torch.zeros_like(forward_reward)
        is_healthy = torch.where(torso[:, 2] < min_z, zero, one)
        is_healthy = torch.where(torso[:, 2] > max_z, zero, is_healthy)
        if self._terminate_when_unhealthy:
            healthy_reward = self._healthy_reward * one
        else:
            healthy_reward = self._healthy_reward * is_healthy
        ctrl_cost = self._ctrl_cost_weight * torch.sum(action * action, dim=-1)
        reward = forward_reward + healthy_reward - ctrl_cost
        done = 1.0 - is_healthy if self._terminate_when_unhealthy else zero
        metrics = dict(
            reward_forward=forward_reward, reward_survive=healthy_reward, reward_ctrl=-ctrl_cost,
            reward_contact=zero, x_position=torso[:, 0], y_position=torso[:, 1],
            distance_from_origin=maths.safe_norm(torso), x_velocity=velocity[:, 0],
            y_velocity=velocity[:, 1], forward_reward=forward_reward)
        return state.replace(pipeline_state=pipeline_state, obs=self._get_obs(pipeline_state),
                             reward=reward, done=done, metrics=metrics)

    def _get_obs(self, pipeline_state) -> Tensor:
        qpos = pipeline_state.q
        if self._exclude_current_positions_from_observation:
            qpos = qpos[:, 2:]
        return torch.cat([qpos, pipeline_state.qd], dim=-1)
