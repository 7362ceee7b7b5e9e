"""One-legged hopper on the v2 generalized pipeline, batch-first.

Counterpart of `brax_tpu/v2/envs/hopper.py`: forward reward + healthy
bonus - control cost, done when the torso leaves its height or pitch
range; obs = q[1:] || clip(qd, -10, 10) (11 wide).  The root is rootx/rootz
slides and a rooty hinge on one link (link type "3").  `Walker2d` is the
same task on another body (`walker2d.py`).
"""

from __future__ import annotations

import torch

from brax_torch.v2 import mjcf
from brax_torch.v2.base import Tensor
from brax_torch.v2.envs import assets, env


class Hopper(env.PipelineEnv):
    """One-legged hopper driving toward +x."""

    XML = staticmethod(assets.hopper_xml)

    def __init__(self, forward_reward_weight=1.0, ctrl_cost_weight=1e-3, healthy_reward=1.0,
                 terminate_when_unhealthy=True, healthy_z_range=(0.7, float("inf")),
                 healthy_angle_range=(-0.2, 0.2), reset_noise_scale=5e-3,
                 exclude_current_positions_from_observation=True, backend="generalized",
                 n_frames=4, batch_size=1, device="cuda", use_kernel=True):
        super().__init__(sys=mjcf.loads(self.XML(), device=device), backend=backend,
                         n_frames=n_frames, batch_size=batch_size, device=device,
                         use_kernel=use_kernel)
        self._forward_reward_weight = forward_reward_weight
        self._ctrl_cost_weight = ctrl_cost_weight
        self._healthy_reward = healthy_reward
        self._terminate_when_unhealthy = terminate_when_unhealthy
        self._healthy_z_range = healthy_z_range
        self._healthy_angle_range = healthy_angle_range
        self._reset_noise_scale = reset_noise_scale
        self._exclude_current_positions_from_observation = (
            exclude_current_positions_from_observation)

    def reset(self, rng: torch.Generator) -> env.State:
        n, s = self.batch_size, self._reset_noise_scale
        uniform = lambda m: torch.rand((n, m), generator=rng, device=self.device) * 2 * s - s
        return self.reset_from_noise(uniform(self.sys.q_size()), uniform(self.sys.qd_size()))

    def reset_from_noise(self, q_noise: Tensor, qd: Tensor) -> env.State:
        """The reset state at q = init_q + q_noise (N, nq) and velocity qd (N, nd)."""
        pipeline_state = self.pipeline_init(self.sys.init_q + q_noise, qd)
        zero = torch.zeros((self.batch_size,), device=self.device)
        metrics = {k: zero for k in ("x_position", "x_velocity", "reward_forward", "reward_ctrl",
                                     "reward_healthy")}
        return env.State(pipeline_state, self._get_obs(pipeline_state), zero, zero, metrics)

    def step(self, state: env.State, action: Tensor) -> env.State:
        ps0 = state.pipeline_state
        ps = self.pipeline_step(ps0, action)
        x_velocity = (ps.x.pos[:, 0, 0] - ps0.x.pos[:, 0, 0]) / self.dt
        forward_reward = self._forward_reward_weight * x_velocity
        ctrl_cost = self._ctrl_cost_weight * torch.sum(action * action, dim=-1)
        # the torso's world height and pitch
        z, angle = ps.x.pos[:, 0, 2], ps.q[:, 2]
        min_z, max_z = self._healthy_z_range
        min_a, max_a = self._healthy_angle_range
        is_healthy = ((z > min_z) & (z < max_z) & (angle > min_a) & (angle < max_a)).float()
        if self._terminate_when_unhealthy:
            healthy_reward = self._healthy_reward * torch.ones_like(is_healthy)
            done = 1.0 - is_healthy
        else:
            healthy_reward = self._healthy_reward * is_healthy
            done = torch.zeros_like(is_healthy)
        metrics = dict(state.metrics, x_position=ps.x.pos[:, 0, 0], x_velocity=x_velocity,
                       reward_forward=forward_reward, reward_ctrl=-ctrl_cost,
                       reward_healthy=healthy_reward)
        return state.replace(pipeline_state=ps, obs=self._get_obs(ps),
                             reward=forward_reward + healthy_reward - ctrl_cost, done=done,
                             metrics=metrics)

    def _get_obs(self, pipeline_state) -> Tensor:
        qpos = pipeline_state.q
        if self._exclude_current_positions_from_observation:
            qpos = qpos[:, 1:]
        return torch.cat([qpos, torch.clamp(pipeline_state.qd, -10.0, 10.0)], dim=-1)
