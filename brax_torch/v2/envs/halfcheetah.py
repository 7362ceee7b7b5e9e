"""Planar cheetah on the v2 generalized pipeline, batch-first.

Counterpart of `brax_tpu/v2/envs/halfcheetah.py`: forward velocity reward
minus control cost, never done; obs = q[1:] || qd (17 wide).  The root is
rootx/rootz slides and a rooty hinge on one link (link type "3").
"""

from __future__ import annotations

import torch

from brax_torch.v2 import mjcf
from brax_torch.v2.base import Tensor
from brax_torch.v2.envs import assets, env


class Halfcheetah(env.PipelineEnv):
    """Planar cheetah running toward +x."""

    def __init__(self, forward_reward_weight=1.0, ctrl_cost_weight=0.1, reset_noise_scale=0.1,
                 exclude_current_positions_from_observation=True, backend="generalized",
                 n_frames=5, batch_size=1, device="cuda", use_kernel=True):
        super().__init__(sys=mjcf.loads(assets.halfcheetah_xml(), device=device),
                         backend=backend, n_frames=n_frames, batch_size=batch_size,
                         device=device, use_kernel=use_kernel)
        self._forward_reward_weight = forward_reward_weight
        self._ctrl_cost_weight = ctrl_cost_weight
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
        metrics = {k: zero for k in ("x_position", "x_velocity", "reward_ctrl", "reward_run")}
        return env.State(pipeline_state, self._get_obs(pipeline_state), zero, zero, metrics)

    def step(self, state: env.State, action: Tensor) -> env.State:
        ps0 = state.pipeline_state
        ps = self.pipeline_step(ps0, action)
        x_velocity = (ps.x.pos[:, 0, 0] - ps0.x.pos[:, 0, 0]) / self.dt
        forward_reward = self._forward_reward_weight * x_velocity
        ctrl_cost = self._ctrl_cost_weight * torch.sum(action * action, dim=-1)
        metrics = dict(state.metrics, x_position=ps.x.pos[:, 0, 0], x_velocity=x_velocity,
                       reward_run=forward_reward, reward_ctrl=-ctrl_cost)
        return state.replace(pipeline_state=ps, obs=self._get_obs(ps),
                             reward=forward_reward - ctrl_cost,
                             done=torch.zeros_like(forward_reward), metrics=metrics)

    def _get_obs(self, pipeline_state) -> Tensor:
        qpos = pipeline_state.q
        if self._exclude_current_positions_from_observation:
            qpos = qpos[:, 1:]
        return torch.cat([qpos, pipeline_state.qd], dim=-1)
