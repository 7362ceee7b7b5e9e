"""Two-link planar reacher on the v2 generalized pipeline, batch-first.

Counterpart of `brax_tpu/v2/envs/reacher.py`: reward = -|fingertip -
target| - |action|^2, never done; the target sits on two slide joints
(q[2:4]) and is drawn uniformly in the disk of radius 0.2 at reset.  obs =
cos and sin of the arm's hinges, the target, the hinges' qd and fingertip
minus target (11 wide).
"""

from __future__ import annotations

import math

import torch

from brax_torch import maths
from brax_torch.v2 import mjcf
from brax_torch.v2.base import Tensor
from brax_torch.v2.envs import assets, env


class Reacher(env.PipelineEnv):
    """Drive the fingertip of a 2-link planar arm onto a random target."""

    def __init__(self, backend="generalized", n_frames=2, batch_size=1, device="cuda",
                 use_kernel=True):
        super().__init__(sys=mjcf.loads(assets.reacher_xml(), device=device), backend=backend,
                         n_frames=n_frames, batch_size=batch_size, device=device,
                         use_kernel=use_kernel)

    def reset(self, rng: torch.Generator) -> env.State:
        n = self.batch_size
        uniform = lambda shape, s: (torch.rand(shape, generator=rng, device=self.device)
                                    * 2 * s - s)
        q_noise = uniform((n, self.sys.q_size()), 0.1)
        qd = uniform((n, self.sys.qd_size()), 0.005)
        r = 0.2 * torch.sqrt(torch.rand((n,), generator=rng, device=self.device))
        ang = math.pi * 2.0 * torch.rand((n,), generator=rng, device=self.device)
        target = torch.stack([r * torch.cos(ang), r * torch.sin(ang)], dim=-1)
        return self.reset_from_noise(q_noise, qd, target)

    def reset_from_noise(self, q_noise: Tensor, qd: Tensor, target: Tensor) -> env.State:
        """The reset state at q = init_q + q_noise (N, nq) with the target
        slides q[2:4] set to `target` (N, 2), and velocity qd (N, nd) with
        the target's set to 0."""
        q = torch.cat([(self.sys.init_q + q_noise)[:, :2], target,
                       (self.sys.init_q + q_noise)[:, 4:]], dim=-1)
        qd = torch.cat([qd[:, :2], torch.zeros_like(qd[:, 2:4]), qd[:, 4:]], dim=-1)
        pipeline_state = self.pipeline_init(q, qd)
        zero = torch.zeros((self.batch_size,), device=self.device)
        metrics = {"reward_dist": zero, "reward_ctrl": zero}
        return env.State(pipeline_state, self._get_obs(pipeline_state), zero, zero, metrics)

    def step(self, state: env.State, action: Tensor) -> env.State:
        ps = self.pipeline_step(state.pipeline_state, action)
        obs = self._get_obs(ps)
        reward_dist = -torch.linalg.vector_norm(obs[:, -3:], dim=-1)
        reward_ctrl = -torch.sum(action * action, dim=-1)
        metrics = dict(state.metrics, reward_dist=reward_dist, reward_ctrl=reward_ctrl)
        return state.replace(pipeline_state=ps, obs=obs, reward=reward_dist + reward_ctrl,
                             done=torch.zeros_like(reward_dist), metrics=metrics)

    def _fingertip(self, pipeline_state) -> Tensor:
        tip = torch.tensor([0.11, 0.0, 0.0], device=self.device)
        return pipeline_state.x.pos[:, 1] + maths.rotate(tip, pipeline_state.x.rot[:, 1])

    def _get_obs(self, pipeline_state) -> Tensor:
        theta = pipeline_state.q[:, :2]
        target = pipeline_state.x.pos[:, 2]
        return torch.cat([torch.cos(theta), torch.sin(theta), target[:, :2],
                          pipeline_state.qd[:, :2], self._fingertip(pipeline_state) - target],
                         dim=-1)
