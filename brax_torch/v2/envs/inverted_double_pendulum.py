"""Cart with two stacked poles on the v2 generalized pipeline, batch-first.

Counterpart of `brax_tpu/v2/envs/inverted_double_pendulum.py`: an alive
bonus of 10 minus the tip's distance and velocity penalties, done when the
tip drops to 1.0; obs = cart position, sin and cos of the hinges, clipped
qd (8 wide).
"""

from __future__ import annotations

import torch

from brax_torch import maths
from brax_torch.v2 import mjcf
from brax_torch.v2.base import Tensor
from brax_torch.v2.envs import assets, env


class InvertedDoublePendulum(env.PipelineEnv):
    """Keep the double pole upright by sliding the cart."""

    def __init__(self, backend="generalized", n_frames=2, batch_size=1, device="cuda",
                 use_kernel=True):
        super().__init__(sys=mjcf.loads(assets.inverted_double_pendulum_xml(), device=device),
                         backend=backend, n_frames=n_frames, batch_size=batch_size,
                         device=device, use_kernel=use_kernel)

    def reset(self, rng: torch.Generator) -> env.State:
        n = self.batch_size
        q_noise = torch.rand((n, self.sys.q_size()), generator=rng, device=self.device) * 0.2 - 0.1
        qd = 0.1 * torch.randn((n, self.sys.qd_size()), generator=rng, device=self.device)
        return self.reset_from_noise(q_noise, qd)

    def reset_from_noise(self, q_noise: Tensor, qd: Tensor) -> env.State:
        """The reset state at q = init_q + q_noise (N, nq) and velocity qd (N, nd)."""
        pipeline_state = self.pipeline_init(self.sys.init_q + q_noise, qd)
        zero = torch.zeros((self.batch_size,), device=self.device)
        return env.State(pipeline_state, self._get_obs(pipeline_state), zero, zero, {})

    def step(self, state: env.State, action: Tensor) -> env.State:
        ps = self.pipeline_step(state.pipeline_state, action)
        tip = self._tip(ps)
        x, y = tip[:, 0], tip[:, 2]
        dist_penalty = 0.01 * x * x + (y - 2.0) ** 2
        v1, v2 = ps.qd[:, 1], ps.qd[:, 2]
        vel_penalty = 1e-3 * v1 * v1 + 5e-3 * v2 * v2
        reward = 10.0 - dist_penalty - vel_penalty
        done = (y <= 1.0).float()
        return state.replace(pipeline_state=ps, obs=self._get_obs(ps), reward=reward, done=done)

    def _tip(self, pipeline_state) -> Tensor:
        """World position of the second pole's free end."""
        end = torch.tensor([0.0, 0.0, 0.6], device=self.device)
        return pipeline_state.x.pos[:, 2] + maths.rotate(end, pipeline_state.x.rot[:, 2])

    def _get_obs(self, pipeline_state) -> Tensor:
        q, qd = pipeline_state.q, pipeline_state.qd
        return torch.cat([q[:, :1], torch.sin(q[:, 1:]), torch.cos(q[:, 1:]),
                          torch.clamp(qd, -10.0, 10.0)], dim=-1)
