"""Cart-pole balance on the v2 generalized pipeline, batch-first.

Counterpart of `brax_tpu/v2/envs/inverted_pendulum.py`: reward 1 per step,
done when the pole leans more than 0.2 rad; obs = q || qd (4 wide).
`reset` draws its noise from a `torch.Generator` and hands it to
`reset_from_noise`, which is deterministic.
"""

from __future__ import annotations

import torch

from brax_torch.v2 import mjcf
from brax_torch.v2.base import Tensor
from brax_torch.v2.envs import assets, env


class InvertedPendulum(env.PipelineEnv):
    """Balance a pole on a sliding cart; +1 reward per upright step."""

    def __init__(self, backend="generalized", n_frames=2, batch_size=1, device="cuda",
                 use_kernel=True):
        super().__init__(sys=mjcf.loads(assets.inverted_pendulum_xml(), device=device),
                         backend=backend, n_frames=n_frames, batch_size=batch_size,
                         device=device, use_kernel=use_kernel)

    def reset(self, rng: torch.Generator) -> env.State:
        n = self.batch_size
        uniform = lambda m: (torch.rand((n, m), generator=rng, device=self.device) * 0.02
                             - 0.01)
        return self.reset_from_noise(uniform(self.sys.q_size()), uniform(self.sys.qd_size()))

    def reset_from_noise(self, q_noise: Tensor, qd: Tensor) -> env.State:
        """The reset state at q = init_q + q_noise (N, nq) and velocity qd (N, nd)."""
        pipeline_state = self.pipeline_init(self.sys.init_q + q_noise, qd)
        zero = torch.zeros((self.batch_size,), device=self.device)
        return env.State(pipeline_state, self._get_obs(pipeline_state), zero, zero, {})

    def step(self, state: env.State, action: Tensor) -> env.State:
        pipeline_state = self.pipeline_step(state.pipeline_state, action)
        obs = self._get_obs(pipeline_state)
        done = (obs[:, 1].abs() > 0.2).float()
        return state.replace(pipeline_state=pipeline_state, obs=obs,
                             reward=torch.ones_like(done), done=done)

    def _get_obs(self, pipeline_state) -> Tensor:
        return torch.cat([pipeline_state.q, pipeline_state.qd], dim=-1)
