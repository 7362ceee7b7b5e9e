"""Trivial kinematic env for trainer tests, batch-first.

Counterpart of `brax_tpu/envs/fast.py`: each env's velocity rises by dt
while its action is positive, and its reward is its position.
"""

from __future__ import annotations

import torch

from brax_torch.envs import base
from brax_torch.sim.types import QP, Tensor


class Fast(base.Env):
    """Trains an agent to go fast."""

    def __init__(self, batch_size: int = 1, device="cuda", **kwargs):
        super().__init__(config=None, batch_size=batch_size, device=device)
        self._dt = 0.02

    def reset(self, rng: torch.Generator) -> base.State:
        zero = torch.zeros((self.batch_size, 1), device=self.device)
        qp = QP(pos=zero, vel=zero, rot=zero, ang=zero)
        obs = torch.zeros((self.batch_size, 2), device=self.device)
        reward = torch.zeros((self.batch_size,), device=self.device)
        return base.State(qp, obs, reward, torch.zeros_like(reward))

    def step(self, state: base.State, action: Tensor) -> base.State:
        vel = state.qp.vel + (action > 0) * self._dt
        pos = state.qp.pos + vel * self._dt
        qp = QP(pos=pos, vel=vel, rot=state.qp.rot, ang=state.qp.ang)
        obs = torch.cat([pos, vel], dim=-1)
        return state.replace(qp=qp, obs=obs, reward=pos[:, 0])

    @property
    def observation_size(self):
        return 2

    @property
    def action_size(self):
        return 1
