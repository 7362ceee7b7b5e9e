"""Fetch: a dog-like robot chasing random targets, batch-first.

Counterpart of `brax_tpu/envs/fetch.py`.  The dog (a torso, shoulders and
four two-link legs: 10 revolute joints with torque actuators, so the
action is 10 wide) stands on the ground on the boxes of its lower legs,
one-way box-plane contacts of eight corners each.  A target lies in a
random circle of radius 2-17, 1 above the ground; `reset` and `step` draw
its two uniforms (its distance and its angle) from the generator the env
was reset with (`state.info["rng"]`), every step as the JAX env draws
them, and hand them to `reset_from_draws` and `step_from_draws`, which are
deterministic, so a test can hand the same targets to this env and to the
JAX one.  The reward sums the torso's height, its move toward the target,
its being upright and a hit (within 2) weighted by how the torso faces the
target; a hit moves the target.  The observation (101 wide) is the torso's
forward and up axes, the target in the torso's frame (its distance and
direction), every body's position and velocity in that frame and each
body's contact flag (`Info.contact.vel` after the step).  legacy_spring is
taken and ignored, as the JAX env ignores it: the scene has no spring
config.
"""

from __future__ import annotations

import math

import torch

from brax_torch import maths
from brax_torch.envs import base
from brax_torch.envs.assets.fetch import fetch_config
from brax_torch.sim.types import QP, Info, Tensor

_METRICS = ("hits", "weightedHits", "movingToTarget", "torsoIsUp", "torsoHeight")


class Fetch(base.Env):
    name = "fetch"

    def __init__(self, legacy_spring=False, batch_size=1, device="cuda", **kwargs):
        super().__init__(config=fetch_config(), batch_size=batch_size, device=device)
        self._target_idx = self.art.body_index["Target"]
        self._torso_idx = self.art.body_index["Torso"]
        self._target_radius = 2.0
        self._target_distance = 15.0

    def reset(self, rng: torch.Generator) -> base.State:
        draws = torch.rand((self.batch_size, 2), generator=rng, device=self.device)
        return self.reset_from_draws(draws, rng)

    def reset_from_draws(self, draws: Tensor, rng=None) -> base.State:
        """The reset state for the target's draws (N, 2), uniform in [0, 1)."""
        qp = self.default_qp()
        n = draws.shape[0]
        pos = qp.pos.expand(n, -1, -1).clone()
        pos[:, self._target_idx] = self._target(draws)
        rot, vel, ang = (x.expand((n,) + x.shape[1:]).contiguous()
                         for x in (qp.rot, qp.vel, qp.ang))
        qp = QP(pos=pos, rot=rot, vel=vel, ang=ang)
        zero = torch.zeros(n, device=self.device)
        return base.State(qp, self._get_obs(qp, self.sys.info(qp)), zero, zero,
                          {name: zero for name in _METRICS}, info={"rng": rng})

    def step(self, state: base.State, action: Tensor) -> base.State:
        draws = torch.rand((action.shape[0], 2), generator=state.info["rng"], device=self.device)
        return self.step_from_draws(state, action, draws)

    def step_from_draws(self, state: base.State, action: Tensor, draws: Tensor) -> base.State:
        """The step, with the next target's draws (N, 2) given (used where
        the target was hit)."""
        qp, info = self.sys.step(state.qp, action)
        obs = self._get_obs(qp, info)
        dt = self.art.config.dt
        torso = self._torso_idx
        torso_delta = qp.pos[:, torso] - state.qp.pos[:, torso]
        target_rel = qp.pos[:, self._target_idx] - qp.pos[:, torso]
        target_dist = maths.safe_norm(target_rel)
        target_dir = target_rel / (1e-6 + target_dist[:, None])
        moving_to_target = 0.1 * (torso_delta * target_dir).sum(dim=-1)

        torso_up = self._axis([0.0, 0.0, 1.0], qp.rot[:, torso])
        torso_is_up = 0.1 * dt * torso_up[:, 2]
        torso_height = 0.1 * dt * qp.pos[:, 0, 2]
        torso_fwd = self._axis([1.0, 0.0, 0.0], qp.rot[:, torso])
        torso_facing = (target_dir * torso_fwd).sum(dim=-1)
        target_hit = (target_dist < self._target_radius).to(target_dist.dtype)
        weighted_hit = target_hit * torso_facing

        reward = torso_height + moving_to_target + torso_is_up + weighted_hit
        metrics = dict(state.metrics, hits=target_hit, weightedHits=weighted_hit,
                       movingToTarget=moving_to_target, torsoIsUp=torso_is_up,
                       torsoHeight=torso_height)
        target = torch.where(target_hit[:, None] > 0, self._target(draws),
                             qp.pos[:, self._target_idx])
        pos = qp.pos.clone()
        pos[:, self._target_idx] = target
        qp = QP(pos=pos, rot=qp.rot, vel=qp.vel, ang=qp.ang)
        return state.replace(qp=qp, obs=obs, reward=reward, metrics=metrics)

    def _target(self, draws: Tensor) -> Tensor:
        """A target in a random circle on the xy plane, 1 above it."""
        dist = self._target_radius + self._target_distance * draws[:, 0]
        ang = math.pi * 2.0 * draws[:, 1]
        return torch.stack([dist * torch.cos(ang), dist * torch.sin(ang),
                            torch.ones_like(dist)], dim=-1)

    def _axis(self, v, rot: Tensor) -> Tensor:
        """The unit vector v rotated by each env's rot (N, 4)."""
        return maths.rotate(torch.tensor(v, device=self.device).expand(rot.shape[0], 3), rot)

    def _get_obs(self, qp: QP, info: Info) -> Tensor:
        """Egocentric observation of target and the dog's body."""
        rot = qp.rot[:, self._torso_idx]
        pos_local = maths.inv_rotate(qp.pos - qp.pos[:, self._torso_idx, None], rot[:, None])
        vel_local = maths.inv_rotate(qp.vel, rot[:, None])
        target_local = pos_local[:, self._target_idx]
        target_local_mag = maths.safe_norm(target_local)[:, None]
        target_local_dir = target_local / (1e-6 + target_local_mag)
        contacts = (torch.square(info.contact.vel).sum(dim=-1) > 0.00001).to(qp.pos.dtype)
        n = qp.pos.shape[0]
        return torch.cat([self._axis([1.0, 0.0, 0.0], rot), self._axis([0.0, 0.0, 1.0], rot),
                          target_local_mag, target_local_dir, pos_local.reshape(n, -1),
                          vel_local.reshape(n, -1), contacts], dim=-1)
