"""UR5e: a 6-dof robot arm reaching random targets, batch-first.

Counterpart of `brax_tpu/envs/ur5e.py`.  The arm's six revolute joints
take torque actuators (the action is 6 wide).  A target lies in a random
circle of radius 0.02-0.52, 0.5 above the floor; `reset` and `step` draw
its two uniforms (its distance and its angle) from the generator the env
was reset with (`state.info["rng"]`) and hand them to `reset_from_draws`
and `step_from_draws`, which are deterministic, so a test can hand the
same targets to this env and to the JAX one.  The reward is 0.1 of the
wrist's move toward the target plus 1 on a hit (within 0.02), which moves
the target.  The observation (66 wide) is the wrist's forward and up
axes, the target in the wrist's frame (its distance and direction), every
body's position and velocity in that frame and each body's contact flag.
"""

from __future__ import annotations

import math

import torch

from brax_torch import maths
from brax_torch.envs import base
from brax_torch.envs.assets.ur5e import ur5e_config
from brax_torch.envs.humanoid import _no_legacy_spring
from brax_torch.sim.types import QP, Info, Tensor

_METRICS = ("hits", "weightedHits", "movingToTarget")


class Ur5e(base.Env):
    name = "ur5e"

    def __init__(self, legacy_spring=False, batch_size=1, device="cuda", **kwargs):
        _no_legacy_spring(legacy_spring, self.name)
        super().__init__(config=ur5e_config(), batch_size=batch_size, device=device)
        self._target_idx = self.art.body_index["Target"]
        self._torso_idx = self.art.body_index["wrist_3_link"]
        self._target_radius = 0.02
        self._target_distance = 0.5

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
        torso = self._torso_idx
        torso_delta = qp.pos[:, torso] - state.qp.pos[:, torso]
        target_rel = qp.pos[:, self._target_idx] - qp.pos[:, torso]
        target_dist = maths.safe_norm(target_rel)
        target_dir = target_rel / (1e-6 + target_dist[:, None])
        moving_to_target = 0.1 * (torso_delta * target_dir).sum(dim=-1)
        target_hit = (target_dist < self._target_radius).to(target_dist.dtype)
        reward = moving_to_target + target_hit
        metrics = dict(state.metrics, hits=target_hit, weightedHits=target_hit,
                       movingToTarget=moving_to_target)
        target = torch.where(target_hit[:, None] > 0, self._target(draws),
                             qp.pos[:, self._target_idx])
        pos = qp.pos.clone()
        pos[:, self._target_idx] = target
        qp = QP(pos=pos, rot=qp.rot, vel=qp.vel, ang=qp.ang)
        return state.replace(qp=qp, obs=obs, reward=reward, metrics=metrics)

    def _target(self, draws: Tensor) -> Tensor:
        """A target in a random circle slightly above the xy plane."""
        dist = self._target_radius + self._target_distance * draws[:, 0]
        ang = math.pi * 2.0 * draws[:, 1]
        return torch.stack([dist * torch.cos(ang), dist * torch.sin(ang),
                            torch.full_like(dist, 0.5)], dim=-1)

    def _get_obs(self, qp: QP, info: Info) -> Tensor:
        """Egocentric observation of target and arm body."""
        torso = self._torso_idx
        rot = qp.rot[:, torso]
        axis = lambda v: maths.rotate(torch.tensor(v, device=self.device).expand(
            rot.shape[0], 3), rot)
        pos_local = maths.inv_rotate(qp.pos - qp.pos[:, torso, None], rot[:, None])
        vel_local = maths.inv_rotate(qp.vel, rot[:, None])
        target_local = pos_local[:, self._target_idx]
        target_local_mag = maths.safe_norm(target_local)[:, None]
        target_local_dir = target_local / (1e-6 + target_local_mag)
        contacts = (torch.square(info.contact.vel).sum(dim=-1) > 0.00001).to(qp.pos.dtype)
        n = qp.pos.shape[0]
        return torch.cat([axis([1.0, 0.0, 0.0]), axis([0.0, 0.0, 1.0]), target_local_mag,
                          target_local_dir, pos_local.reshape(n, -1), vel_local.reshape(n, -1),
                          contacts], dim=-1)
