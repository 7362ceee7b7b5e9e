"""Grasp: a claw hand picking up a ball and carrying it to random targets,
batch-first.

Counterpart of `brax_tpu/envs/grasp.py`.  The action (39 wide) is the 36
joint dofs of the claw's four fingers, each mapped from [-1, 1] onto its
joint's limits (degrees: the angle actuators' targets), and a target for
the palm in a box (x, y in [-10, 10], z in [3.5, 13.5]).  Before each
physics step the palm, a frozen body, is moved 15% of the way toward that
target (at most 0.3 a step); the physics reads all 39 columns, its
actuators the first 36.  The reward sums the hand's approach to the
object, its closeness, the fingertips touching (`Info.contact.vel` at
bodies 3, 9, 12 and 15, the reference's indexing: body 15, the target, is
never in contact), a hit of the target and the object's approach to it.
A hit moves the target to a random point of a circle above the floor,
drawn from the generator the env was reset with (`state.info["rng"]`);
`step_from_draws` takes those draws as an argument, so that a test can
hand the same target to this env and to the JAX one.  The observation is
132 wide.
"""

from __future__ import annotations

import math

import torch

from brax_torch import maths
from brax_torch.envs import base
from brax_torch.envs.assets.grasp import grasp_config
from brax_torch.sim.types import QP, Info, Tensor

_METRICS = ("hits", "touchingObject", "movingToObject", "movingObjectToTarget", "closeToObject")
# the fingertips' body indices whose contact the reward counts
_TOUCHING = (3, 9, 12, 15)


class Grasp(base.Env):
    name = "grasp"

    def __init__(self, legacy_spring=False, batch_size=1, device="cuda", **kwargs):
        # legacy_spring is taken and ignored, as the JAX env ignores it: the
        # scene has no spring config
        super().__init__(config=grasp_config(), batch_size=batch_size, device=device)
        index = self.art.body_index
        self._object_idx = index["Object"]
        self._target_idx = index["Target"]
        self._hand_idx = index["HandThumbProximal"]
        self._palm_idx = index["HandPalm"]
        self._target_radius = 1.1
        self._target_distance = 10.0
        self._target_height = 8.0
        limits = [lim for j in self.art.config.joints for lim in j.angle_limits]
        lo = [l for l, _ in limits] + [-10.0, -10.0, 3.5]
        span = [h - l for l, h in limits] + [20.0, 20.0, 10.0]
        self._min_act = torch.tensor(lo, dtype=torch.float32, device=self.device)
        self._range_act = torch.tensor(span, dtype=torch.float32, device=self.device)

    def reset(self, rng: torch.Generator) -> base.State:
        qp = self.default_qp()
        n = self.batch_size
        qp = QP(*(x.expand((n,) + x.shape[1:]).contiguous()
                  for x in (qp.pos, qp.rot, qp.vel, qp.ang)))
        info = self.sys.info(qp)
        zero = torch.zeros(n, device=self.device)
        return base.State(qp, self._get_obs(qp, info), zero, zero,
                          {name: zero for name in _METRICS}, info={"rng": rng})

    def step(self, state: base.State, action: Tensor) -> base.State:
        draws = torch.rand((action.shape[0], 3), generator=state.info["rng"], device=self.device)
        return self.step_from_draws(state, action, draws)

    def physics_input(self, qp: QP, action: Tensor):
        """(qp with the palm moved toward the action's target, the action
        mapped onto the joints' limits and the palm's box): what the
        physics step is given."""
        action = self._min_act + self._range_act * ((action + 1) / 2.0)
        target_pos = action[:, -3:]
        palm_pos = qp.pos[:, self._palm_idx]
        norm = maths.safe_norm(target_pos - palm_pos)[:, None]
        scale = torch.where(norm > 2.0, 2.0 / torch.clamp(norm, min=1e-6), torch.ones_like(norm))
        pos = qp.pos.clone()
        pos[:, self._palm_idx] = palm_pos + scale * (target_pos - palm_pos) * 0.15
        return QP(pos=pos, rot=qp.rot, vel=qp.vel, ang=qp.ang), action

    def step_from_draws(self, state: base.State, action: Tensor, draws: Tensor) -> base.State:
        """The step, with the new target's three uniform draws in [0, 1)
        (N, 3) given: its distance from the origin, its angle and its
        height (used where the target was hit)."""
        qp, act = self.physics_input(state.qp, action)
        qp, info = self.sys.step(qp, act)
        obs = self._get_obs(qp, info)
        dt = self.art.config.dt

        object_pos = qp.pos[:, self._object_idx]
        object_rel = object_pos - qp.pos[:, self._palm_idx]
        object_dist = maths.safe_norm(object_rel)
        planar = object_rel * torch.tensor([1.0, 1.0, 0.0], device=self.device)
        planar_object_dist = maths.safe_norm(planar)
        object_dir = object_rel / (1e-6 + object_dist[:, None])
        hand_vel = qp.vel[:, self._hand_idx]
        moving_to_object = 0.1 * dt * (hand_vel * object_dir).sum(dim=-1)
        close_to_object = 0.1 * dt * 1.0 / (1.0 + planar_object_dist)

        target_rel = qp.pos[:, self._target_idx] - object_pos
        target_dist = maths.safe_norm(target_rel)
        target_dir = target_rel / (1e-6 + target_dist[:, None])
        moving_to_target = 1.5 * dt * (qp.vel[:, self._object_idx] * target_dir).sum(dim=-1)

        contacts = self._contacts(info)
        touching_object = 0.2 * dt * sum(contacts[:, b] for b in _TOUCHING)
        target_hit = (target_dist < self._target_radius).to(target_dist.dtype)

        reward = (moving_to_object + close_to_object + touching_object + 5.0 * target_hit
                  + moving_to_target)
        metrics = dict(state.metrics, hits=target_hit, touchingObject=touching_object,
                       movingToObject=moving_to_object,
                       movingObjectToTarget=moving_to_target, closeToObject=close_to_object)
        target = torch.where(target_hit[:, None] > 0, self._target(draws),
                             qp.pos[:, self._target_idx])
        pos = qp.pos.clone()
        pos[:, self._target_idx] = target
        qp = QP(pos=pos, rot=qp.rot, vel=qp.vel, ang=qp.ang)
        return state.replace(qp=qp, obs=obs, reward=reward, metrics=metrics)

    @property
    def action_size(self) -> int:
        return super().action_size + 3  # the palm's target

    def _target(self, draws: Tensor) -> Tensor:
        """A target in a circle above the xy plane, from uniform draws."""
        dist = self._target_radius + self._target_distance * draws[:, 0]
        ang = math.pi * 2.0 * draws[:, 1]
        return torch.stack([dist * torch.cos(ang), dist * torch.sin(ang),
                            self._target_height * draws[:, 2]], dim=-1)

    @staticmethod
    def _contacts(info: Info) -> Tensor:
        """1 where a body's contact impulse is not negligible, else 0."""
        return (torch.square(info.contact.vel).sum(dim=-1) > 0.00001).to(info.contact.vel.dtype)

    def _get_obs(self, qp: QP, info: Info) -> Tensor:
        """Egocentric observation of target, object, and hand."""
        palm = self._palm_idx
        palm_pos, palm_rot = qp.pos[:, palm], qp.rot[:, palm, None]
        pos_local = maths.inv_rotate(qp.pos - palm_pos[:, None], palm_rot)
        vel_local = maths.inv_rotate(qp.vel, palm_rot)

        def mag_dir(v):
            mag = maths.safe_norm(v)[:, None]
            return mag, v / (1e-6 + mag)

        object_local_mag, object_local_dir = mag_dir(pos_local[:, self._object_idx])
        hand_to_obj = qp.pos[:, self._object_idx] - palm_pos
        _, hand_to_obj_dir = mag_dir(hand_to_obj)
        hand_vel = qp.vel[:, self._hand_idx]
        heading_to_obj = (hand_to_obj_dir * hand_vel).sum(dim=-1, keepdim=True)
        target_local_mag, target_local_dir = mag_dir(pos_local[:, self._target_idx])
        obj_to_target = qp.pos[:, self._target_idx] - qp.pos[:, self._object_idx]
        obj_to_target_mag, obj_to_target_dir = mag_dir(obj_to_target)
        obj_heading_to_target = (obj_to_target_dir * qp.vel[:, self._object_idx]).sum(
            dim=-1, keepdim=True)
        n = qp.pos.shape[0]
        return torch.cat([
            object_local_mag, object_local_dir, target_local_mag, target_local_dir,
            pos_local.reshape(n, -1), vel_local.reshape(n, -1), hand_to_obj, hand_vel,
            heading_to_obj, obj_to_target_mag, obj_to_target_dir, obj_heading_to_target,
            self._contacts(info)], dim=-1)
