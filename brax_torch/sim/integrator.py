"""Semi-implicit Euler integration + PBD velocity projection, batch-first.

Counterpart of `brax_tpu/sim/integrator.py`.  Frozen degrees of freedom are
handled by 0/1 masks of shape (nb, C) that broadcast over the env batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from brax_torch import maths
from brax_torch.sim.types import DP, DQ, QP, Tensor


@dataclass
class Integrator:
    pos_mask: Tensor  # (nb, 3) 1.0 where the dof is live
    rot_mask: Tensor  # (nb, 3)
    quat_mask: Tensor  # (nb, 4)
    dt: float
    gravity: Tensor  # (3,)
    velocity_damping: float
    angular_damping: float

    def kinetic(self, qp: QP) -> QP:
        """Advances position/rotation by the current velocities."""
        pos = qp.pos + qp.vel * self.dt * self.pos_mask
        rot_at_ang_quat = maths.ang_to_quat(qp.ang * self.rot_mask) * 0.5 * self.dt
        rot = qp.rot + maths.quat_mul(rot_at_ang_quat, qp.rot)
        rot = rot / torch.linalg.vector_norm(rot, dim=-1, keepdim=True)
        return QP(pos=pos, rot=rot, vel=qp.vel, ang=qp.ang)

    def update_acc(self, qp: QP, dp: DP) -> QP:
        """Acceleration-level update with damping and gravity."""
        vel = math.exp(self.velocity_damping * self.dt) * qp.vel
        vel = vel + (dp.vel + self.gravity) * self.dt
        vel = vel * self.pos_mask
        ang = math.exp(self.angular_damping * self.dt) * qp.ang
        ang = ang + dp.ang * self.dt
        ang = ang * self.rot_mask
        return QP(pos=qp.pos, rot=qp.rot, vel=vel, ang=ang)

    def update_vel(self, qp: QP, dp: DP) -> QP:
        """Velocity-level update."""
        vel = (qp.vel + dp.vel) * self.pos_mask
        ang = (qp.ang + dp.ang) * self.rot_mask
        return QP(pos=qp.pos, rot=qp.rot, vel=vel, ang=ang)

    def update_pos(self, qp: QP, dq: DQ) -> QP:
        """Position-level update."""
        return QP(
            pos=qp.pos + dq.pos * self.pos_mask,
            rot=qp.rot + dq.rot * self.quat_mask,
            vel=qp.vel,
            ang=qp.ang,
        )

    def velocity_projection(self, qp: QP, qp_prev: QP) -> QP:
        """PBD velocity projection: velocities from position deltas."""
        new_rot = qp.rot / torch.linalg.vector_norm(qp.rot, dim=-1, keepdim=True)
        vel = ((qp.pos - qp_prev.pos) / self.dt) * self.pos_mask
        dq = maths.relative_quat(qp_prev.rot, new_rot)
        ang = 2.0 * dq[..., 1:] / self.dt
        sign = torch.where(dq[..., 0:1] >= 0.0, 1.0, -1.0)
        scale = sign * self.rot_mask
        ang = scale * ang * self.rot_mask
        return QP(pos=qp.pos, vel=vel, rot=new_rot, ang=ang)
