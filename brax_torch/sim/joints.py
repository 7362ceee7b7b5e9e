"""Dense batched joint constraints, batch-first.

Counterpart of `brax_tpu/sim/joints.py`.  Joints of one kind form a
`JointGroup` whose tables have a leading joint axis (nj, ...); they broadcast
against state gathered to (N, nj, ...) and scatter back onto the body axis
with one `index_add_`.  This slice ports the PBD revolute joint; spherical and
spring joints are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from brax_torch import maths
from brax_torch.maths import dot1, vdot
from brax_torch.sim.types import DP, DQ, QP, Tensor, index


@dataclass
class JointGroup:
    """A batch of same-kind joints; tensors have a leading (nj,) axis."""

    kind: str  # only 'revolute' is ported
    dof: int
    parent: np.ndarray  # (nj,) body indices
    child: np.ndarray
    free_dofs: Optional[Tuple[int, ...]] = None

    off_p: Tensor = None  # (nj, 3)
    off_c: Tensor = None
    limit: Tensor = None  # (nj, dof, 2) radians
    axis_c: Tensor = None  # (nj, 3, 3)
    axis_p: Tensor = None  # (nj, 3, 3)
    angular_damping: Tensor = None  # (nj,)
    scale_pos: Tensor = None  # (nj,)
    scale_ang: Tensor = None
    mass_p: Tensor = None  # (nj,)
    mass_c: Tensor = None
    inertia_p: Tensor = None  # (nj, 3) inverse inertia diagonal
    inertia_c: Tensor = None
    stiffness: Tensor = None
    spring_damping: Tensor = None
    limit_strength: Tensor = None

    @property
    def n(self) -> int:
        return len(self.parent)


def scatter_add_bodies(out: Tensor, idx, vals: Tensor) -> Tensor:
    """out[..., idx[k], :] += vals[..., k, :] along the body axis (dim -2)."""
    return out.index_add(out.dim() - 2, index(idx, out.device), vals)


def _scatter_add3(vals_p: Tensor, vals_c: Tensor, parent, child, nb: int) -> Tensor:
    """Scatter-adds per-joint parent/child contributions onto bodies."""
    out = vals_p.new_zeros(vals_p.shape[:-2] + (nb, vals_p.shape[-1]))
    out = scatter_add_bodies(out, parent, vals_p)
    return scatter_add_bodies(out, child, vals_c)


def _position_update(g: JointGroup, qp_p: QP, qp_c: QP, pos_p: Tensor, pos_c: Tensor):
    """Positional PBD update pulling two anchor points together."""
    dx = pos_p - pos_c
    arm_p = pos_p - qp_p.pos
    arm_c = pos_c - qp_c.pos

    c = maths.safe_norm(dx)[..., None]
    n = dx / (c + 1e-6)

    cr1 = maths.cross(arm_p, n)
    w1 = (1.0 / g.mass_p)[..., None] + dot1(cr1, g.inertia_p * cr1)
    cr2 = maths.cross(arm_c, n)
    w2 = (1.0 / g.mass_c)[..., None] + dot1(cr2, g.inertia_c * cr2)

    dlambda = -c / (w1 + w2 + 1e-6)
    p = dlambda * n

    sp = g.scale_pos[..., None]
    dq_p_pos = sp * (p / g.mass_p[..., None])
    dq_p_rot = sp * (0.5 * maths.vec_quat_mul(g.inertia_p * maths.cross(arm_p, p), qp_p.rot))
    dq_c_pos = sp * (-p / g.mass_c[..., None])
    dq_c_rot = sp * (-0.5 * maths.vec_quat_mul(g.inertia_c * maths.cross(arm_c, p), qp_c.rot))
    return (dq_p_pos, dq_p_rot), (dq_c_pos, dq_c_rot)


def _angle_update(g: JointGroup, qp_p: QP, qp_c: QP, dq: Tensor):
    """Angular PBD update for the constraint violation vector dq (..., nj, 3)."""
    th = maths.safe_norm(dq)[..., None]
    n = dq / (th + 1e-6)

    w1 = dot1(n, g.inertia_p * n)
    w2 = dot1(n, g.inertia_c * n)
    dlambda = -th / (w1 + w2 + 1e-6)
    p = -dlambda * n

    sa = g.scale_ang[..., None]
    dq_p_rot = sa * (0.5 * maths.vec_quat_mul(g.inertia_p * p, qp_p.rot))
    dq_c_rot = sa * (-0.5 * maths.vec_quat_mul(g.inertia_c * p, qp_c.rot))
    return dq_p_rot, dq_c_rot


def _rotate_frame(axes: Tensor, rot: Tensor) -> Tensor:
    """Rotates each row of (nj, 3, 3) axes by per-joint quaternions (..., nj, 4)."""
    return maths.rotate(axes, rot[..., None, :])


def _require_revolute(g: JointGroup):
    if g.kind != "revolute":
        raise NotImplementedError(
            f"{g.kind} joints are not ported yet (see ROADMAP.md, queue B item 1)"
        )


def axis_angle(g: JointGroup, qp_p: QP, qp_c: QP):
    """Joint axes and angles: (..., nj, dof, 3), (..., nj, dof)."""
    _require_revolute(g)
    axis_p_r = _rotate_frame(g.axis_p, qp_p.rot)
    axis_c_r = _rotate_frame(g.axis_c, qp_c.rot)
    axis_1_p = axis_p_r[..., 0, :]
    ref_p = axis_p_r[..., 2, :]
    ref_c = axis_c_r[..., 2, :]
    psi = maths.signed_angle(axis_1_p, ref_p, ref_c)
    return axis_1_p[..., None, :], psi[..., None]


def angle_vel(g: JointGroup, qp: QP):
    """Flat joint angles and velocities for observation vectors."""
    qp_p = qp.take(g.parent)
    qp_c = qp.take(g.child)
    axes, angles = axis_angle(g, qp_p, qp_c)
    rel_ang = (qp_p.ang - qp_c.ang)[..., None, :]
    vels = vdot(rel_ang, axes)  # (..., nj, dof)
    angles_flat = angles.reshape(angles.shape[:-2] + (-1,))
    vels_flat = vels.reshape(vels.shape[:-2] + (-1,))
    if g.free_dofs is not None:
        idx = []
        for i, fd in enumerate(g.free_dofs):
            idx.extend(range(i * g.dof, i * g.dof + fd))
        sel = index(idx, angles_flat.device)
        angles_flat = angles_flat[..., sel]
        vels_flat = vels_flat[..., sel]
    return angles_flat, vels_flat


def damp(g: JointGroup, qp: QP, nb: int) -> DP:
    """Angular damping between connected bodies."""
    qp_p = qp.take(g.parent)
    qp_c = qp.take(g.child)
    torque = -1.0 * g.angular_damping[..., None] * (qp_p.ang - qp_c.ang)
    dang_p = g.inertia_p * torque
    dang_c = -g.inertia_c * torque
    dang = _scatter_add3(dang_p, dang_c, g.parent, g.child, nb)
    return DP(vel=torch.zeros_like(dang), ang=dang)


def pbd_apply(g: JointGroup, qp: QP, nb: int) -> DQ:
    """Position-based revolute constraint update, scattered onto bodies."""
    _require_revolute(g)
    qp_p = qp.take(g.parent)
    qp_c = qp.take(g.child)

    pos_p, _ = qp_p.to_world(g.off_p)
    pos_c, _ = qp_c.to_world(g.off_c)
    (dq_p_pos, dq_p_rot), (dq_c_pos, dq_c_rot) = _position_update(g, qp_p, qp_c, pos_p, pos_c)

    axis_p_r = _rotate_frame(g.axis_p, qp_p.rot)
    axis_c_r = _rotate_frame(g.axis_c, qp_c.rot)
    axis = axis_p_r[..., 0, :]
    ref_p = axis_p_r[..., 2, :]
    ref_c = axis_c_r[..., 2, :]

    psi = maths.signed_angle(axis, ref_p, ref_c)
    axis_c_x = axis_c_r[..., 0, :]
    dq_1 = maths.cross(axis, axis_c_x)

    ph = torch.clamp(psi, g.limit[..., 0, 0], g.limit[..., 0, 1])
    fixrot = maths.quat_rot_axis(axis, ph)
    n1 = maths.rotate(ref_p, fixrot)
    dq_2 = maths.cross(n1, ref_c)

    # sum the angle rows first, then add them to the positional update
    ap1, ac1 = _angle_update(g, qp_p, qp_c, dq_1)
    ap2, ac2 = _angle_update(g, qp_p, qp_c, dq_2)
    dq_p_rot = dq_p_rot + (ap1 + ap2)
    dq_c_rot = dq_c_rot + (ac1 + ac2)

    pos = _scatter_add3(dq_p_pos, dq_c_pos, g.parent, g.child, nb)
    rot = _scatter_add3(dq_p_rot, dq_c_rot, g.parent, g.child, nb)
    return DQ(pos=pos, rot=rot)
