"""Dense batched joint constraints, batch-first.

Counterpart of `brax_tpu/sim/joints.py`.  Joints of one kind form a
`JointGroup` whose tables have a leading joint axis (nj, ...); they broadcast
against state gathered to (N, nj, ...) and scatter back onto the body axis
with one `index_add_`.  The PBD revolute and spherical joints (a spherical
joint's three Euler rows also hold the 1- and 2-dof joints that
`builder.build` pads to 3 dofs) move bodies at the position level
(`pbd_apply`); the legacy-spring revolute, universal (2 dofs: the parent's x
axis and the child's y axis, angles psi and theta) and spherical joints at
the acceleration level (`spring_apply`).
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

    kind: str  # 'revolute' | 'spherical' | 'spring_revolute' | 'spring_universal' | 'spring_spherical'
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


def _require_pbd(g: JointGroup):
    if g.kind not in ("revolute", "spherical"):
        raise ValueError(f"pbd_apply on non-pbd joint group: {g.kind}")


def _normalized(v: Tensor, eps: float) -> Tensor:
    return v / (eps + maths.safe_norm(v)[..., None])


def axis_angle(g: JointGroup, qp_p: QP, qp_c: QP):
    """Joint axes and angles: (..., nj, dof, 3), (..., nj, dof).

    A spherical joint's are its x-y'-z'' Euler angles about the line of
    nodes (psi, theta, phi) and the axes (parent x, child y, child z); a
    universal joint's the first two of each.
    """
    axis_p_r = _rotate_frame(g.axis_p, qp_p.rot)
    axis_c_r = _rotate_frame(g.axis_c, qp_c.rot)
    axis_1_p = axis_p_r[..., 0, :]
    if g.kind in ("revolute", "spring_revolute"):
        ref_p = axis_p_r[..., 2, :]
        ref_c = axis_c_r[..., 2, :]
        psi = maths.signed_angle(axis_1_p, ref_p, ref_c)
        return axis_1_p[..., None, :], psi[..., None]

    axis_2_p = axis_p_r[..., 1, :]
    axis_1_c, axis_2_c, axis_3_c = axis_c_r[..., 0, :], axis_c_r[..., 1, :], axis_c_r[..., 2, :]
    line_of_nodes = _normalized(maths.cross(axis_3_c, axis_1_p), 1e-10)
    psi = maths.signed_angle(axis_1_p, axis_2_p, line_of_nodes)
    in_xz = dot1(axis_1_p, axis_1_c) * axis_1_c + dot1(axis_1_p, axis_2_c) * axis_2_c
    in_xz = _normalized(in_xz, 1e-10)
    theta = (maths.safe_arccos(torch.clamp(vdot(in_xz, axis_1_p), -1, 1))
             * torch.sign(vdot(axis_1_p, axis_3_c)))
    if g.kind == "spring_universal":
        return torch.stack([axis_1_p, axis_2_c], dim=-2), torch.stack([psi, theta], dim=-1)
    phi = maths.signed_angle(-axis_3_c, axis_2_c, line_of_nodes)
    axes = torch.stack([axis_1_p, axis_2_c, axis_3_c], dim=-2)
    return axes, torch.stack([psi, theta, phi], dim=-1)


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
    """Position-based joint constraint update, scattered onto bodies."""
    _require_pbd(g)
    qp_p = qp.take(g.parent)
    qp_c = qp.take(g.child)

    pos_p, _ = qp_p.to_world(g.off_p)
    pos_c, _ = qp_c.to_world(g.off_c)
    (dq_p_pos, dq_p_rot), (dq_c_pos, dq_c_rot) = _position_update(g, qp_p, qp_c, pos_p, pos_c)

    axis_p_r = _rotate_frame(g.axis_p, qp_p.rot)
    axis_c_r = _rotate_frame(g.axis_c, qp_c.rot)
    rows = (_spherical_rows if g.kind == "spherical" else _revolute_rows)(
        g, qp_p, qp_c, axis_p_r, axis_c_r)
    # sum the angle rows first, then add them to the positional update
    rows_p, rows_c = rows[0]
    for ap, ac in rows[1:]:
        rows_p, rows_c = rows_p + ap, rows_c + ac
    dq_p_rot = dq_p_rot + rows_p
    dq_c_rot = dq_c_rot + rows_c

    pos = _scatter_add3(dq_p_pos, dq_c_pos, g.parent, g.child, nb)
    rot = _scatter_add3(dq_p_rot, dq_c_rot, g.parent, g.child, nb)
    return DQ(pos=pos, rot=rot)


def _revolute_rows(g: JointGroup, qp_p: QP, qp_c: QP, axis_p_r: Tensor, axis_c_r: Tensor):
    """A revolute joint's two angular rows, each (parent, child) quaternion
    updates: align the hinge axes, then hold the angle inside its limits."""
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
    return [_angle_update(g, qp_p, qp_c, dq_1), _angle_update(g, qp_p, qp_c, dq_2)]


def _spherical_rows(g: JointGroup, qp_p: QP, qp_c: QP, axis_p_r: Tensor, axis_c_r: Tensor):
    """A spherical joint's three Euler-angle rows, each (parent, child)
    quaternion updates: each row turns its angle back inside its limits,
    and only where the angle is outside them (the mask).  A padded dof's
    (0, 0) limits hold it at 0."""
    axis_1_p, axis_2_p = axis_p_r[..., 0, :], axis_p_r[..., 1, :]
    axis_1_c, axis_2_c, axis_3_c = axis_c_r[..., 0, :], axis_c_r[..., 1, :], axis_c_r[..., 2, :]
    line_of_nodes = _normalized(maths.cross(axis_3_c, axis_1_p), 1e-6)
    in_xz = dot1(axis_1_p, axis_1_c) * axis_1_c + dot1(axis_1_p, axis_2_c) * axis_2_c
    in_xz = _normalized(in_xz, 1e-6)
    axis_2_normal = _normalized(maths.cross(in_xz, axis_1_p), 1e-6)
    sgn = torch.sign(vdot(axis_1_p, axis_3_c))[..., None]
    rows = (
        (axis_1_p, axis_2_p, line_of_nodes),
        (-axis_2_normal * sgn, axis_1_p, in_xz),
        (axis_3_c, line_of_nodes, axis_2_c),  # -yc_n_normal == axis_3_c
    )
    updates = []
    for i, (n, n_1, n_2) in enumerate(rows):
        ph = maths.signed_angle(n, n_1, n_2)
        lo, hi = g.limit[..., i, 0], g.limit[..., i, 1]
        mask = torch.where((ph < lo) | (ph > hi), 1.0, 0.0)
        fixrot = maths.quat_rot_axis(n, torch.clamp(ph, lo, hi))
        dq_ang = maths.cross(maths.rotate(n_1, fixrot), n_2) * mask[..., None]
        updates.append(_angle_update(g, qp_p, qp_c, dq_ang))
    return updates


def _limit_excess(angles: Tensor, limit: Tensor) -> Tensor:
    """How far each angle lies outside its limits, toward them: lo - angle
    below, hi - angle above, 0 inside."""
    lo, hi = limit[..., 0], limit[..., 1]
    dang = torch.where(angles < lo, lo - angles, 0.0)
    return torch.where(angles > hi, hi - angles, dang)


def spring_apply(g: JointGroup, qp: QP, nb: int) -> DP:
    """Acceleration-level spring joint update, scattered onto bodies: a
    spring-damper pulling the two anchors together, the joint's angular
    spring (revolute: the hinge axes aligned; universal: the child's y axis
    held normal to the parent's x axis) and its limit springs, then the
    angular damping."""
    qp_p = qp.take(g.parent)
    qp_c = qp.take(g.child)

    pos_p, vel_p = qp_p.to_world(g.off_p)
    pos_c, vel_c = qp_c.to_world(g.off_c)

    # push the anchor points together
    impulse = ((pos_p - pos_c) * g.stiffness[..., None]
               + g.spring_damping[..., None] * (vel_p - vel_c))
    dvel_p = -impulse / g.mass_p[..., None]
    dang_p = g.inertia_p * maths.cross(pos_p - qp_p.pos, -impulse)
    dvel_c = impulse / g.mass_c[..., None]
    dang_c = g.inertia_c * maths.cross(pos_c - qp_c.pos, impulse)

    axes, angles = axis_angle(g, qp_p, qp_c)
    limit_strength = g.limit_strength[..., None]
    if g.kind == "spring_revolute":
        axis = axes[..., 0, :]
        axis_c_x = maths.rotate(g.axis_c[..., 0, :], qp_c.rot)
        torque = g.stiffness[..., None] * maths.cross(axis, axis_c_x)
        torque = torque - limit_strength * axis * _limit_excess(angles, g.limit)
    elif g.kind == "spring_universal":
        axis_1, axis_2 = axes[..., 0, :], axes[..., 1, :]
        proj = axis_2 - dot1(axis_2, axis_1) * axis_1
        proj = proj / maths.safe_norm(proj)[..., None]
        torque = (limit_strength / 5.0) * maths.cross(proj, axis_2)
        torque = torque - limit_strength * torch.sum(
            axes * _limit_excess(angles, g.limit)[..., None], dim=-2)
    elif g.kind == "spring_spherical":
        torque = -limit_strength * torch.sum(
            axes * _limit_excess(angles, g.limit)[..., None], dim=-2)
    else:
        raise ValueError(f"spring_apply on non-spring joint group: {g.kind}")

    torque = torque - g.angular_damping[..., None] * (qp_p.ang - qp_c.ang)
    dang_p = dang_p + g.inertia_p * torque
    dang_c = dang_c - g.inertia_c * torque

    vel = _scatter_add3(dvel_p, dvel_c, g.parent, g.child, nb)
    ang = _scatter_add3(dang_p, dang_c, g.parent, g.child, nb)
    return DP(vel=vel, ang=ang)
