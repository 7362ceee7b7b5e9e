"""Dense contact groups: narrowphase + impulse resolution, batch-first.

Counterpart of `brax_tpu/sim/colliders.py`.  A contact group holds all pairs
of one narrowphase type as static pair tables with a leading (np,) axis and
yields a manifold of shape (N, np, ncontact, ...).  Each body's update is
averaged over the contacts of the group that touch it, then summed across
groups.  Ported: the one-way capsule-plane and box-plane groups (the second
body frozen, as the ground is; a box's eight corners are its contacts) and
the capsule-capsule groups, two-way (both bodies
move) and one-way (the second capsule's body frozen, as grasp's palm is:
only the first body is moved, and only its mass and inertia enter the
updates): their PBD position and velocity passes and the velocity-level
impulse that `System.info` reports at reset.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from brax_torch import maths
from brax_torch.maths import dot1, vdot
from brax_torch.sim import geometry
from brax_torch.sim.joints import scatter_add_bodies
from brax_torch.sim.types import DP, DQ, QP, Contact, Tensor


@dataclass
class SolverParams:
    """Global contact-solver parameters."""

    baumgarte_erp: float
    h: float  # dt / substeps
    collide_scale: float
    velocity_threshold: float


@dataclass
class GroupCommon:
    """Per-pair physical parameters of a contact group."""

    body_a: np.ndarray  # (np,)
    body_b: np.ndarray
    one_way: bool
    friction: Tensor = None  # (np,) product of the two colliders' frictions
    elasticity: Tensor = None  # (np,) product
    mass_a: Tensor = None  # (np,)
    inertia_a: Tensor = None  # (np, 3) inverse inertia diagonal
    mass_b: Tensor = None
    inertia_b: Tensor = None


@dataclass
class CapsulePlane:
    """Capsule sphere-ends vs an infinite +z plane."""

    com: GroupCommon
    end: Tensor = None  # (np, ne, 3) body-local cap centers (incl. collider offset)
    radius: Tensor = None  # (np,)

    def contact(self, qp_a: QP, qp_b: QP) -> Contact:
        pos, normal, penetration = geometry.cap_ends_plane(
            qp_a.pos, qp_a.rot, self.end, self.radius, qp_b.pos, qp_b.rot
        )
        vel = qp_a.vel[..., None, :] + maths.cross(
            qp_a.ang[..., None, :], pos - qp_a.pos[..., None, :]
        )
        return Contact(pos, vel, normal.expand(pos.shape), penetration)


@dataclass
class BoxPlane:
    """Box corners vs an infinite +z plane: a capsule-plane contact of
    radius 0 at each corner."""

    com: GroupCommon
    corner: Tensor = None  # (np, 8, 3) body-local corners (incl. collider offset)

    def contact(self, qp_a: QP, qp_b: QP) -> Contact:
        rpos_off = maths.rotate(self.corner, qp_a.rot[..., None, :])
        pos = qp_a.pos[..., None, :] + rpos_off
        vel = qp_a.vel[..., None, :] + maths.cross(qp_a.ang[..., None, :], rpos_off)
        z = torch.zeros_like(qp_b.pos)
        z[..., 2] = 1.0
        normal = maths.rotate(z, qp_b.rot)[..., None, :]
        penetration = vdot(qp_b.pos[..., None, :] - pos, normal)
        return Contact(pos, vel, normal.expand(pos.shape), penetration)


@dataclass
class CapsuleCapsule:
    """Capsule vs capsule, one contact per pair, both bodies moving."""

    com: GroupCommon
    end_a: Tensor = None  # (np, 3) axis * half the segment length
    off_a: Tensor = None  # (np, 3) collider position offset
    radius_a: Tensor = None  # (np,)
    end_b: Tensor = None
    off_b: Tensor = None
    radius_b: Tensor = None

    def contact(self, qp_a: QP, qp_b: QP) -> Contact:
        def endpoints(end, qp, offset):
            pos = qp.pos + maths.rotate(offset, qp.rot)
            e = maths.rotate(end, qp.rot)
            return pos + e, pos - e

        a0, a1 = endpoints(self.end_a, qp_a, self.off_a)
        b0, b1 = endpoints(self.end_b, qp_b, self.off_b)
        a_best, b_best = geometry.closest_segment_to_segment_points(a0, a1, b0, b1)

        pen_vec = a_best - b_best
        dist = maths.safe_norm(pen_vec)
        normal = pen_vec / (1e-6 + dist[..., None])
        penetration = self.radius_a + self.radius_b - dist
        pos = (a_best + b_best) / 2
        vel = (qp_a.vel + maths.cross(qp_a.ang, pos - qp_a.pos)
               - (qp_b.vel + maths.cross(qp_b.ang, pos - qp_b.pos)))
        return Contact(pos[..., None, :], vel[..., None, :], normal[..., None, :],
                       penetration[..., None])


def _b1(x: Tensor) -> Tensor:
    """Adds the contact axis to a per-pair table: (np, ...) -> (np, 1, ...)."""
    return x[:, None]


def _check_ported(group):
    """Every group but the one-way capsule-plane and box-plane ones and the
    capsule-capsule ones is still queued."""
    if isinstance(group, (CapsulePlane, BoxPlane)) and not group.com.one_way:
        raise NotImplementedError(
            f"two-way {type(group).__name__} contacts are not ported yet (see ROADMAP.md, "
            "queue B item 1)")


def _scatter_average(vals_a, vals_b, com: GroupCommon, nb: int, eps: float):
    """Scatters per-contact updates onto bodies, averaged by contact count.

    vals_a (and vals_b, None for a one-way group) are tuples of
    (N, np, nc, W) tensors for body a (b) of each pair.  Body a's updates are
    added first, then body b's.  Each body's sum is divided by (eps + the
    number of this group's updates to it whose first tensor is non-zero).
    """
    n_pairs, nc = vals_a[0].shape[-3], vals_a[0].shape[-2]
    parts = [(vals_a, com.body_a)] + ([] if vals_b is None else [(vals_b, com.body_b)])
    idx = np.concatenate([np.repeat(body, nc) for _, body in parts])
    lead = vals_a[0].shape[:-3]

    def flat(k):
        return torch.cat([v[k].reshape(lead + (n_pairs * nc, v[k].shape[-1]))
                          for v, _ in parts], dim=-2)

    first = flat(0)
    count = torch.any(first != 0, dim=-1, keepdim=True).to(first.dtype)
    count = scatter_add_bodies(first.new_zeros(lead + (nb, 1)), idx, count)
    denom = eps + count

    outs = []
    for k in range(len(vals_a)):
        f = flat(k)
        acc = scatter_add_bodies(f.new_zeros(lead + (nb, f.shape[-1])), idx, f)
        outs.append(acc / denom)
    return outs


def spring_apply(group, qp: QP, params: SolverParams, nb: int):
    """Velocity-level impulse contact (the reset-time `System.info`)."""
    com = group.com
    _check_ported(group)
    qp_a, qp_b = qp.take(com.body_a), qp.take(com.body_b)
    contact = group.contact(qp_a, qp_b)

    elasticity = _b1(com.elasticity)
    friction = _b1(com.friction)
    inertia_a = com.inertia_a[:, None, :]
    mass_a = _b1(com.mass_a)
    pos_a = qp_a.pos[..., None, :]

    rel_pos_a = contact.pos - pos_a
    baumgarte_vel = params.baumgarte_erp * contact.penetration
    normal_vel = vdot(contact.normal, contact.vel)
    temp1 = inertia_a * maths.cross(rel_pos_a, contact.normal)
    if com.one_way:
        ang = vdot(contact.normal, maths.cross(temp1, rel_pos_a))
        denom = (1.0 / mass_a) + ang
    else:
        inertia_b = com.inertia_b[:, None, :]
        mass_b = _b1(com.mass_b)
        pos_b = qp_b.pos[..., None, :]
        rel_pos_b = contact.pos - pos_b
        temp2 = inertia_b * maths.cross(rel_pos_b, contact.normal)
        ang = vdot(contact.normal,
                   maths.cross(temp1, rel_pos_a) + maths.cross(temp2, rel_pos_b))
        denom = (1.0 / mass_a) + (1.0 / mass_b) + ang

    impulse = (-1.0 * (1.0 + elasticity) * normal_vel + baumgarte_vel) / denom

    def body_impulse(mass, inertia, qpos, imp_vec):
        dvel = imp_vec / mass[..., None]
        dang = inertia * maths.cross(contact.pos - qpos, imp_vec)
        return dvel, dang

    imp_n = impulse[..., None] * contact.normal
    dvel_na, dang_na = body_impulse(mass_a, inertia_a, pos_a, imp_n)

    vel_d = contact.vel - normal_vel[..., None] * contact.normal
    impulse_d = maths.safe_norm(vel_d) / denom
    impulse_d = torch.minimum(impulse_d, friction * impulse)
    dir_d = vel_d / (1e-6 + maths.safe_norm(vel_d)[..., None])
    dvel_da, dang_da = body_impulse(mass_a, inertia_a, pos_a, -impulse_d[..., None] * dir_d)

    apply_n = ((contact.penetration > 0.0) & (normal_vel < 0) & (impulse > 0.0)).to(impulse.dtype)
    apply_d = apply_n * (maths.safe_norm(vel_d) > 0.01).to(impulse.dtype)

    an = apply_n[..., None]
    ad = apply_d[..., None]
    dp_a = (dvel_na * an + dvel_da * ad, dang_na * an + dang_da * ad)
    dp_b = None
    if not com.one_way:
        dvel_nb, dang_nb = body_impulse(mass_b, inertia_b, pos_b, -imp_n)
        dvel_db, dang_db = body_impulse(mass_b, inertia_b, pos_b, impulse_d[..., None] * dir_d)
        dp_b = (dvel_nb * an + dvel_db * ad, dang_nb * an + dang_db * ad)
    vel, angv = _scatter_average(dp_a, dp_b, com, nb, eps=1e-8)
    return DP(vel=vel, ang=angv), contact


def position_apply(group, qp: QP, qp_prev: QP, params: SolverParams, nb: int):
    """PBD position-level contact pass with static friction.

    Returns the per-body update, each contact's dlambda (masked by its
    collision for a one-way group, unmasked for a two-way one, as in the
    JAX package) and the contact manifold."""
    com = group.com
    _check_ported(group)
    qp_a, qp_b = qp.take(com.body_a), qp.take(com.body_b)
    qp_a_old = qp_prev.take(com.body_a)
    contact = group.contact(qp_a, qp_b)

    friction = _b1(com.friction)
    inertia_a = com.inertia_a[:, None, :]
    mass_a = _b1(com.mass_a)[..., None]
    pos_a = qp_a.pos[..., None, :]
    rot_a = qp_a.rot[..., None, :]
    cs = params.collide_scale
    n = contact.normal

    if com.one_way:
        pos_p = contact.pos
        pos_c = contact.pos + contact.normal * contact.penetration[..., None]
        dx = pos_p - pos_c
        arm_p = pos_p - pos_a
        c = vdot(dx, n)

        cr1 = maths.cross(arm_p, n)
        w1 = (1.0 / mass_a[..., 0]) + vdot(cr1, inertia_a * cr1)

        dlambda = -c / (w1 + 1e-6)
        coll_mask = (c < 0).to(c.dtype)
        p = dlambda[..., None] * n * coll_mask[..., None]

        dq_p_pos = cs * (p / mass_a)
        dq_p_rot = cs * (0.5 * maths.vec_quat_mul(inertia_a * maths.cross(arm_p, p), rot_a))

        # static friction
        r1 = maths.rotate(contact.pos - pos_a, maths.quat_inv(rot_a))
        p1bar = qp_a_old.pos[..., None, :] + maths.rotate(r1, qp_a_old.rot[..., None, :])
        deltap = contact.pos - p1bar
        deltap_t = deltap - dot1(deltap, n) * n

        ct = maths.safe_norm(deltap_t)
        nt = deltap_t / (ct[..., None] + 1e-6)
        cr1t = maths.cross(arm_p, nt)
        w1t = (1.0 / mass_a[..., 0]) + vdot(cr1t, inertia_a * cr1t)
        dlambdat = -ct / w1t
        static_mask = (torch.abs(dlambdat) < torch.abs(friction * dlambda)).to(c.dtype)
        pt = dlambdat[..., None] * nt * static_mask[..., None] * coll_mask[..., None]

        dq_p_pos = dq_p_pos + cs * (pt / mass_a)
        dq_p_rot = dq_p_rot + cs * (0.5 * maths.vec_quat_mul(
            inertia_a * maths.cross(arm_p, pt), rot_a))
        vals_b = None
        dlambda_out = dlambda * coll_mask
    else:
        qp_b_old = qp_prev.take(com.body_b)
        inertia_b = com.inertia_b[:, None, :]
        mass_b = _b1(com.mass_b)[..., None]
        pos_b = qp_b.pos[..., None, :]
        rot_b = qp_b.rot[..., None, :]

        pen = contact.penetration[..., None]
        pos_p = contact.pos - contact.normal * pen / 2.0
        pos_c = contact.pos + contact.normal * pen / 2.0
        arm_p = pos_p - pos_a
        arm_c = pos_c - pos_b
        c = -contact.penetration

        cr1 = maths.cross(arm_p, n)
        w1 = (1.0 / mass_a[..., 0]) + vdot(cr1, inertia_a * cr1)
        cr2 = maths.cross(arm_c, n)
        w2 = (1.0 / mass_b[..., 0]) + vdot(cr2, inertia_b * cr2)

        dlambda = -c / (w1 + w2 + 1e-6)
        coll_mask = (c < 0).to(c.dtype)
        p = dlambda[..., None] * n * coll_mask[..., None]

        dq_p_pos = cs * (p / mass_a)
        dq_p_rot = cs * (0.5 * maths.vec_quat_mul(inertia_a * maths.cross(arm_p, p), rot_a))
        dq_c_pos = cs * (-p / mass_b)
        dq_c_rot = cs * (-0.5 * maths.vec_quat_mul(inertia_b * maths.cross(arm_c, p), rot_b))

        # static friction
        r1 = maths.rotate(contact.pos - pos_a, maths.quat_inv(rot_a))
        r2 = maths.rotate(contact.pos - pos_b, maths.quat_inv(rot_b))
        p1bar = qp_a_old.pos[..., None, :] + maths.rotate(r1, qp_a_old.rot[..., None, :])
        p2bar = qp_b_old.pos[..., None, :] + maths.rotate(r2, qp_b_old.rot[..., None, :])
        deltap = (contact.pos - p1bar) - (contact.pos - p2bar)
        deltap_t = deltap - dot1(deltap, n) * n

        arm_p2 = contact.pos - pos_a
        arm_c2 = contact.pos - pos_b

        ct = maths.safe_norm(deltap_t)
        nt = deltap_t / (ct[..., None] + 1e-6)
        cr1t = maths.cross(arm_p2, nt)
        w1t = (1.0 / mass_a[..., 0]) + vdot(cr1t, inertia_a * cr1t)
        cr2t = maths.cross(arm_c2, nt)
        w2t = (1.0 / mass_b[..., 0]) + vdot(cr2t, inertia_b * cr2t)
        dlambdat = -ct / (w1t + w2t)
        static_mask = (torch.abs(dlambdat) < torch.abs(dlambda)).to(c.dtype)
        pt = dlambdat[..., None] * nt * static_mask[..., None] * coll_mask[..., None]

        dq_p_pos = dq_p_pos + cs * (pt / mass_a)
        dq_p_rot = dq_p_rot + cs * (0.5 * maths.vec_quat_mul(
            inertia_a * maths.cross(arm_p2, pt), rot_a))
        dq_c_pos = dq_c_pos + cs * (-pt / mass_b)
        dq_c_rot = dq_c_rot + cs * (0.5 * maths.vec_quat_mul(
            inertia_b * maths.cross(arm_c2, -pt), rot_b))
        vals_b = (dq_c_pos, dq_c_rot)
        dlambda_out = dlambda

    pos_out, rot_out = _scatter_average((dq_p_pos, dq_p_rot), vals_b, com, nb, eps=1e-6)
    return DQ(pos=pos_out, rot=rot_out), dlambda_out, contact


def velocity_apply(group, qp: QP, dlambda: Tensor, qp_prev: QP,
                   contact: Contact, params: SolverParams, nb: int) -> DP:
    """PBD velocity-level contact pass: dynamic friction and restitution."""
    com = group.com
    _check_ported(group)
    qp_a, qp_b = qp.take(com.body_a), qp.take(com.body_b)
    qp_a_old, qp_b_old = qp_prev.take(com.body_a), qp_prev.take(com.body_b)

    friction = _b1(com.friction)
    elasticity = _b1(com.elasticity)
    inertia_a = com.inertia_a[:, None, :]
    mass_a = _b1(com.mass_a)
    pos_a = qp_a.pos[..., None, :]
    pos_b = qp_b.pos[..., None, :]

    def point_vel(q, at):
        return q.vel[..., None, :] + maths.cross(q.ang[..., None, :], at - q.pos[..., None, :])

    n = contact.normal
    rel_vel = point_vel(qp_a, contact.pos)
    if not com.one_way:
        rel_vel = rel_vel - point_vel(qp_b, contact.pos)

    v_n = vdot(rel_vel, n)
    v_t = rel_vel - n * v_n[..., None]
    v_t_norm = maths.safe_norm(v_t)
    v_t_dir = v_t / (1e-6 + v_t_norm[..., None])

    # factor of 2: one collision pass per two physics substeps
    dvel_mag = -torch.minimum(friction * torch.abs(dlambda) / (2.0 * params.h), v_t_norm)
    dvel = v_t_dir * dvel_mag[..., None]

    if com.one_way:
        angw = maths.cross(contact.pos - pos_a, v_t_dir)
        w = (1.0 / mass_a) + vdot(angw, angw)  # no inertia term, as in the reference
        p_dyn = dvel / (w[..., None] + 1e-6)
    else:
        inertia_b = com.inertia_b[:, None, :]
        mass_b = _b1(com.mass_b)
        angw_1 = maths.cross(contact.pos - pos_a, v_t_dir)
        angw_2 = maths.cross(contact.pos - pos_b, v_t_dir)
        w1 = (1.0 / mass_a) + vdot(angw_1, inertia_a * angw_1)
        w2 = (1.0 / mass_b) + vdot(angw_2, inertia_b * angw_2)
        p_dyn = dvel / ((w1 + w2)[..., None] + 1e-6)

    # restitution
    rel_vel_old = point_vel(qp_a_old, contact.pos)
    if not com.one_way:
        rel_vel_old = rel_vel_old - point_vel(qp_b_old, contact.pos)
    v_n_old = vdot(rel_vel_old, n)

    dv_rest = n * (-v_n - torch.minimum(elasticity * v_n_old, torch.zeros_like(v_n_old)))[..., None]

    arm_p = contact.pos - pos_a
    c = maths.safe_norm(dv_rest)
    nr = dv_rest / (c[..., None] + 1e-6)

    cr1 = maths.cross(arm_p, nr)
    w1r = (1.0 / mass_a) + vdot(cr1, inertia_a * cr1)
    if com.one_way:
        dlambda_rest = c / (w1r + 1e-6)
        sinking = (v_n_old <= -params.velocity_threshold).to(c.dtype)
    else:
        arm_c = contact.pos + contact.normal * contact.penetration[..., None] - pos_b
        cr2 = maths.cross(arm_c, nr)
        w2r = (1.0 / mass_b) + vdot(cr2, inertia_b * cr2)
        dlambda_rest = c / (w1r + w2r + 1e-6)
        sinking = (v_n_old <= 0.0).to(c.dtype)

    static_mask = (contact.penetration > 0).to(c.dtype)
    p = (dlambda_rest[..., None] * nr * sinking[..., None] + p_dyn) * static_mask[..., None]

    dp_a = (p / mass_a[..., None], maths.cross(inertia_a * (contact.pos - pos_a), p))
    dp_b = None
    if not com.one_way:
        dp_b = (-p / mass_b[..., None], maths.cross(inertia_b * (contact.pos - pos_b), -p))
    vel, angv = _scatter_average(dp_a, dp_b, com, nb, eps=1e-6)
    return DP(vel=vel, ang=angv)
