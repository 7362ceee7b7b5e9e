"""Dense contact groups: narrowphase + impulse resolution, batch-first.

Counterpart of `brax_tpu/sim/colliders.py`.  A contact group holds all pairs
of one narrowphase type as static pair tables with a leading (np,) axis and
yields a manifold of shape (N, np, ncontact, ...).  Each body's update is
averaged over the contacts of the group that touch it, then summed across
groups.  This slice ports the one-way capsule-plane group (the second body
frozen, as the ground is): its PBD position and velocity passes and the
velocity-level impulse that `System.info` reports at reset.
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


def _b1(x: Tensor) -> Tensor:
    """Adds the contact axis to a per-pair table: (np, ...) -> (np, 1, ...)."""
    return x[:, None]


def _require_one_way(com: GroupCommon):
    if not com.one_way:
        raise NotImplementedError(
            "two-way contact groups are not ported yet (see ROADMAP.md, queue B item 1)"
        )


def _scatter_average(vals_a, com: GroupCommon, nb: int, eps: float):
    """Scatters per-contact updates onto bodies, averaged by contact count.

    vals_a is a tuple of (N, np, nc, W) tensors for body a of each pair.  Each
    body's sum is divided by (eps + the number of this group's contacts whose
    first update is non-zero).
    """
    n_pairs, nc = vals_a[0].shape[-3], vals_a[0].shape[-2]
    idx = np.repeat(com.body_a, nc)
    lead = vals_a[0].shape[:-3]

    def flat(v):
        return v.reshape(lead + (n_pairs * nc, v.shape[-1]))

    first = flat(vals_a[0])
    count = torch.any(first != 0, dim=-1, keepdim=True).to(first.dtype)
    count = scatter_add_bodies(first.new_zeros(lead + (nb, 1)), idx, count)
    denom = eps + count

    outs = []
    for v in vals_a:
        f = flat(v)
        acc = scatter_add_bodies(f.new_zeros(lead + (nb, f.shape[-1])), idx, f)
        outs.append(acc / denom)
    return outs


def spring_apply(group: CapsulePlane, qp: QP, params: SolverParams, nb: int):
    """Velocity-level impulse contact (the reset-time `System.info`)."""
    com = group.com
    _require_one_way(com)
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
    ang = vdot(contact.normal, maths.cross(temp1, rel_pos_a))
    denom = (1.0 / mass_a) + ang

    impulse = (-1.0 * (1.0 + elasticity) * normal_vel + baumgarte_vel) / denom

    def body_impulse(imp_vec):
        dvel = imp_vec / mass_a[..., None]
        dang = inertia_a * maths.cross(contact.pos - pos_a, imp_vec)
        return dvel, dang

    imp_n = impulse[..., None] * contact.normal
    dvel_na, dang_na = body_impulse(imp_n)

    vel_d = contact.vel - normal_vel[..., None] * contact.normal
    impulse_d = maths.safe_norm(vel_d) / denom
    impulse_d = torch.minimum(impulse_d, friction * impulse)
    dir_d = vel_d / (1e-6 + maths.safe_norm(vel_d)[..., None])
    dvel_da, dang_da = body_impulse(-impulse_d[..., None] * dir_d)

    apply_n = ((contact.penetration > 0.0) & (normal_vel < 0) & (impulse > 0.0)).to(impulse.dtype)
    apply_d = apply_n * (maths.safe_norm(vel_d) > 0.01).to(impulse.dtype)

    an = apply_n[..., None]
    ad = apply_d[..., None]
    dp_a = (dvel_na * an + dvel_da * ad, dang_na * an + dang_da * ad)
    vel, angv = _scatter_average(dp_a, com, nb, eps=1e-8)
    return DP(vel=vel, ang=angv), contact


def position_apply(group: CapsulePlane, qp: QP, qp_prev: QP, params: SolverParams, nb: int):
    """PBD position-level contact pass with static friction (one-way)."""
    com = group.com
    _require_one_way(com)
    qp_a = qp.take(com.body_a)
    qp_a_old = qp_prev.take(com.body_a)
    contact = group.contact(qp_a, qp.take(com.body_b))

    friction = _b1(com.friction)
    inertia_a = com.inertia_a[:, None, :]
    mass_a = _b1(com.mass_a)[..., None]
    pos_a = qp_a.pos[..., None, :]
    rot_a = qp_a.rot[..., None, :]
    cs = params.collide_scale

    pos_p = contact.pos
    pos_c = contact.pos + contact.normal * contact.penetration[..., None]
    dx = pos_p - pos_c
    arm_p = pos_p - pos_a

    n = contact.normal
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
    dq_p_rot = dq_p_rot + cs * (0.5 * maths.vec_quat_mul(inertia_a * maths.cross(arm_p, pt), rot_a))

    pos_out, rot_out = _scatter_average((dq_p_pos, dq_p_rot), com, nb, eps=1e-6)
    return DQ(pos=pos_out, rot=rot_out), dlambda * coll_mask, contact


def velocity_apply(group: CapsulePlane, qp: QP, dlambda: Tensor, qp_prev: QP,
                   contact: Contact, params: SolverParams, nb: int) -> DP:
    """PBD velocity-level contact pass: dynamic friction and restitution."""
    com = group.com
    _require_one_way(com)
    qp_a = qp.take(com.body_a)
    qp_a_old = qp_prev.take(com.body_a)

    friction = _b1(com.friction)
    elasticity = _b1(com.elasticity)
    inertia_a = com.inertia_a[:, None, :]
    mass_a = _b1(com.mass_a)
    pos_a = qp_a.pos[..., None, :]

    n = contact.normal
    rel_vel = qp_a.vel[..., None, :] + maths.cross(qp_a.ang[..., None, :], contact.pos - pos_a)

    v_n = vdot(rel_vel, n)
    v_t = rel_vel - n * v_n[..., None]
    v_t_norm = maths.safe_norm(v_t)
    v_t_dir = v_t / (1e-6 + v_t_norm[..., None])

    # factor of 2: one collision pass per two physics substeps
    dvel_mag = -torch.minimum(friction * torch.abs(dlambda) / (2.0 * params.h), v_t_norm)
    dvel = v_t_dir * dvel_mag[..., None]

    angw = maths.cross(contact.pos - pos_a, v_t_dir)
    w = (1.0 / mass_a) + vdot(angw, angw)  # no inertia term, as in the reference
    p_dyn = dvel / (w[..., None] + 1e-6)

    # restitution
    rel_vel_old = qp_a_old.vel[..., None, :] + maths.cross(
        qp_a_old.ang[..., None, :], contact.pos - qp_a_old.pos[..., None, :]
    )
    v_n_old = vdot(rel_vel_old, n)

    dv_rest = n * (-v_n - torch.minimum(elasticity * v_n_old, torch.zeros_like(v_n_old)))[..., None]

    arm_p = contact.pos - pos_a
    c = maths.safe_norm(dv_rest)
    nr = dv_rest / (c[..., None] + 1e-6)

    cr1 = maths.cross(arm_p, nr)
    w1r = (1.0 / mass_a) + vdot(cr1, inertia_a * cr1)
    dlambda_rest = c / (w1r + 1e-6)
    sinking = (v_n_old <= -params.velocity_threshold).to(c.dtype)

    static_mask = (contact.penetration > 0).to(c.dtype)
    p = (dlambda_rest[..., None] * nr * sinking[..., None] + p_dyn) * static_mask[..., None]

    dp_a = (p / mass_a[..., None], maths.cross(inertia_a * (contact.pos - pos_a), p))
    vel, angv = _scatter_average(dp_a, com, nb, eps=1e-6)
    return DP(vel=vel, ang=angv)
