"""Smooth dynamics in the CoM frame, batch-first.

Counterpart of `brax_tpu/v2/generalized/dynamics.py`: `transform_com` moves
inertias, dof axes and velocities into a frame at the system's centre of
mass, `inverse` is the recursive Newton-Euler bias force, and `forward`
adds the passive and applied forces.  The tree sums are products with the
static 0/1 structure matrices of `masks`.
"""

from __future__ import annotations

import torch

from brax_torch import maths
from brax_torch.v2 import masks, scan
from brax_torch.v2.base import Force, Motion, System, Tensor, Transform
from brax_torch.v2.generalized.base import State


def _mask(arr, ref: Tensor) -> Tensor:
    return torch.as_tensor(arr, dtype=ref.dtype, device=ref.device)


def _take_links(t: Transform, idx) -> Transform:
    """t[:, idx] with index -1 meaning the identity frame."""
    n = t.pos.shape[0]
    pad = Transform.zero((n, 1), t.pos.device)
    pos = torch.cat([t.pos, pad.pos], dim=1)
    rot = torch.cat([t.rot, pad.rot], dim=1)
    return Transform(pos=pos[:, idx], rot=rot[:, idx])


def com_parent(sys: System):
    """Each link's CoM-frame anchor: free links anchor to themselves."""
    return [i if t == "f" else p for i, (t, p) in enumerate(zip(sys.link_types, sys.link_parents))]


def transform_com(sys: System, state: State) -> State:
    """Updates com, cinr, cd, cdof and cdofd from q, qd and x."""
    xi = state.x.do(sys.link.inertia.transform)
    mass = sys.link.inertia.mass
    com = torch.sum(mass[:, None] * xi.pos, dim=-2) / torch.sum(mass)
    cinr = xi.replace(pos=xi.pos - com[:, None]).do(sys.link.inertia)
    cinr = cinr.replace(mass=cinr.mass.expand(xi.pos.shape[:2]))

    parent = _take_links(state.x, com_parent(sys))
    j = parent.do(sys.link.transform).do(sys.link.joint)

    q, n, nd = state.q, state.q.shape[0], sys.qd_size()
    motion = sys.dof.motion
    cdof_ang = q.new_zeros((n, nd, 3))
    cdof_vel = q.new_zeros((n, nd, 3))
    for g in scan.link_types(sys.link_types):
        qd_idx = list(g.qd)
        ang, vel = motion.ang[qd_idx], motion.vel[qd_idx]
        if g.typ == "f":
            cdof_ang[:, qd_idx], cdof_vel[:, qd_idx] = ang, vel
            continue
        k = int(g.typ)
        qg = q[:, list(g.q)]
        rot, _ = maths.normalize_with_norm(maths.quat_rot_axis(ang, qg))
        pos = vel * qg[..., None]
        stack = lambda x: x.reshape(n, -1, k, x.shape[-1])
        pos, rot = stack(pos), stack(rot)
        a_s = ang.reshape(-1, k, 3).expand(n, -1, -1, -1)
        v_s = vel.reshape(-1, k, 3).expand(n, -1, -1, -1)
        # each dof's motion seen through the preceding dofs' joint transforms
        acc = Transform.zero(pos.shape[:2], q.device)
        angs, vels = [], []
        for i in range(k):
            m = acc.inv().do(Motion(ang=a_s[:, :, i], vel=v_s[:, :, i]))
            angs.append(m.ang)
            vels.append(m.vel)
            acc = acc.do(Transform(pos=pos[:, :, i], rot=rot[:, :, i]))
        cdof_ang[:, qd_idx] = torch.stack(angs, dim=2).reshape(n, -1, 3)
        cdof_vel[:, qd_idx] = torch.stack(vels, dim=2).reshape(n, -1, 3)

    dof_link = sys.dof_link()
    cdof_ang = maths.rotate(cdof_ang, j.rot[:, dof_link])
    cdof = Transform.create(pos=com[:, None] - j.pos[:, dof_link]).do(
        Motion(ang=cdof_ang, vel=cdof_vel))
    qd = state.qd[..., None]
    cdof_qd = Motion(ang=cdof.ang * qd, vel=cdof.vel * qd)

    dof_anc = _mask(masks.ancestor_dofs(sys), q)
    cd = Motion(ang=dof_anc @ cdof_qd.ang, vel=dof_anc @ cdof_qd.vel)

    # cdofd: each cdof axis's velocity, from the velocity accumulated through
    # the preceding dofs of the same link
    cd_p = Motion(ang=torch.cat([cd.ang, q.new_zeros((n, 1, 3))], dim=1)[:, com_parent(sys)],
                  vel=torch.cat([cd.vel, q.new_zeros((n, 1, 3))], dim=1)[:, com_parent(sys)])
    cdofd_ang = q.new_zeros((n, nd, 3))
    cdofd_vel = q.new_zeros((n, nd, 3))
    for g in scan.link_types(sys.link_types):
        qd_idx, links = list(g.qd), list(g.links)
        c_ang, c_vel = cdof.ang[:, qd_idx], cdof.vel[:, qd_idx]
        cq_ang, cq_vel = cdof_qd.ang[:, qd_idx], cdof_qd.vel[:, qd_idx]
        if g.typ == "f":
            six = lambda x: x.reshape(n, -1, 6, 3)
            lin_ang = six(cq_ang)[:, :, 0:3].sum(dim=2, keepdim=True)
            lin_vel = six(cq_vel)[:, :, 0:3].sum(dim=2, keepdim=True)
            a = maths.cross(lin_ang, six(c_ang))
            v = maths.cross(lin_ang, six(c_vel)) + maths.cross(lin_vel, six(c_ang))
            a[:, :, 0:3] = 0.0
            v[:, :, 0:3] = 0.0
            cdofd_ang[:, qd_idx], cdofd_vel[:, qd_idx] = a.reshape(n, -1, 3), v.reshape(n, -1, 3)
            continue
        k = int(g.typ)
        stack = lambda x: x.reshape(n, -1, k, 3)
        cq_ang, cq_vel = stack(cq_ang), stack(cq_vel)
        cds = [Motion(ang=cd_p.ang[:, links], vel=cd_p.vel[:, links])]
        for i in range(k - 1):
            cds.append(cds[-1] + Motion(ang=cq_ang[:, :, i], vel=cq_vel[:, :, i]))
        cd_all = Motion(ang=torch.stack([c.ang for c in cds], dim=2).reshape(n, -1, 3),
                        vel=torch.stack([c.vel for c in cds], dim=2).reshape(n, -1, 3))
        out = cd_all.cross(Motion(ang=c_ang, vel=c_vel))
        cdofd_ang[:, qd_idx], cdofd_vel[:, qd_idx] = out.ang, out.vel

    return state.replace(com=com, cinr=cinr, cd=cd, cdof=cdof,
                         cdofd=Motion(ang=cdofd_ang, vel=cdofd_vel))


def inverse(sys: System, state: State) -> Tensor:
    """The RNE bias force (N, nd): gravity and velocity-product terms."""
    dof_anc = _mask(masks.ancestor_dofs(sys), state.q)
    qd = state.qd[..., None]
    cdd = Motion(ang=dof_anc @ (state.cdofd.ang * qd),
                 vel=dof_anc @ (state.cdofd.vel * qd) - sys.gravity)
    cfrc_flat = state.cinr.mul(cdd) + state.cd.cross(state.cinr.mul(state.cd))
    sub = _mask(masks.subtree_links(sys), state.q)
    cfrc = Force(ang=sub @ cfrc_flat.ang, vel=sub @ cfrc_flat.vel)
    dof_link = sys.dof_link()
    return state.cdof.dot(Force(ang=cfrc.ang[:, dof_link], vel=cfrc.vel[:, dof_link]))


def passive(sys: System, q: Tensor, qd: Tensor) -> Tensor:
    """Joint stiffness and damping forces (N, nd)."""
    frc = torch.zeros_like(qd)
    for g in scan.link_types(sys.link_types):
        if g.typ != "f":
            frc[:, list(g.qd)] = -q[:, list(g.q)] * sys.dof.stiffness[list(g.qd)]
    return frc - sys.dof.damping * qd


def forward(sys: System, state: State, tau: Tensor) -> Tensor:
    """Net smooth joint force: passive - bias + tau."""
    return passive(sys, state.q, state.qd) - inverse(sys, state) + tau
