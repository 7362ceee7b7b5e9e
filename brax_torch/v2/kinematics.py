"""Forward kinematics over the link tree, batch-first.

Counterpart of `brax_tpu/v2/kinematics.py::forward`.  Links are walked in
index order (a parent comes before its children), one (N, 3) or (N, 4)
tensor per link, with the sums of `ordered`: the generalized kernel's plain
version (`generalized/kernels.py::gen_step_plain`) runs these functions as
they are.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from brax_torch import maths
from brax_torch.v2 import ordered, scan
from brax_torch.v2.base import Motion, System, Tensor, Transform


def _dof_transform(sys: System, d: int, qi: Tensor) -> Tuple[Tensor, Tensor]:
    """Position and rotation of one hinge or slide dof at coordinate qi (N,)."""
    motion = sys.dof.motion
    rot = ordered.normalize(maths.quat_rot_axis(motion.ang[d], qi))
    return motion.vel[d] * qi[:, None], rot


def transforms(sys: System, q: Tensor, unit: bool = True) -> Tuple[List[Tensor], List[Tensor]]:
    """World positions (N, 3) and rotations (N, 4) of every link.

    The rotations are normalised unless `unit` is False: then they are the
    products down the tree, which stray from unit length where q's free-joint
    quaternions do.  The JAX pipeline rotates link velocities by those, the
    JAX kernel by the normalised ones.
    """
    q_off, qd_off = scan.offsets(sys.link_types)
    link = sys.link
    j_pos, j_rot = [], []
    for l, t in enumerate(sys.link_types):
        qo = q_off[l]
        if t == "f":
            jp, jr = q[:, qo:qo + 3], q[:, qo + 3:qo + 7]
        else:
            jp = jr = None
            for i in range(int(t)):
                pos_i, rot_i = _dof_transform(sys, qd_off[l] + i, q[:, qo + i])
                if jp is None:
                    jp, jr = pos_i, rot_i
                else:
                    jp = jp + ordered.rotate(pos_i, jr)
                    jr = maths.quat_mul(jr, rot_i)
        # joint position offset, then the link's frame in its parent
        jpos, t_rot = link.joint.pos[l], link.transform.rot[l]
        jp = jp + jpos - ordered.rotate(jpos, jr)
        j_pos.append(link.transform.pos[l] + ordered.rotate(jp, t_rot))
        j_rot.append(maths.quat_mul(t_rot.expand_as(jr), jr))
    x_pos, x_rot = [], []
    for l, par in enumerate(sys.link_parents):
        if par == -1:
            x_pos.append(j_pos[l])
            x_rot.append(j_rot[l])
        else:
            x_pos.append(x_pos[par] + ordered.rotate(j_pos[l], x_rot[par]))
            x_rot.append(maths.quat_mul(x_rot[par], j_rot[l]))
    return x_pos, [ordered.normalize(r) for r in x_rot] if unit else x_rot


def motions(sys: System, q: Tensor, qd: Tensor, x_pos: List[Tensor],
            x_rot: List[Tensor]) -> Tuple[List[Tensor], List[Tensor]]:
    """World angular and linear velocities (N, 3) of every link, given the
    links' world positions and rotations (`transforms`)."""
    q_off, qd_off = scan.offsets(sys.link_types)
    motion = sys.dof.motion
    jd_ang, jd_vel = [], []
    for l, t in enumerate(sys.link_types):
        do, qo = qd_off[l], q_off[l]
        if t == "f":
            jd_ang.append(qd[:, do + 3:do + 6])
            jd_vel.append(qd[:, do:do + 3])
            continue
        ja = motion.ang[do] * qd[:, do, None]
        jv = motion.vel[do] * qd[:, do, None]
        for i in range(1, int(t)):
            d = do + i
            pos_i, rot_i = _dof_transform(sys, d, q[:, qo + i])
            a_i = motion.ang[d] * qd[:, d, None]
            v_i = motion.vel[d] * qd[:, d, None]
            ja = ja + ordered.rotate(a_i, rot_i)
            jv = jv + ordered.rotate(v_i + maths.cross(pos_i, a_i), rot_i)
        jd_ang.append(ja)
        jd_vel.append(jv)
    xd_ang, xd_vel = [], []
    for l, par in enumerate(sys.link_parents):
        if par == -1:
            xd_ang.append(jd_ang[l])
            xd_vel.append(jd_vel[l])
        else:
            xd_ang.append(xd_ang[par] + ordered.rotate(jd_ang[l], x_rot[l]))
            xd_vel.append(xd_vel[par] + ordered.rotate(
                jd_vel[l] + maths.cross(x_pos[l], jd_ang[l]), x_rot[l]))
    return xd_ang, xd_vel


def forward(sys: System, q: Tensor, qd: Tensor) -> Tuple[Transform, Motion]:
    """Joint positions (N, nq) and velocities (N, nd) -> world transforms
    and motions of every link, (N, nl, ...)."""
    x_pos, x_rot = transforms(sys, q, unit=False)
    xd_ang, xd_vel = motions(sys, q, qd, x_pos, x_rot)
    stack = lambda xs: torch.stack(xs, dim=1)
    return (Transform(pos=stack(x_pos), rot=stack([ordered.normalize(r) for r in x_rot])),
            Motion(ang=stack(xd_ang), vel=stack(xd_vel)))
