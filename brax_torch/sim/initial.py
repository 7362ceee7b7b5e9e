"""Initial-state construction: default joint angles and default QP, batched.

Counterpart of `brax_tpu/sim/initial.py`.  Bodies are placed by walking the
kinematic tree in depth order, applying joint rotations and offsets; then
every tree without an explicit default pose is raised so that its lowest
collider touches z=0.  `default_qp` takes a batch of joint angles and
velocities (N, ndof) and returns a batch-first QP (N, nb, ...).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from brax_torch import maths
from brax_torch.sim import config as cfg
from brax_torch.sim.builder import BuildArtifacts, np_euler_to_quat
from brax_torch.sim.geometry import BOX_CORNERS
from brax_torch.sim.types import QP, Tensor


def _joint_dof(j: cfg.Joint) -> int:
    """Number of live (nonzero-limit) dofs."""
    return sum(lo != 0 or hi != 0 for lo, hi in j.angle_limits)


def _f32(x, device) -> Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def default_angle(art: BuildArtifacts, default_index: int = 0, device="cuda") -> Tensor:
    """Default joint angles (radians), (ndof,)."""
    config = art.config
    if not config.joints:
        return torch.zeros((0,), device=device)

    dofs = {j.name: _joint_dof(j) for j in config.joints}
    angles: Dict[str, Tensor] = {}
    if default_index < len(config.defaults):
        for ja in config.defaults[default_index].angles:
            angles[ja.name] = _f32(ja.angle[: dofs[ja.name]], device) * math.pi / 180
    for joint in config.joints:
        if joint.name not in angles:
            dof = dofs[joint.name]
            angles[joint.name] = _f32(
                [(lo + hi) * np.pi / 360 for lo, hi in joint.angle_limits][:dof], device
            )
    return torch.cat([angles[j.name] for j in config.joints])


def default_qp(
    art: BuildArtifacts,
    default_index: int = 0,
    joint_angle: Optional[Tensor] = None,
    joint_velocity: Optional[Tensor] = None,
    device="cuda",
) -> QP:
    """Default system state for a batch of joint angles/velocities (N, ndof).

    Without joint_angle, the default angles make a batch of one.
    """
    config = art.config
    body_index = art.body_index
    nb = len(config.bodies)
    num_joint_dof = sum(_joint_dof(j) for j in config.joints)

    if joint_angle is None:
        joint_angle = default_angle(art, default_index, device)[None]
    device = joint_angle.device
    if joint_velocity is None:
        joint_velocity = torch.zeros_like(joint_angle)
    n = joint_angle.shape[0]
    qp = QP.zero((n, nb), device=device)

    default = None
    if default_index < len(config.defaults):
        default = config.defaults[default_index]
        for dqp in default.qps:
            i = body_index[dqp.name]
            qp.pos[:, i] = _f32(dqp.pos, device)
            qp.rot[:, i] = _f32(np_euler_to_quat(dqp.rot), device)
            qp.vel[:, i] = _f32(dqp.vel, device)
            qp.ang[:, i] = _f32(dqp.ang, device)

    # order joints by depth of parent in the kinematic tree
    joint_idxs = []
    beg = 0
    for j in config.joints:
        dof = _joint_dof(j)
        joint_idxs.append((j, (beg, beg + dof)))
        beg += dof
    lineage = {j.child: j.parent for j in config.joints}
    depth = {}
    for child, parent in lineage.items():
        depth[child] = 1
        while parent in lineage:
            parent = lineage[parent]
            depth[child] += 1
    joint_idxs = sorted(joint_idxs, key=lambda x: depth.get(x[0].parent, 0))
    joint = [j for j, _ in joint_idxs]

    if joint:
        # pad per-joint angles to 3 dof; index num_joint_dof reads a zero
        takes = []
        for j, (beg, end) in joint_idxs:
            arr = list(range(beg, end))
            arr.extend([num_joint_dof] * (3 - len(arr)))
            takes.extend(arr)
        takes = torch.as_tensor(takes, dtype=torch.long, device=device)

        def to_3dof(a):
            # a zero in column num_joint_dof, also when `a` has no columns
            a = torch.cat([a, a.new_zeros((n, 1))], dim=-1)
            return a[:, takes].reshape(n, len(joint), 3)

        joint_angle3 = to_3dof(joint_angle)
        joint_velocity3 = to_3dof(joint_velocity)

        # per-joint local rotation and angular velocity
        local_rots, local_angs = [], []
        for k, j in enumerate(joint):
            rot_q = _f32(np_euler_to_quat(j.rotation), device)
            ref_q = _f32(np_euler_to_quat(j.reference_rotation), device)
            axes = maths.rotate(torch.eye(3, device=device), rot_q[None, :])
            # axes^T @ v, summed elementwise so that it stays in float32
            ang = torch.sum(axes[None] * joint_velocity3[:, k, :, None], dim=-2)
            rot = ref_q.expand(n, 4)
            for a in range(3):
                # intrinsic euler rotations: each axis is rotated by prior rots
                axis = maths.rotate(axes[a], rot)
                next_rot = maths.quat_rot_axis(axis, joint_angle3[:, k, a])
                rot = maths.quat_mul(next_rot, rot)
            local_rots.append(rot)
            local_angs.append(ang)

        # place children in depth order
        pos, rot, ang = qp.pos.clone(), qp.rot.clone(), qp.ang.clone()
        for k, j in enumerate(joint):
            body_p = body_index[j.parent]
            body_c = body_index[j.child]
            off_p = _f32(j.parent_offset, device)
            off_c = _f32(j.child_offset, device)
            local_rot = local_rots[k]
            world_rot = maths.quat_mul(rot[:, body_p], local_rot)
            local_pos = off_p - maths.rotate(off_c, local_rot)
            world_pos = pos[:, body_p] + maths.rotate(local_pos, rot[:, body_p])
            world_ang = maths.rotate(local_angs[k], rot[:, body_p])
            pos[:, body_c] = world_pos
            rot[:, body_c] = world_rot
            ang[:, body_c] = world_ang
        qp = qp.replace(pos=pos, rot=rot, ang=ang)

    # raise trees with no explicit default qp above the ground plane
    fixed = {j.child for j in joint}
    if default:
        fixed |= {dqp.name for dqp in default.qps}
    root_idx = {b.name: [i] for i, b in enumerate(config.bodies) if b.name not in fixed}
    for j in joint:
        parent = j.parent
        while parent in lineage:
            parent = lineage[parent]
        if parent in root_idx:
            root_idx[parent].append(body_index[j.child])

    pos = qp.pos.clone()
    for children in root_idx.values():
        zs = torch.stack(
            [_min_z(qp.pos[:, c], qp.rot[:, c], config.bodies[c]) for c in children], dim=-1
        )
        min_z = torch.min(zs, dim=-1).values
        for c in children:
            pos[:, c, 2] = pos[:, c, 2] - min_z
    return qp.replace(pos=pos)


def _min_z(pos: Tensor, rot: Tensor, body: cfg.Body) -> Tensor:
    """Lowest z over a body's colliders, (N,)."""
    device = pos.device
    result = torch.full(pos.shape[:-1], float("inf"), device=device)
    if not body.colliders:
        return torch.zeros_like(result)
    z_axis = _f32([0.0, 0.0, 1.0], device)
    for col in body.colliders:
        if col.sphere is not None:
            sphere_pos = maths.rotate(_f32(col.position, device), rot)
            z = pos[..., 2] + sphere_pos[..., 2] - col.sphere.radius
            result = torch.minimum(result, z)
        elif col.capsule is not None:
            crot = _f32(np_euler_to_quat(col.rotation), device)
            axis = maths.rotate(z_axis, crot)
            length = col.capsule.length / 2 - col.capsule.radius
            for end in (-1, 1):
                sphere_pos = _f32(col.position, device) + end * axis * length
                sphere_pos = maths.rotate(sphere_pos, rot)
                z = pos[..., 2] + sphere_pos[..., 2] - col.capsule.radius
                result = torch.minimum(result, z)
        elif col.box is not None:
            crot = _f32(np_euler_to_quat(col.rotation), device)
            corners = _f32(BOX_CORNERS, device) * _f32(col.box.halfsize, device)
            corners = maths.rotate(corners, crot[None, :]) + _f32(col.position, device)
            corners = maths.rotate(corners, rot[..., None, :]) + pos[..., None, :]
            result = torch.minimum(result, torch.min(corners[..., 2], dim=-1).values)
        else:
            result = torch.clamp(result, max=0.0)
    return result
