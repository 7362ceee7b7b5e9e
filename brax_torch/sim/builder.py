"""Compiles a scene `Config` into a dense `System`, batch-first.

Counterpart of `brax_tpu/sim/builder.py`.  The build math runs once in
float64 numpy and is cast to float32, then every table moves to `device` as a
tensor; index tables stay host numpy.  The port builds PBD dynamics, revolute
joints, spherical joints (a PBD scene whose joints mix dofs, or has a 2-dof
joint, is "sphericalized": each joint is padded to 3 dofs with (0, 0)
limits), legacy-spring dynamics (its joints with stiffness > 0 grouped by
dof, unpadded), torque and angle actuators, thruster and twister forces (their
action columns follow the actuators'), one-way capsule-plane and box-plane
contacts and capsule-capsule contacts, one-way (body b frozen) or two-way.
Any other feature raises NotImplementedError naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from brax_torch.sim import actuators as actuators_mod
from brax_torch.sim import colliders as colliders_mod
from brax_torch.sim import config as cfg
from brax_torch.sim import geometry
from brax_torch.sim import joints as joints_mod
from brax_torch.sim.integrator import Integrator
from brax_torch.sim.system import System


# legacy-spring joint groups by dof, and each kind's default spring damping
# coefficient (spring_damping = coeff * sqrt(stiffness) where a joint sets none)
SPRING_KINDS = {1: "spring_revolute", 2: "spring_universal", 3: "spring_spherical"}
SPRING_DAMPING_COEFF = {1: 0.5, 2: 2.0, 3: 2.0}


def _not_ported(feature: str):
    return NotImplementedError(
        f"{feature} is not ported yet (see ROADMAP.md, queue B item 1)"
    )


# ---------------------------------------------------------------------------
# numpy euler/rotation helpers (build-time, float64)
# ---------------------------------------------------------------------------


def np_euler_to_quat(v) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    c1, c2, c3 = np.cos(v * np.pi / 360)
    s1, s2, s3 = np.sin(v * np.pi / 360)
    return np.array([
        c1 * c2 * c3 - s1 * s2 * s3,
        s1 * c2 * c3 + c1 * s2 * s3,
        c1 * s2 * c3 - s1 * c2 * s3,
        c1 * c2 * s3 + s1 * s2 * c3,
    ])


def np_rotate(vec, quat) -> np.ndarray:
    vec = np.asarray(vec, dtype=np.float64)
    s, u = quat[0], quat[1:]
    r = 2 * (np.dot(u, vec) * u) + (s * s - np.dot(u, u)) * vec
    return r + 2 * s * np.cross(u, vec)


def _np_rotate_rows(mat, quat) -> np.ndarray:
    return np.stack([np_rotate(row, quat) for row in np.asarray(mat, dtype=np.float64)])


@dataclasses.dataclass
class BuildArtifacts:
    config: cfg.Config  # validated
    body_index: Dict[str, int]
    joint_order: List[str]  # joint names in group-application order
    action_size: int


def build(config: cfg.Config, device="cuda") -> Tuple[System, BuildArtifacts]:
    config = cfg.validate(config)
    if config.collider_cutoff:
        raise _not_ported("collider_cutoff (nearest-pair culling)")

    def f32(x) -> torch.Tensor:
        a = np.asarray(np.asarray(x, dtype=np.float64), dtype=np.float32)
        return torch.as_tensor(a, device=device)

    nb = len(config.bodies)
    body_index = {b.name: i for i, b in enumerate(config.bodies)}
    mass = np.array([b.mass for b in config.bodies], dtype=np.float64)
    inv_inertia = 1.0 / np.array([b.inertia for b in config.bodies], dtype=np.float64)
    active = np.array([0.0 if b.frozen.all else 1.0 for b in config.bodies])

    # counted before sphericalization pads the joints
    num_joint_dof = sum(len(j.angle_limits) for j in config.joints)
    joint_groups, joint_order, group_of_joint, index_in_group = _build_joints(
        config, body_index, mass, inv_inertia, f32
    )
    actuator_groups = _build_actuators(
        config, joint_groups, group_of_joint, index_in_group, f32
    )
    force_groups = _build_forces(config, body_index, mass, f32)
    contact_groups, num_contacts = _build_contact_groups(
        config, body_index, mass, inv_inertia, f32
    )

    pos_mask = 1.0 - np.array([b.frozen.position for b in config.bodies])
    rot_mask = 1.0 - np.array([b.frozen.rotation for b in config.bodies])
    quat_mask = 1.0 - np.array([[0.0] + list(b.frozen.rotation) for b in config.bodies])
    integrator = Integrator(
        pos_mask=f32(pos_mask),
        rot_mask=f32(rot_mask),
        quat_mask=f32(quat_mask),
        dt=float(config.dt) / int(config.substeps),
        gravity=f32(config.gravity),
        velocity_damping=float(config.velocity_damping),
        angular_damping=float(config.angular_damping),
    )

    h = config.dt / config.substeps
    solver = colliders_mod.SolverParams(
        baumgarte_erp=float(config.baumgarte_erp * config.substeps / config.dt),
        h=float(h),
        collide_scale=float(config.solver_scale_collide),
        velocity_threshold=float(np.linalg.norm(np.array(config.gravity)) * h * 4.0),
    )

    sys = System(
        num_bodies=nb,
        num_joints=len(config.joints),
        num_joint_dof=num_joint_dof,
        num_actuators=len(config.actuators),
        num_forces_dof=3 * len(config.forces),
        substeps=int(config.substeps),
        dynamics_mode=config.dynamics_mode,
        num_contacts=num_contacts,
        collider_cutoff=int(config.collider_cutoff),
        mass=f32(mass),
        inv_inertia=f32(inv_inertia),
        active=f32(active),
        integrator=integrator,
        solver=solver,
        joint_groups=tuple(joint_groups),
        actuator_groups=tuple(actuator_groups),
        force_groups=tuple(force_groups),
        contact_groups=tuple(contact_groups),
    )
    art = BuildArtifacts(
        config=config,
        body_index=body_index,
        joint_order=joint_order,
        action_size=num_joint_dof + 3 * len(config.forces),
    )
    return sys, art


# ---------------------------------------------------------------------------
# joints
# ---------------------------------------------------------------------------


def _joint_frames(j: cfg.Joint):
    """axis_c / axis_p construction."""
    rot_q = np_euler_to_quat(j.rotation)
    ref_q = np_euler_to_quat(j.reference_rotation)
    axis_c = _np_rotate_rows(np.eye(3), rot_q)
    axis_p = _np_rotate_rows(axis_c, ref_q)
    return axis_c, axis_p


def _build_joints(config, body_index, mass, inv_inertia, f32):
    """Groups the joints by dof, as `brax_tpu/sim/builder.py` does.

    PBD: one revolute group of 1-dof joints, or, when the dofs are mixed or
    a joint has 2, one spherical group of every joint padded to 3 dofs with
    (0, 0) limits (the padding is written into `config`, the validated copy,
    as `brax_tpu/sim/builder.py` writes it into its own).  Legacy spring:
    the joints with stiffness > 0, one group per dof (spring_revolute,
    spring_universal, spring_spherical), unpadded, each with its own
    default spring damping coefficient."""
    if config.dynamics_mode == "legacy_spring":
        by_dof: Dict[int, list] = {}
        for joint in config.joints:
            if joint.stiffness > 0:
                by_dof.setdefault(len(joint.angle_limits), []).append(joint)
        spec = [(dof, SPRING_KINDS[dof], joints, None, SPRING_DAMPING_COEFF[dof])
                for dof, joints in sorted(by_dof.items())]
    else:
        dofs = {len(j.angle_limits) for j in config.joints}
        sphericalize = len(dofs) > 1 or 2 in dofs
        by_dof: Dict[int, Tuple[list, list]] = {}
        for joint in config.joints:
            free = len(joint.angle_limits)
            if sphericalize:
                joint.angle_limits = list(joint.angle_limits) + [(0.0, 0.0)] * (3 - free)
            joints, free_dofs = by_dof.setdefault(len(joint.angle_limits), ([], []))
            joints.append(joint)
            free_dofs.append(free)
        spec = []
        for dof, (joints, free_dofs) in sorted(by_dof.items()):
            if dof == 1:
                spec.append((dof, "revolute", joints, None, 2.0))
            elif dof == 3:
                spec.append((dof, "spherical", joints, tuple(free_dofs), 2.0))
            else:
                raise RuntimeError(f"invalid number of joint limits: {dof}")

    groups, joint_order, group_of_joint, index_in_group = [], [], {}, {}
    for dof, kind, joints, free, coeff in spec:
        gi = len(groups)
        groups.append(_joint_group(kind, dof, joints, free, config, body_index, mass,
                                   inv_inertia, f32, coeff))
        for k, j in enumerate(joints):
            joint_order.append(j.name)
            group_of_joint[j.name] = gi
            index_in_group[j.name] = k
    return groups, joint_order, group_of_joint, index_in_group


def _joint_group(kind, dof, joints, free_dofs, config, body_index, mass, inv_inertia, f32,
                 spring_damping_coeff):
    parent = np.array([body_index[j.parent] for j in joints], dtype=np.int32)
    child = np.array([body_index[j.child] for j in joints], dtype=np.int32)
    axis_cp = [_joint_frames(j) for j in joints]
    limit = np.array(
        [[[lo, hi] for (lo, hi) in j.angle_limits] for j in joints], dtype=np.float64
    ) / 180.0 * np.pi
    # a joint's own spring damping, else coeff * sqrt(stiffness) (zero for a
    # PBD joint, whose stiffness is zero)
    spring_damping = np.array(
        [j.spring_damping if j.spring_damping is not None
         else spring_damping_coeff * np.sqrt(j.stiffness) for j in joints]
    )
    limit_strength = np.array(
        [j.limit_strength if j.limit_strength is not None else j.stiffness for j in joints]
    )
    if kind in SPRING_KINDS.values():
        scale_pos, scale_ang = 0.6, 0.2
    else:
        scale_pos = config.solver_scale_pos or 0.6
        scale_ang = config.solver_scale_ang or 0.2
    return joints_mod.JointGroup(
        kind=kind,
        dof=dof,
        parent=parent,
        child=child,
        free_dofs=free_dofs,
        off_p=f32([j.parent_offset for j in joints]),
        off_c=f32([j.child_offset for j in joints]),
        limit=f32(limit),
        axis_c=f32([ac for ac, _ in axis_cp]),
        axis_p=f32([ap for _, ap in axis_cp]),
        angular_damping=f32([j.angular_damping for j in joints]),
        scale_pos=f32([scale_pos] * len(joints)),
        scale_ang=f32([scale_ang] * len(joints)),
        mass_p=f32(mass[parent]),
        mass_c=f32(mass[child]),
        inertia_p=f32(inv_inertia[parent]),
        inertia_c=f32(inv_inertia[child]),
        stiffness=f32([j.stiffness for j in joints]),
        spring_damping=f32(spring_damping),
        limit_strength=f32(limit_strength),
    )


# ---------------------------------------------------------------------------
# actuators
# ---------------------------------------------------------------------------


def _build_actuators(config, joint_groups, group_of_joint, index_in_group, f32):
    """Act-index packing: each actuator takes its joint's free dofs in order,
    with -1 in a sphericalized joint's padded dofs."""
    actuators: Dict[tuple, list] = {}
    current_index = 0
    for actuator in config.actuators:
        if actuator.kind not in ("torque", "angle"):
            raise ValueError(f"unknown actuator kind: {actuator.kind}")
        if actuator.joint not in group_of_joint:
            raise RuntimeError(f"joint not found: {actuator.joint}")
        gi = group_of_joint[actuator.joint]
        g = joint_groups[gi]
        ji = index_in_group[actuator.joint]
        free = g.dof if g.free_dofs is None else g.free_dofs[ji]
        act_index = tuple(i if i - current_index < free else -1
                          for i in range(current_index, current_index + g.dof))
        current_index += free
        key = (actuator.kind, g.dof, gi)
        actuators.setdefault(key, []).append((actuator, ji, act_index))

    groups = []
    for (kind, dof, gi), items in sorted(actuators.items()):
        groups.append(
            actuators_mod.ActuatorGroup(
                kind=kind,
                group_index=gi,
                joint_sel=np.array([ji for _, ji, _ in items], dtype=np.int32),
                act_index=np.array([ai for _, _, ai in items], dtype=np.int32),
                strength=f32([a.strength for a, _, _ in items]),
            )
        )
    return groups


def _build_forces(config, body_index, mass, f32):
    """A thruster group and a twister group, in config order within each;
    a force's three action columns follow the actuators' dofs and the
    forces before it."""
    dofs = {j.name: len(j.angle_limits) for j in config.joints}
    current_index = sum(dofs[a.joint] for a in config.actuators)
    by_kind: Dict[str, list] = {"thruster": [], "twister": []}
    for f in config.forces:
        if f.kind not in by_kind:
            raise ValueError(f"unknown force kind: {f.kind}")
        by_kind[f.kind].append((f, tuple(range(current_index, current_index + 3))))
        current_index += 3

    groups = []
    for kind, items in by_kind.items():
        if not items:
            continue
        body = np.array([body_index[f.body] for f, _ in items], dtype=np.int32)
        groups.append(
            actuators_mod.ForceGroup(
                kind=kind,
                body=body,
                act_index=np.array([idx for _, idx in items], dtype=np.int32),
                strength=f32([f.strength for f, _ in items]),
                mass=f32(mass[body]),
            )
        )
    return groups


# ---------------------------------------------------------------------------
# contact pair tables
# ---------------------------------------------------------------------------


def _capsule_axis_seg(col: cfg.Collider):
    """A capsule's axis and half the length of its segment."""
    axis = np_rotate(np.array([0.0, 0.0, 1.0]), np_euler_to_quat(col.rotation))
    return axis, col.capsule.length * 0.5 - col.capsule.radius


def _capsule_ends(col: cfg.Collider) -> List[np.ndarray]:
    """Cap sphere centers, collider offset included."""
    axis, seg = _capsule_axis_seg(col)
    pos = np.asarray(col.position, dtype=np.float64)
    ends = [col.capsule.end] if col.capsule.end else [-1, 1]
    return [pos + e * axis * seg for e in ends]


def _box_corners(col: cfg.Collider) -> np.ndarray:
    """A box collider's eight corners, collider rotation and offset included."""
    rot = np_euler_to_quat(col.rotation)
    corners = geometry.BOX_CORNERS * np.asarray(col.box.halfsize, dtype=np.float64)
    corners = np.stack([np_rotate(c, rot) for c in corners])
    return corners + np.asarray(col.position, dtype=np.float64)


# (type_a, type_b) in the order the JAX builder applies contact groups
_PAIR_TYPES = [
    ("box", "plane"),
    ("box", "heightmap"),
    ("capsule", "box"),
    ("capsule", "plane"),
    ("capsule", "capsule"),
    ("capsule", "mesh"),
    ("capsule", "clipped_plane"),
    ("mesh", "plane"),
    ("box", "box"),
]


def _build_contact_groups(config: cfg.Config, body_index, mass, inv_inertia, f32):
    """Static typed contact pair tables, with the JAX builder's pair rules:
    collide_include allowlist, dedup, no self-collision, no frozen-frozen,
    joint parent/child exclusion, one-way split on a frozen second body."""
    if config.mesh_geometries:
        raise _not_ported("mesh colliders")
    cols = []
    for b in config.bodies:
        for c_idx, c in enumerate(b.colliders):
            if c.no_contact:
                continue
            if c.sphere is not None:
                c = dataclasses.replace(
                    c, capsule=cfg.Capsule(radius=c.sphere.radius,
                                           length=2 * c.sphere.radius, end=1),
                    sphere=None,
                )
            cols.append((c, b, c_idx))

    include = {(a, b) for a, b in config.collide_include}
    parents = {(j.parent, j.child) for j in config.joints}

    groups = []
    num_contacts = 0
    for type_a, type_b in _PAIR_TYPES:
        cols_a = [(c, b, ci) for c, b, ci in cols if c.kind() == type_a and not b.frozen.all]
        cols_b = [(c, b, ci) for c, b, ci in cols if c.kind() == type_b]
        cols_ab = []
        seen = set()
        for ca, ba, ca_idx in cols_a:
            for cb, bb, cb_idx in cols_b:
                included = (ba.name, bb.name) in include or (bb.name, ba.name) in include
                if (ba.name, ca_idx, bb.name, cb_idx) in seen:
                    continue
                if ba.name == bb.name:
                    continue
                if ba.frozen.all and bb.frozen.all:
                    continue
                # a (parent, child) ordered pair is always skipped; a
                # (child, parent) one only when not included
                if (ba.name, bb.name) in parents or (
                    (bb.name, ba.name) in parents and not included
                ):
                    continue
                if ca.no_contact or cb.no_contact:
                    continue
                if not include or included:
                    cols_ab.append((ca, ba, cb, bb))
                    seen.add((ba.name, ca_idx, bb.name, cb_idx))
                    seen.add((bb.name, cb_idx, ba.name, ca_idx))

        # a pair whose second body is frozen is one-way, as the JAX builder splits them
        for b_is_frozen in (True, False):
            sel = [x for x in cols_ab if x[3].frozen.all == b_is_frozen]
            if not sel:
                continue
            way = "one-way" if b_is_frozen else "two-way"
            com = _common(sel, b_is_frozen, body_index, mass, inv_inertia, f32)
            if (type_a, type_b, b_is_frozen) == ("capsule", "plane", True):
                g = _capsule_plane(sel, com, f32)
                num_contacts += g.end.shape[0] * g.end.shape[1]
            elif (type_a, type_b, b_is_frozen) == ("box", "plane", True):
                g = colliders_mod.BoxPlane(
                    com=com, corner=f32(np.stack([_box_corners(ca) for ca, _, _, _ in sel])))
                num_contacts += g.corner.shape[0] * g.corner.shape[1]
            elif (type_a, type_b) == ("capsule", "capsule"):
                g = _capsule_capsule(sel, com, f32)
                num_contacts += g.end_a.shape[0]
            else:
                raise _not_ported(f"{way} {type_a}-{type_b} contacts")
            groups.append(g)
    return groups, num_contacts


def _common(sel, b_is_frozen, body_index, mass, inv_inertia, f32):
    body_a = np.array([body_index[ba.name] for _, ba, _, _ in sel], dtype=np.int32)
    body_b = np.array([body_index[bb.name] for _, _, _, bb in sel], dtype=np.int32)
    fr = np.array([ca.material.friction * cb.material.friction for ca, _, cb, _ in sel])
    el = np.array([ca.material.elasticity * cb.material.elasticity for ca, _, cb, _ in sel])
    return colliders_mod.GroupCommon(
        body_a=body_a,
        body_b=body_b,
        one_way=bool(b_is_frozen),
        friction=f32(fr),
        elasticity=f32(el),
        mass_a=f32(mass[body_a]),
        inertia_a=f32(inv_inertia[body_a]),
        mass_b=f32(mass[body_b]),
        inertia_b=f32(inv_inertia[body_b]),
    )


def _capsule_capsule(sel, com, f32):
    def parts(cols):
        axis_seg = [_capsule_axis_seg(c) for c in cols]
        end = np.stack([a * s for a, s in axis_seg])
        off = np.stack([np.asarray(c.position, dtype=np.float64) for c in cols])
        return f32(end), f32(off), f32([c.capsule.radius for c in cols])

    end_a, off_a, radius_a = parts([ca for ca, _, _, _ in sel])
    end_b, off_b, radius_b = parts([cb for _, _, cb, _ in sel])
    return colliders_mod.CapsuleCapsule(com=com, end_a=end_a, off_a=off_a, radius_a=radius_a,
                                        end_b=end_b, off_b=off_b, radius_b=radius_b)


def _capsule_plane(sel, com, f32):
    ends = [_capsule_ends(ca) for ca, _, _, _ in sel]
    if len({len(e) for e in ends}) != 1:
        # pad 1-end capsules with a duplicate cap
        for e in ends:
            if len(e) == 1:
                e.append(e[0])
    return colliders_mod.CapsulePlane(
        com=com,
        end=f32(np.stack([np.stack(e) for e in ends])),
        radius=f32([ca.capsule.radius for ca, _, _, _ in sel]),
    )
