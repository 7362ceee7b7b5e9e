"""Compiles a scene `Config` into a dense `System`, batch-first.

Counterpart of `brax_tpu/sim/builder.py`.  The build math runs once in
float64 numpy and is cast to float32, then every table moves to `device` as a
tensor; index tables stay host numpy.  This slice builds what ant uses: PBD
dynamics, revolute joints, torque actuators and one-way capsule-plane
contacts.  Any other feature raises NotImplementedError naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from brax_torch.sim import actuators as actuators_mod
from brax_torch.sim import colliders as colliders_mod
from brax_torch.sim import config as cfg
from brax_torch.sim import joints as joints_mod
from brax_torch.sim.integrator import Integrator
from brax_torch.sim.system import System


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
    if config.dynamics_mode != "pbd":
        raise _not_ported(f"dynamics_mode={config.dynamics_mode!r}")
    if config.collider_cutoff:
        raise _not_ported("collider_cutoff (nearest-pair culling)")
    if config.forces:
        raise _not_ported("thruster/twister forces")

    def f32(x) -> torch.Tensor:
        a = np.asarray(np.asarray(x, dtype=np.float64), dtype=np.float32)
        return torch.as_tensor(a, device=device)

    nb = len(config.bodies)
    body_index = {b.name: i for i, b in enumerate(config.bodies)}
    mass = np.array([b.mass for b in config.bodies], dtype=np.float64)
    inv_inertia = 1.0 / np.array([b.inertia for b in config.bodies], dtype=np.float64)
    active = np.array([0.0 if b.frozen.all else 1.0 for b in config.bodies])

    num_joint_dof = sum(len(j.angle_limits) for j in config.joints)
    joint_groups, joint_order, group_of_joint, index_in_group = _build_joints(
        config, body_index, mass, inv_inertia, f32
    )
    actuator_groups = _build_actuators(
        config, joint_groups, group_of_joint, index_in_group, f32
    )
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
        num_forces_dof=0,
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
        force_groups=(),
        contact_groups=tuple(contact_groups),
    )
    art = BuildArtifacts(
        config=config,
        body_index=body_index,
        joint_order=joint_order,
        action_size=num_joint_dof,
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
    """One revolute group of every joint (all PBD joints must have 1 dof)."""
    dofs = {len(j.angle_limits) for j in config.joints}
    if dofs - {1}:
        raise _not_ported("joints with 2 or 3 dof (spherical)")
    joints = list(config.joints)
    if not joints:
        return [], [], {}, {}

    parent = np.array([body_index[j.parent] for j in joints], dtype=np.int32)
    child = np.array([body_index[j.child] for j in joints], dtype=np.int32)
    axis_cp = [_joint_frames(j) for j in joints]
    limit = np.array(
        [[[lo, hi] for (lo, hi) in j.angle_limits] for j in joints], dtype=np.float64
    ) / 180.0 * np.pi
    # PBD joints have zero stiffness, so the spring-mode tables are zero too
    spring_damping = np.array(
        [j.spring_damping if j.spring_damping is not None else 2.0 * np.sqrt(j.stiffness)
         for j in joints]
    )
    limit_strength = np.array(
        [j.limit_strength if j.limit_strength is not None else j.stiffness for j in joints]
    )
    scale_pos = config.solver_scale_pos or 0.6
    scale_ang = config.solver_scale_ang or 0.2
    group = joints_mod.JointGroup(
        kind="revolute",
        dof=1,
        parent=parent,
        child=child,
        free_dofs=None,
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
    joint_order = [j.name for j in joints]
    group_of_joint = {j.name: 0 for j in joints}
    index_in_group = {j.name: k for k, j in enumerate(joints)}
    return [group], joint_order, group_of_joint, index_in_group


# ---------------------------------------------------------------------------
# actuators
# ---------------------------------------------------------------------------


def _build_actuators(config, joint_groups, group_of_joint, index_in_group, f32):
    """Act-index packing: each actuator takes its joint's dofs in order."""
    actuators: Dict[tuple, list] = {}
    current_index = 0
    for actuator in config.actuators:
        if actuator.kind != "torque":
            raise _not_ported(f"{actuator.kind} actuators")
        if actuator.joint not in group_of_joint:
            raise RuntimeError(f"joint not found: {actuator.joint}")
        gi = group_of_joint[actuator.joint]
        g = joint_groups[gi]
        ji = index_in_group[actuator.joint]
        act_index = tuple(range(current_index, current_index + g.dof))
        current_index += g.dof
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


# ---------------------------------------------------------------------------
# contact pair tables
# ---------------------------------------------------------------------------


def _capsule_ends(col: cfg.Collider) -> List[np.ndarray]:
    """Cap sphere centers, collider offset included."""
    axis = np_rotate(np.array([0.0, 0.0, 1.0]), np_euler_to_quat(col.rotation))
    seg = col.capsule.length * 0.5 - col.capsule.radius
    pos = np.asarray(col.position, dtype=np.float64)
    ends = [col.capsule.end] if col.capsule.end else [-1, 1]
    return [pos + e * axis * seg for e in ends]


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

        for b_is_frozen in (True, False):
            sel = [x for x in cols_ab if x[3].frozen.all == b_is_frozen]
            if not sel:
                continue
            if (type_a, type_b) != ("capsule", "plane"):
                raise _not_ported(f"{type_a}-{type_b} contacts")
            if not b_is_frozen:
                raise _not_ported("two-way capsule-plane contacts")
            g = _capsule_plane(sel, body_index, mass, inv_inertia, f32)
            groups.append(g)
            num_contacts += g.end.shape[0] * g.end.shape[1]
    return groups, num_contacts


def _capsule_plane(sel, body_index, mass, inv_inertia, f32):
    body_a = np.array([body_index[ba.name] for _, ba, _, _ in sel], dtype=np.int32)
    body_b = np.array([body_index[bb.name] for _, _, _, bb in sel], dtype=np.int32)
    fr = np.array([ca.material.friction * cb.material.friction for ca, _, cb, _ in sel])
    el = np.array([ca.material.elasticity * cb.material.elasticity for ca, _, cb, _ in sel])
    com = colliders_mod.GroupCommon(
        body_a=body_a,
        body_b=body_b,
        one_way=True,
        friction=f32(fr),
        elasticity=f32(el),
        mass_a=f32(mass[body_a]),
        inertia_a=f32(inv_inertia[body_a]),
        mass_b=f32(mass[body_b]),
        inertia_b=f32(inv_inertia[body_b]),
    )
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
