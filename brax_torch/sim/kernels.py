"""The fused PBD step: a hand-written CUDA kernel and its plain-torch twin.

Counterpart of `brax_tpu/sim/kernels.py`.  `pbd_step(sys, qp, act)` steps a
whole env batch with one launch of `brax_torch/csrc/pbd_step.cu`, which
replaces the Pallas kernel `_build_tile_step`.  On CPU tensors it runs
`pbd_step_plain`, the same step written with the sim modules' torch
functions (the counterpart of the JAX package's jnp `_pbd_step`, and of
`_spring_step` for a legacy-spring System); on CUDA tensors it launches
the kernel or raises, and never falls back to the twin.

As the Pallas kernel bakes each System's constants in, the CUDA source is
compiled once per System: `scene_header` writes the scene (counts,
topology, the per-body lists the kernel gathers and the constants that
`pack_tables` packs, as float literals) in front of `pbd_step.cu`, into
`build/brax_torch/pbd_step_<hash>.cu`, which nvcc builds at first use
(`brax_torch/cuda_build.py`, keyed by the text's hash) and ctypes loads.
`plan(sys)` spreads an env over `lanes` lanes of a warp (a lane per body,
joint, actuator and contact) and puts `envs_per_block` envs, one warp, in a
block; the source holds the header to it with static_asserts.  A System's
joints are all revolute or all spherical (`builder.build` pads a PBD scene
with mixed dofs to 3); a spherical scene's header defines PBD_SPHERICAL,
which compiles the source's spherical joint rows and 3-dof actuators in
place of the revolute ones.  A scene with two-way capsule-capsule contacts
(halfcheetah, pusher) defines PBD_CAPCAP, which compiles the capsule-capsule
narrowphase and the two-way contact passes beside the one-way capsule-plane
ones.  A scene with thrusters or twisters (inverted_pendulum,
inverted_double_pendulum, swimmer) defines PBD_FORCES, which compiles the
forces' velocity changes, and one with angle actuators (reacherangle,
grasp) PBD_ANGLE, which compiles their PD torque, on revolute joints or,
beside PBD_SPHERICAL, per dof of a spherical joint.  A scene with one-way
capsule-capsule contacts (grasp's ball against its frozen palm) defines
PBD_CAPCAP_ONEWAY beside PBD_CAPCAP: such a lane takes the capsule-capsule
contact point and the one-way update of body a alone.  A one-way box-plane
group (fetch's lower legs on the ground) needs no section of its own:
`pack_tables` writes each box corner as a capsule-plane record of radius 0,
as the Pallas body packs it, so a box's eight corners run on eight
capsule-plane lanes.  A legacy-spring System (the eight envs made with
legacy_spring=True) defines PBD_SPRING: the step loops over its substeps,
each a joint lane's spring (revolute, universal or spherical, mixed in one
System; PBD_SPRING_EULER compiles the universal and spherical code where
such a joint is) and the actuator on its joint, then the contact lanes'
velocity-level impulses; its header has PBD_SUBSTEPS where a PBD scene's
has PBD_PASSES, and the spring tables `pack_tables` appends.  A scene
without a group compiles none of its code.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
from typing import TYPE_CHECKING, Dict, List, Tuple

import numpy as np
import torch

from brax_torch import cuda_build
from brax_torch.sim import actuators as actuators_mod
from brax_torch.sim import colliders as colliders_mod
from brax_torch.sim import joints as joints_mod
from brax_torch.sim.types import DP, DQ, QP, Info, Tensor

if TYPE_CHECKING:
    from brax_torch.sim.system import System

SOURCE = cuda_build.CSRC / "pbd_step.cu"
BUILD_DIR = cuda_build.BUILD_DIR
# guards on the generated size: the scenes the kernel is built and tested for
# (a contact needs a lane of its env's 32 at most)
MAX_BODIES, MAX_CONTACTS, MAX_ACT = 16, 32, 64
WARP = 32
# pack_tables' record sizes, in floats: globals, body, joint, actuator, a
# capsule-plane contact, a capsule-capsule contact and a force
G_SIZE, B_SIZE, J_SIZE, A_SIZE, C_SIZE, CC_SIZE, F_SIZE = 9, 14, 33, 1, 6, 16, 2
# a force's int record: body, kind (FORCE_KINDS' index), an action column per axis
F_INT = 5
FORCE_KINDS = ("thruster", "twister")
# the capsule-capsule record's fields (pbd_step.cu's CC_* offsets)
CC_END_A, CC_OFF_A, CC_RADIUS_A, CC_END_B, CC_OFF_B, CC_RADIUS_B = 0, 3, 6, 7, 10, 13
CC_FRICTION, CC_ELASTICITY = 14, 15
# the most dofs of a joint, and so action columns of an actuator
MAX_DOF = 3
# legacy spring's records, appended to pack_tables' float table after the
# forces: a joint's (stiffness, spring_damping, limit_strength), a body's
# 1 / mass, a contact's (1 / mass_a, 1 / mass_b, the inverse masses its
# impulse divides by: 1 / mass_a one-way, 1 / mass_a + 1 / mass_b two-way),
# then the globals (baumgarte_erp); and to the int table: a joint's (dof,
# the actuator on it or -1)
SJ_SIZE, SB_SIZE, SC_SIZE, SG_SIZE, SJ_INT = 3, 1, 3, 1, 2
SPRING_KINDS = {"spring_revolute": 1, "spring_universal": 2, "spring_spherical": 3}


# ---------------------------------------------------------------------------
# coverage
# ---------------------------------------------------------------------------


def unsupported_features(sys: System, n_act: int = 0) -> List[str]:
    """Features of `sys` (and of an action width) that the kernel lacks."""
    missing = []
    spring = sys.dynamics_mode == "legacy_spring"
    if sys.dynamics_mode not in ("pbd", "legacy_spring"):
        missing.append(f"dynamics_mode={sys.dynamics_mode!r}")
    if sys.collider_cutoff:
        missing.append("collider_cutoff")
    kinds = SPRING_KINDS if spring else ("revolute", "spherical")
    for g in sys.joint_groups:
        if g.kind not in kinds:
            missing.append(f"{g.kind} joints" + (" in legacy spring" if spring else ""))
        elif g.kind == "spherical" and g.dof != MAX_DOF:
            missing.append(f"{g.dof}-dof spherical joints")
    # a legacy-spring System mixes its joint kinds; a PBD one does not yet
    if not spring and len({g.kind for g in sys.joint_groups}) > 1:
        missing.append("revolute and spherical joints in one System")
    if spring:
        driven = [(a.group_index, int(j)) for a in sys.actuator_groups for j in a.joint_sel]
        if len(set(driven)) < len(driven):
            missing.append("two actuators on one spring joint")
    for a in sys.actuator_groups:
        if a.kind not in ("torque", "angle"):
            missing.append(f"{a.kind} actuators")
    for f in sys.force_groups:
        if f.kind not in FORCE_KINDS:
            missing.append(f"{f.kind} forces")
    for c in sys.contact_groups:
        if isinstance(c, (colliders_mod.CapsulePlane, colliders_mod.BoxPlane)):
            if not c.com.one_way:
                missing.append(f"two-way {type(c).__name__} contacts")
        elif not isinstance(c, colliders_mod.CapsuleCapsule):
            missing.append(f"{type(c).__name__} contacts")
    if sys.num_bodies > MAX_BODIES:
        missing.append(f"{sys.num_bodies} bodies (the kernel holds {MAX_BODIES})")
    ported = (colliders_mod.CapsulePlane, colliders_mod.BoxPlane, colliders_mod.CapsuleCapsule)
    if sum(_n_contacts(c) for c in sys.contact_groups if isinstance(c, ported)) > MAX_CONTACTS:
        missing.append(f"more than {MAX_CONTACTS} contact points")
    if n_act > MAX_ACT:
        missing.append(f"{n_act} action columns (the kernel holds {MAX_ACT})")
    return missing


def supported(sys: System) -> bool:
    """True if the kernel covers this system's features."""
    return not unsupported_features(sys)


def _n_contacts(c) -> int:
    """Contact points of a group: a capsule-plane group's cap ends per pair,
    a box-plane group's eight corners per pair, one per capsule-capsule
    pair."""
    if isinstance(c, colliders_mod.CapsuleCapsule):
        return c.end_a.shape[0]
    if isinstance(c, colliders_mod.CapsulePlane):
        return c.end.shape[0] * c.end.shape[1]
    if isinstance(c, colliders_mod.BoxPlane):
        return c.corner.shape[0] * c.corner.shape[1]
    raise NotImplementedError(f"{type(c).__name__} contacts are not ported yet (see ROADMAP.md, "
                              "queue B item 1)")


def _is_capcap(c) -> bool:
    return isinstance(c, colliders_mod.CapsuleCapsule)


# ---------------------------------------------------------------------------
# scene tables
# ---------------------------------------------------------------------------


def pack_tables(sys: System) -> Tuple[np.ndarray, np.ndarray]:
    """The scene as flat float32 and int32 tables: what `scene_header`
    writes into the generated source.

    Layouts: globals (dt, gravity[3], exp(velocity_damping dt),
    exp(angular_damping dt), collide_scale, h, velocity_threshold), then per
    body (mass, inv_inertia[3], pos_mask[3], rot_mask[3], quat_mask[4]),
    joint (off_p[3], off_c[3], axis_p[9], axis_c[9], (lo, hi) per dof, padded
    with zeros to MAX_DOF, damping, scale_pos, scale_ang), actuator (strength)
    and contact records in the float table: a capsule-plane contact's is
    C_SIZE floats (end[3], radius, friction, elasticity), a capsule-capsule
    one's CC_SIZE (end_a[3], off_a[3], radius_a, end_b[3], off_b[3],
    radius_b, friction, elasticity: the CC_* offsets; a box corner's is a
    capsule-plane record with the corner as its end and radius 0, as the
    Pallas body packs it) and force records
    (strength, mass) in the float table; joint (parent, child), actuator
    (joint, an action column per dof, -1 for a padded dof and past the
    joint's dofs), contact (group, body a, body b) and force (body, kind:
    0 thruster, 1 twister, three action columns, unclipped: the kernel
    clips them to the action's width) records in the int table.  Contacts
    are listed group by group, forces group by group after them.  A
    legacy-spring System appends its spring records (see SJ_SIZE).
    """
    f64 = lambda x: np.asarray(x.detach().cpu().numpy() if isinstance(x, Tensor) else x,
                               dtype=np.float64)
    integ = sys.integrator
    dt = float(integ.dt)
    fl = [dt, *f64(integ.gravity).tolist(),
          np.exp(float(integ.velocity_damping) * dt),
          np.exp(float(integ.angular_damping) * dt),
          sys.solver.collide_scale, sys.solver.h, sys.solver.velocity_threshold]
    mass, inv_i = f64(sys.mass), f64(sys.inv_inertia)
    pm, rm, qm = f64(integ.pos_mask), f64(integ.rot_mask), f64(integ.quat_mask)
    for b in range(sys.num_bodies):
        fl += [mass[b], *inv_i[b], *pm[b], *rm[b], *qm[b]]
    il = []
    joint_base, base = [], 0
    for g in sys.joint_groups:
        joint_base.append(base)
        base += g.n
        off_p, off_c = f64(g.off_p), f64(g.off_c)
        axis_p, axis_c, limit = f64(g.axis_p), f64(g.axis_c), f64(g.limit)
        damping, sp, sa = f64(g.angular_damping), f64(g.scale_pos), f64(g.scale_ang)
        limits = np.zeros((g.n, MAX_DOF, 2))
        limits[:, :g.dof] = limit
        for j in range(g.n):
            fl += [*off_p[j], *off_c[j], *axis_p[j].reshape(-1), *axis_c[j].reshape(-1),
                   *limits[j].reshape(-1), damping[j], sp[j], sa[j]]
            il += [int(g.parent[j]), int(g.child[j])]
    for a in sys.actuator_groups:
        strength = f64(a.strength)
        for k in range(a.n):
            fl.append(strength[k])
            cols = [int(c) for c in a.act_index[k]]
            il += [joint_base[a.group_index] + int(a.joint_sel[k])]
            il += cols + [-1] * (MAX_DOF - len(cols))
    for gi, c in enumerate(sys.contact_groups):
        friction, elasticity = f64(c.com.friction), f64(c.com.elasticity)
        if _is_capcap(c):
            end_a, off_a, radius_a = f64(c.end_a), f64(c.off_a), f64(c.radius_a)
            end_b, off_b, radius_b = f64(c.end_b), f64(c.off_b), f64(c.radius_b)
            for p in range(end_a.shape[0]):
                fl += [*end_a[p], *off_a[p], radius_a[p], *end_b[p], *off_b[p], radius_b[p],
                       friction[p], elasticity[p]]
                il += [gi, int(c.com.body_a[p]), int(c.com.body_b[p])]
            continue
        if isinstance(c, colliders_mod.BoxPlane):
            end, radius = f64(c.corner), np.zeros(c.corner.shape[0])
        else:
            end, radius = f64(c.end), f64(c.radius)
        for p in range(end.shape[0]):
            for e in range(end.shape[1]):
                fl += [*end[p, e], radius[p], friction[p], elasticity[p]]
                il += [gi, int(c.com.body_a[p]), int(c.com.body_b[p])]
    for f in sys.force_groups:
        strength, mass = f64(f.strength), f64(f.mass)
        for k in range(f.n):
            fl += [strength[k], mass[k]]
            il += [int(f.body[k]), FORCE_KINDS.index(f.kind), *(int(c) for c in f.act_index[k])]
    if sys.dynamics_mode == "legacy_spring":
        _pack_spring(sys, fl, il, joint_base, f64)
    return np.asarray(fl, dtype=np.float32), np.asarray(il, dtype=np.int32)


def _pack_spring(sys: System, fl: list, il: list, joint_base: List[int], f64) -> None:
    """Appends a legacy-spring System's records (see SJ_SIZE) to the tables.
    The inverse masses are taken in float64 and rounded once, as the Pallas
    body's constants are; a massless body's (the frozen floor's) is 0."""
    inv = lambda m: 1.0 / m if m else 0.0
    act_of = {joint_base[a.group_index] + int(j): k
              for k, (a, j) in enumerate((a, j) for a in sys.actuator_groups for j in a.joint_sel)}
    for gi, g in enumerate(sys.joint_groups):
        stiffness, damping = f64(g.stiffness), f64(g.spring_damping)
        strength = f64(g.limit_strength)
        for j in range(g.n):
            fl += [stiffness[j], damping[j], strength[j]]
            il += [g.dof, act_of.get(joint_base[gi] + j, -1)]
    fl += [inv(m) for m in f64(sys.mass)]
    for c in sys.contact_groups:
        ma, mb = f64(c.com.mass_a), f64(c.com.mass_b)
        per_pair = _n_contacts(c) // ma.shape[0]
        for p in range(ma.shape[0]):
            both = inv(ma[p]) if c.com.one_way else inv(ma[p]) + inv(mb[p])
            fl += [inv(ma[p]), inv(mb[p]), both] * per_pair
    fl.append(sys.solver.baumgarte_erp)


# ---------------------------------------------------------------------------
# the launch plan and the generated source
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the generated kernel lays out one System.

    An env spreads over `lanes` lanes (a power of two, at least each of
    nb, nj, na, nc and nf): lane b owns body b, lane j computes joint j,
    lane k actuator k, lane c contact c; force f's record sits at lane f.
    A block is one warp of `envs_per_block` envs.  Each body lane gathers, in this order, from the joints where it
    is the child and then the parent (joint order), from the actuators whose
    joint touches it (actuator order, sign +1 parent, -1 child) and, per
    contact group, from the contacts where it is body a and then from the
    two-way contacts where it is body b (contact order each), as the JAX
    package's scatter adds a group's body-a updates before its body-b ones,
    and the forces on it (force order).  A one-way capsule-capsule contact
    (body b frozen) updates body a alone, so no body gathers it as body b.
    A scene without contacts has one empty group.

    A legacy-spring System (`spring`) loops over `passes` = substeps full
    substeps.  Joint j's lane computes its spring and the actuator on it
    (`joint_act`, -1 for none); a body lane gathers the joints it touches in
    joint order (`body_spring_joints`: (joint, +1 as its parent, -1 as its
    child)), as the Pallas body's scatter adds them, and its actuators from
    their joints' lanes.
    """

    nb: int
    nj: int
    na: int
    nc: int
    passes: int
    lanes: int
    envs_per_block: int
    spherical: bool
    joint_parent: Tuple[int, ...]
    joint_child: Tuple[int, ...]
    act_joint: Tuple[int, ...]
    act_col: Tuple[Tuple[int, ...], ...]  # an action column per dof, -1 for none
    contact_a: Tuple[int, ...]
    contact_b: Tuple[int, ...]
    contact_capcap: Tuple[bool, ...]  # a two-way capsule-capsule contact
    body_child_joints: Tuple[Tuple[int, ...], ...]
    body_parent_joints: Tuple[Tuple[int, ...], ...]
    body_actuators: Tuple[Tuple[Tuple[int, int], ...], ...]
    body_contacts: Tuple[Tuple[Tuple[int, ...], ...], ...]
    body_contacts_b: Tuple[Tuple[Tuple[int, ...], ...], ...]  # two-way, body b side
    act_angle: Tuple[bool, ...]  # an angle (not a torque) actuator
    nf: int
    force_twister: Tuple[bool, ...]
    force_col: Tuple[Tuple[int, int, int], ...]  # unclipped
    body_forces: Tuple[Tuple[int, ...], ...]
    contact_oneway: Tuple[bool, ...]  # a one-way capsule-capsule contact
    spring: bool = False
    joint_dof: Tuple[int, ...] = ()  # legacy spring: 1 revolute, 2 universal, 3 spherical
    joint_act: Tuple[int, ...] = ()  # legacy spring: the actuator on the joint, -1 for none
    body_spring_joints: Tuple[Tuple[Tuple[int, int], ...], ...] = ()

    @property
    def euler(self) -> bool:
        """Legacy-spring universal or spherical joints (their Euler angles)."""
        return any(d > 1 for d in self.joint_dof)

    @property
    def capcap(self) -> bool:
        """Any capsule-capsule contact, one-way or two-way."""
        return any(self.contact_capcap) or self.oneway

    @property
    def oneway(self) -> bool:
        return any(self.contact_oneway)

    @property
    def capcap_record(self) -> Tuple[bool, ...]:
        """Per contact: its record is a capsule-capsule one (CC_SIZE floats)."""
        return tuple(a or b for a, b in zip(self.contact_capcap, self.contact_oneway))

    @property
    def angle(self) -> bool:
        return any(self.act_angle)

    @property
    def forces(self) -> bool:
        return self.nf > 0

    @property
    def ng(self) -> int:
        return len(self.body_contacts)

    @functools.cached_property
    def last_act_col(self) -> int:
        """The highest action column an actuator reads, -1 for none.  A
        force's columns are clipped to the action's width, as the JAX
        package's jnp path clips them, so they are not counted here."""
        return max((c for cols in self.act_col for c in cols), default=-1)

    @property
    def threads(self) -> int:
        return self.lanes * self.envs_per_block

    @property
    def widths(self) -> Tuple[int, int, int, int]:
        """(KC, KP, KA, KG): the longest list of each kind, at least 1."""
        return (_longest(self.body_child_joints), _longest(self.body_parent_joints),
                _longest(self.body_actuators),
                _longest([x for g in self.body_contacts for x in g]))

    @property
    def width_b(self) -> int:
        """KGB: the longest body-b contact list, at least 1."""
        return _longest([x for g in self.body_contacts_b for x in g])

    @property
    def width_f(self) -> int:
        """KF: the longest per-body force list, at least 1."""
        return _longest(self.body_forces)

    @property
    def width_sj(self) -> int:
        """KSJ: the longest per-body spring-joint list, at least 1."""
        return _longest(self.body_spring_joints)


def _longest(lists) -> int:
    return max([len(x) for x in lists] + [1])


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def plan(sys: System) -> Plan:
    """The launch plan of `sys` (kept on the System)."""
    p = sys.__dict__.get("_pbd_plan")
    if p is not None:
        return p
    _, itab = pack_tables(sys)
    nb = sys.num_bodies
    nj = sum(g.n for g in sys.joint_groups)
    na = sum(a.n for a in sys.actuator_groups)
    nc = sum(_n_contacts(c) for c in sys.contact_groups)
    nf = sum(f.n for f in sys.force_groups)
    a_int = 1 + MAX_DOF
    spring = sys.dynamics_mode == "legacy_spring"
    at = np.cumsum([0, 2 * nj, a_int * na, 3 * nc, F_INT * nf, SJ_INT * nj * spring])
    joints, acts, contacts, forces, springs = (
        itab[at[i]:at[i + 1]].reshape(-1, size)
        for i, size in enumerate((2, a_int, 3, F_INT, SJ_INT)))
    lanes = _next_pow2(max(nb, nj, na, nc, nf, 1))
    if lanes > WARP:
        raise NotImplementedError(
            f"the CUDA PBD step spreads an env over at most {WARP} lanes; this scene needs "
            f"{lanes} (nb {nb}, nj {nj}, na {na}, nc {nc}, nf {nf})")
    parent, child = joints[:, 0].tolist(), joints[:, 1].tolist()
    groups = max(len(sys.contact_groups), 1)
    per_contact = lambda one_way: tuple(_is_capcap(c) and bool(c.com.one_way) == one_way
                                        for c in sys.contact_groups
                                        for _ in range(_n_contacts(c)))
    capcap, oneway = per_contact(False), per_contact(True)
    listed = lambda side, two_way_only: tuple(
        tuple(tuple(c for c in range(nc) if contacts[c, 0] == g and contacts[c, side] == b
                    and (capcap[c] or not two_way_only))
              for b in range(nb))
        for g in range(groups))
    p = Plan(
        nb=nb, nj=nj, na=na, nc=nc, passes=sys.substeps if spring else sys.substeps // 2,
        lanes=lanes,
        envs_per_block=WARP // lanes,
        spherical=any(g.kind == "spherical" for g in sys.joint_groups),
        joint_parent=tuple(parent), joint_child=tuple(child),
        act_joint=tuple(acts[:, 0].tolist()),
        act_col=tuple(tuple(row) for row in acts[:, 1:].tolist()),
        contact_a=tuple(contacts[:, 1].tolist()), contact_b=tuple(contacts[:, 2].tolist()),
        contact_capcap=capcap,
        body_child_joints=tuple(tuple(j for j in range(nj) if child[j] == b) for b in range(nb)),
        body_parent_joints=tuple(tuple(j for j in range(nj) if parent[j] == b)
                                 for b in range(nb)),
        body_actuators=tuple(
            tuple((k, 1 if parent[j] == b else -1) for k, j in enumerate(acts[:, 0].tolist())
                  if b in (parent[j], child[j]))
            for b in range(nb)),
        body_contacts=listed(1, False),
        body_contacts_b=listed(2, True),
        act_angle=tuple(a.kind == "angle" for a in sys.actuator_groups for _ in range(a.n)),
        nf=nf,
        force_twister=tuple(bool(k) for k in forces[:, 1].tolist()),
        force_col=tuple(tuple(row) for row in forces[:, 2:].tolist()),
        body_forces=tuple(tuple(f for f in range(nf) if forces[f, 0] == b) for b in range(nb)),
        contact_oneway=oneway,
        spring=spring,
        joint_dof=tuple(springs[:, 0].tolist()),
        joint_act=tuple(springs[:, 1].tolist()),
        body_spring_joints=tuple(
            tuple((j, 1 if parent[j] == b else -1) for j in range(nj) if b in (parent[j], child[j]))
            for b in range(nb)) if spring else (),
    )
    sys.__dict__["_pbd_plan"] = p
    return p


def launch_geometry(p: Plan, n: int) -> Tuple[int, int]:
    """(blocks, threads per block) of one launch over n envs."""
    return -(-n // p.envs_per_block), p.threads


def _f32(v) -> str:
    return f"{float(np.float32(v)):.9e}f"


def _lane_floats(name: str, records: np.ndarray, lanes: int) -> str:
    """records (count, fields) as `name[fields][lanes]`, lanes past count 0."""
    count, fields = records.shape
    rows = []
    for f in range(fields):
        vals = [_f32(records[i, f]) if i < count else _f32(0.0) for i in range(lanes)]
        rows.append("{" + ", ".join(vals) + "}")
    return (f"static __device__ const float {name}[{fields}][{lanes}] = {{\n    "
            + ",\n    ".join(rows) + "};\n")


def _ints(values, lanes: int, pad: int) -> str:
    return "{" + ", ".join(str(int(values[i])) if i < len(values) else str(pad)
                           for i in range(lanes)) + "}"


def _lane_ints(name: str, values, lanes: int, pad: int) -> str:
    """values[i] (i < lanes, missing entries `pad`) as `name[lanes]`."""
    return f"static __device__ const int {name}[{lanes}] = {_ints(values, lanes, pad)};\n"


def _lane_int_rows(name: str, rows, lanes: int, pad: int) -> str:
    """rows[r][i] as `name[len(rows)][lanes]`."""
    body = ", ".join(_ints(r, lanes, pad) for r in rows)
    return f"static __device__ const int {name}[{len(rows)}][{lanes}] = {{{body}}};\n"


def _list_rows(lists, width: int, pad: int = -1) -> List[List[int]]:
    """Per-body lists as `width` rows over the bodies, `pad` past each list."""
    return [[x[k] if k < len(x) else pad for x in lists] for k in range(width)]


def scene_header(sys: System) -> str:
    """The scene of `sys` as C++ for the front of pbd_step.cu: counts,
    topology and per-body lists, and pack_tables' values as float literals
    laid out [field][lane]."""
    p = plan(sys)
    ftab, _ = pack_tables(sys)
    L = p.lanes
    kc, kp, ka, kg = p.widths
    at = np.cumsum([0, G_SIZE, B_SIZE * p.nb, J_SIZE * p.nj, A_SIZE * p.na])
    glob, bodies, joints, acts = (
        ftab[at[i]:at[i + 1]].reshape(-1, size)
        for i, size in enumerate((G_SIZE, B_SIZE, J_SIZE, A_SIZE)))
    # the contact records, each in its kind's table at its lane (0 elsewhere)
    contacts = np.zeros((p.nc, C_SIZE), np.float32)
    capcaps = np.zeros((p.nc, CC_SIZE), np.float32)
    start = at[-1]
    for c, is_cc in enumerate(p.capcap_record):
        size = CC_SIZE if is_cc else C_SIZE
        (capcaps if is_cc else contacts)[c] = ftab[start:start + size]
        start += size
    forces = ftab[start:start + F_SIZE * p.nf].reshape(-1, F_SIZE)
    start += F_SIZE * p.nf
    g = glob[0]
    defines = {
        "PBD_NB": p.nb, "PBD_NJ": p.nj, "PBD_NA": p.na, "PBD_NC": p.nc, "PBD_NG": p.ng,
        # a legacy-spring scene loops over its substeps, a PBD one over passes
        "PBD_SUBSTEPS" if p.spring else "PBD_PASSES": p.passes,
        "PBD_LANES": L, "PBD_ENVS_PER_BLOCK": p.envs_per_block,
        "PBD_KC": kc, "PBD_KP": kp, "PBD_KA": ka, "PBD_KG": kg,
        "PBD_DT": _f32(g[0]), "PBD_GRAVITY_X": _f32(g[1]), "PBD_GRAVITY_Y": _f32(g[2]),
        "PBD_GRAVITY_Z": _f32(g[3]), "PBD_VEL_DECAY": _f32(g[4]), "PBD_ANG_DECAY": _f32(g[5]),
        "PBD_COLLIDE_SCALE": _f32(g[6]), "PBD_H": _f32(g[7]), "PBD_VEL_THRESHOLD": _f32(g[8]),
    }
    parts = ["// generated by brax_torch/sim/kernels.py::scene_header\n"]
    parts += [f"#define {k} {v}\n" for k, v in defines.items()]
    if p.spherical:
        parts.append("#define PBD_SPHERICAL 1\n")
    if p.capcap:
        parts.append(f"#define PBD_CAPCAP 1\n#define PBD_KGB {p.width_b}\n")
    if p.oneway:
        parts.append("#define PBD_CAPCAP_ONEWAY 1\n")
    if p.forces:
        parts.append(f"#define PBD_FORCES 1\n#define PBD_NF {p.nf}\n#define PBD_KF {p.width_f}\n")
    if p.angle:
        parts.append("#define PBD_ANGLE 1\n")
    parts += [
        _lane_floats("BODY_F", bodies, L),
        _lane_floats("JOINT_F", joints, L),
        _lane_floats("ACT_F", acts, L),
        _lane_floats("CONTACT_F", contacts, L),
    ]
    con = ", ".join("{" + ", ".join(_ints(r, L, -1) for r in _list_rows(group, kg)) + "}"
                    for group in p.body_contacts)
    parts += [
        _lane_ints("JOINT_P", p.joint_parent, L, 0),
        _lane_ints("JOINT_C", p.joint_child, L, 0),
        _lane_ints("ACT_J", p.act_joint, L, 0),
        _lane_int_rows("ACT_COL", _list_rows(p.act_col, MAX_DOF), L, -1),
        _lane_ints("CONTACT_A", p.contact_a, L, 0),
        _lane_ints("CONTACT_B", p.contact_b, L, 0),
        _lane_int_rows("BODY_CJ", _list_rows(p.body_child_joints, kc), L, -1),
        _lane_int_rows("BODY_PJ", _list_rows(p.body_parent_joints, kp), L, -1),
        _lane_int_rows("BODY_ACT", _list_rows([[k for k, _ in x] for x in p.body_actuators], ka),
                       L, -1),
        _lane_int_rows("BODY_ACT_SIGN",
                       _list_rows([[sg for _, sg in x] for x in p.body_actuators], ka, 0), L, 0),
        f"static __device__ const int BODY_CON[{p.ng}][{kg}][{L}] = {{{con}}};\n",
    ]
    if p.capcap:
        kgb = p.width_b
        con_b = ", ".join("{" + ", ".join(_ints(r, L, -1) for r in _list_rows(group, kgb)) + "}"
                          for group in p.body_contacts_b)
        parts += [
            _lane_floats("CAPCAP_F", capcaps, L),
            _lane_ints("CONTACT_CAPCAP", [int(x) for x in p.contact_capcap], L, 0),
            f"static __device__ const int BODY_CON_B[{p.ng}][{kgb}][{L}] = {{{con_b}}};\n",
        ]
    if p.oneway:
        parts.append(_lane_ints("CONTACT_ONEWAY", [int(x) for x in p.contact_oneway], L, 0))
    if p.forces:
        parts += [
            _lane_floats("FORCE_F", forces, L),
            _lane_int_rows("FORCE_COL", _list_rows(p.force_col, 3), L, 0),
            _lane_ints("FORCE_TWISTER", [int(x) for x in p.force_twister], L, 0),
            _lane_int_rows("BODY_FORCE", _list_rows(p.body_forces, p.width_f), L, -1),
        ]
    if p.angle:
        parts.append(_lane_ints("ACT_ANGLE", [int(x) for x in p.act_angle], L, 0))
    if p.spring:
        parts += _spring_header(p, ftab[start:], L)
    return "".join(parts)


def _spring_header(p: Plan, ftab: np.ndarray, L: int) -> List[str]:
    """A legacy-spring scene's defines and tables: PBD_SPRING, PBD_KSJ (the
    longest per-body spring-joint list), PBD_BAUMGARTE, PBD_SPRING_EULER
    for universal or spherical joints; SPRING_F ([stiffness,
    spring_damping, limit_strength][joint]), JOINT_DOF, JOINT_ACT, SPRING_B_F
    ([1 / mass][body]), SPRING_C_F ([1 / mass_a, 1 / mass_b, the impulse's
    inverse masses][contact]), BODY_SJ and BODY_SJ_SIGN ([k][body])."""
    at = np.cumsum([0, SJ_SIZE * p.nj, SB_SIZE * p.nb, SC_SIZE * p.nc, SG_SIZE])
    joints, bodies, contacts, glob = (ftab[at[i]:at[i + 1]].reshape(-1, size)
                                      for i, size in enumerate((SJ_SIZE, SB_SIZE, SC_SIZE,
                                                                SG_SIZE)))
    ksj = p.width_sj
    parts = [f"#define PBD_SPRING 1\n#define PBD_KSJ {ksj}\n"
             f"#define PBD_BAUMGARTE {_f32(glob[0, 0])}\n"]
    if p.euler:
        parts.append("#define PBD_SPRING_EULER 1\n")
    return parts + [
        _lane_floats("SPRING_F", joints, L),
        _lane_ints("JOINT_DOF", p.joint_dof, L, 1),
        _lane_ints("JOINT_ACT", p.joint_act, L, -1),
        _lane_floats("SPRING_B_F", bodies, L),
        _lane_floats("SPRING_C_F", contacts, L),
        _lane_int_rows("BODY_SJ", _list_rows([[j for j, _ in x] for x in p.body_spring_joints],
                                             ksj), L, -1),
        _lane_int_rows("BODY_SJ_SIGN",
                       _list_rows([[sg for _, sg in x] for x in p.body_spring_joints], ksj, 0),
                       L, 0),
    ]


def kernel_source(sys: System):
    """The path of pbd_step.cu specialised to `sys` (written if missing)."""
    text = scene_header(sys) + "#line 1 \"pbd_step.cu\"\n" + SOURCE.read_text()
    key = hashlib.sha256(text.encode()).hexdigest()[:16]
    path = BUILD_DIR / f"pbd_step_{key}.cu"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(text)
        tmp.replace(path)
    return path


def _setup(lib, path) -> None:
    fn = lib.brax_pbd_step
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("brax_pbd_step_sizes", "brax_pbd_step_occupancy"):
        f = getattr(lib, name)
        f.argtypes, f.restype = [ctypes.c_void_p], ctypes.c_int


_LIBRARIES: Dict[str, cuda_build.Library] = {}


def library(sys: System) -> cuda_build.Library:
    """The kernel for `sys` (built at first use, one per scene)."""
    src = kernel_source(sys)
    lib = _LIBRARIES.get(src.name)
    if lib is None:
        lib = _LIBRARIES[src.name] = cuda_build.Library(src, _setup)
    return lib


def _loaded(sys: System) -> ctypes.CDLL:
    """The loaded kernel for `sys`, its sizes checked against the plan; kept
    on the System so that a step does not regenerate the source."""
    lib = sys.__dict__.get("_pbd_lib")
    if lib is None:
        p = plan(sys)
        lib = library(sys).get()
        sizes = (ctypes.c_int * 9)()
        lib.brax_pbd_step_sizes(sizes)
        want = (p.nb, p.nj, p.na, p.nc, p.ng, p.lanes, p.envs_per_block, p.passes, p.threads)
        if tuple(sizes) != want:
            raise RuntimeError(f"pbd_step build sizes {tuple(sizes)} disagree with the plan "
                               f"{want}")
        sys.__dict__["_pbd_lib"] = lib
    return lib


def resident_blocks(sys: System) -> int:
    """Blocks of the kernel for `sys` resident per SM, as the CUDA runtime
    reckons them on the current device."""
    out = ctypes.c_int(0)
    err = _loaded(sys).brax_pbd_step_occupancy(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"brax_pbd_step_occupancy failed: CUDA error {err}")
    return out.value


def ptxas_report(sys: System) -> str:
    """nvcc's ptxas output for the kernel built for `sys` (registers, spills)."""
    return library(sys).ptxas_report()


def _kernel_info(contact: DP, n: int, device) -> Info:
    """Info as the JAX kernel path returns it: contact impulses summed over
    substeps, zero joint/actuator fields, one placeholder contact per env."""
    zero = torch.zeros_like(contact.vel)
    return Info(
        contact=contact,
        joint=DP(vel=zero, ang=zero),
        actuator=DP(vel=zero, ang=zero),
        contact_pos=torch.zeros((n, 1, 3), device=device),
        contact_normal=torch.zeros((n, 1, 3), device=device),
        contact_penetration=-torch.ones((n, 1), device=device),
    )


def _zero_dp(qp: QP) -> DP:
    return DP(torch.zeros_like(qp.pos), torch.zeros_like(qp.pos))


def _zero_dq(qp: QP) -> DQ:
    return DQ(torch.zeros_like(qp.pos), torch.zeros_like(qp.rot))


def _half_substep(sys: System, qp: QP, act: Tensor) -> QP:
    """Actuator, force and joint-damping impulses, the kinetic step and the
    joint position projection: what both half-substeps share."""
    dp_a = sum((actuators_mod.apply(a, sys.joint_groups[a.group_index], qp, act, sys.nb)
                for a in sys.actuator_groups), _zero_dp(qp))
    dp_j = sum((joints_mod.damp(g, qp, sys.nb) for g in sys.joint_groups), _zero_dp(qp))
    if sys.force_groups:
        dp_f = sum((actuators_mod.force_apply(f, qp, act, sys.nb) for f in sys.force_groups),
                   _zero_dp(qp))
        dp_a = dp_a + dp_f
    qp = sys.integrator.update_acc(qp, dp_a + dp_j)
    qp = sys.integrator.kinetic(qp)
    dq_j = sum((joints_mod.pbd_apply(g, qp, sys.nb) for g in sys.joint_groups), _zero_dq(qp))
    return sys.integrator.update_pos(qp, dq_j)


def _spring_step_plain(sys: System, qp: QP, act: Tensor) -> Tuple[QP, Info]:
    """Legacy-spring dynamics, the counterpart of the JAX package's jnp
    `_spring_step`: per substep, the kinetic step, then the spring joints',
    the actuators' and the forces' accelerations (no joint damping: a spring
    joint's angular damping is in its torque), then the contacts' impulses
    at the velocity level."""
    integ, nb = sys.integrator, sys.nb
    contact = _zero_dp(qp)
    for _ in range(sys.substeps):
        qp = integ.kinetic(qp)
        dp_j = sum((joints_mod.spring_apply(g, qp, nb) for g in sys.joint_groups), _zero_dp(qp))
        dp_a = sum((actuators_mod.apply(a, sys.joint_groups[a.group_index], qp, act, nb)
                    for a in sys.actuator_groups), _zero_dp(qp))
        dp_f = sum((actuators_mod.force_apply(f, qp, act, nb) for f in sys.force_groups),
                   _zero_dp(qp))
        qp = integ.update_acc(qp, dp_j + dp_a + dp_f)
        dp_c = sum((colliders_mod.spring_apply(g, qp, sys.solver, nb)[0]
                    for g in sys.contact_groups), _zero_dp(qp))
        qp = integ.update_vel(qp, dp_c)
        contact = contact + dp_c
    return qp, _kernel_info(contact, qp.pos.shape[0], qp.pos.device)


def pbd_step_plain(sys: System, qp: QP, act: Tensor) -> Tuple[QP, Info]:
    """The kernel's plain-torch twin: same inputs, same outputs.

    Position-based dynamics, two physics substeps per collision pass, a
    Python loop over `substeps // 2` passes; a legacy-spring System runs
    `_spring_step_plain`'s `substeps` full substeps instead.  Info.contact
    holds the contact impulses summed over the passes (substeps);
    Info.joint and Info.actuator are zero, as the JAX kernel path returns
    them.
    """
    if sys.dynamics_mode == "legacy_spring":
        return _spring_step_plain(sys, qp, act)
    integ, nb = sys.integrator, sys.nb
    contact = _zero_dp(qp)
    for _ in range(sys.substeps // 2):
        # -- first half-substep: no collisions --
        qprev = qp
        qp = integ.velocity_projection(_half_substep(sys, qp, act), qprev)

        # -- second half-substep: with collisions --
        qprev = qp
        qp = _half_substep(sys, qp, act)
        collide = [colliders_mod.position_apply(g, qp, qprev, sys.solver, nb)
                   for g in sys.contact_groups]
        qp = integ.update_pos(qp, sum((c[0] for c in collide), _zero_dq(qp)))
        qp_right_before = qp
        qp = integ.velocity_projection(qp, qprev)
        dp_c = sum((colliders_mod.velocity_apply(g, qp, c[1], qp_right_before, c[2],
                                                 sys.solver, nb)
                    for g, c in zip(sys.contact_groups, collide)), _zero_dp(qp))
        qp = integ.update_vel(qp, dp_c)
        contact = contact + dp_c
    return qp, _kernel_info(contact, qp.pos.shape[0], qp.pos.device)


def pbd_step_launch(sys: System, pos: Tensor, rot: Tensor, vel: Tensor, ang: Tensor,
                    act: Tensor) -> Tuple[Tensor, ...]:
    """One kernel launch on the public batch-first layout.

    pos/vel/ang are (N, nb, 3), rot (N, nb, 4) and act (N, n_act), all
    contiguous float32 on one CUDA device.  Returns new pos, rot, vel, ang
    and the contact vel/ang impulses summed over substeps, each (N, nb, C).
    Nothing here waits on the device, so the launch can be captured in a
    CUDA graph.
    """
    ins = (pos, rot, vel, ang, act)
    device = pos.device
    if device.type != "cuda" or any(t.device != device for t in ins):
        raise ValueError(f"pbd_step_launch needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in ins]}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("pbd_step_launch takes float32 tensors only")
    if any(not t.is_contiguous() for t in ins):
        raise ValueError("pbd_step_launch takes contiguous tensors only")
    nb, n = sys.num_bodies, pos.shape[0]
    for name, t, c in (("pos", pos, 3), ("rot", rot, 4), ("vel", vel, 3), ("ang", ang, 3)):
        if t.shape != (n, nb, c):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(n, nb, c)}")
    if act.dim() != 2 or act.shape[0] != n:
        raise ValueError(f"act has shape {tuple(act.shape)}, expected ({n}, n_act)")
    n_act = act.shape[1]
    missing = unsupported_features(sys, n_act)
    if missing:
        raise NotImplementedError(
            "the CUDA PBD step does not cover: " + ", ".join(missing)
            + " (see ROADMAP.md, queue B item 1)"
        )
    p = plan(sys)
    if p.last_act_col >= n_act:
        raise ValueError(f"act has {n_act} columns; the actuators read column {p.last_act_col}")
    if p.forces and n_act < 1:
        raise ValueError("act has no column for the forces to read")

    outs = tuple(torch.empty((n, nb, c), device=device, dtype=torch.float32)
                 for c in (3, 4, 3, 3, 3, 3))
    lib = _loaded(sys)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.brax_pbd_step(*[t.data_ptr() for t in ins + outs], n, n_act, stream)
    if err != 0:
        raise RuntimeError(f"pbd_step kernel launch failed: CUDA error {err}")
    pbd_step_launch.launches += 1
    return outs


pbd_step_launch.launches = 0


def pbd_step(sys: System, qp: QP, act: Tensor) -> Tuple[QP, Info]:
    """One PBD env step for the batch: the twin on CPU tensors, one kernel
    launch (`pbd_step_launch`) on CUDA tensors.

    qp holds (N, nb, 3/4) float32 tensors and act (N, n_act); the kernel
    reads and writes that layout, so a step issues no transpose.
    """
    tensors = (qp.pos, qp.rot, qp.vel, qp.ang, act)
    if all(t.device.type == "cpu" for t in tensors):
        return pbd_step_plain(sys, qp, act)
    outs = pbd_step_launch(sys, *(t.contiguous() for t in tensors))
    qp_out = QP(pos=outs[0], rot=outs[1], vel=outs[2], ang=outs[3])
    return qp_out, _kernel_info(DP(vel=outs[4], ang=outs[5]), qp.pos.shape[0], qp.pos.device)
