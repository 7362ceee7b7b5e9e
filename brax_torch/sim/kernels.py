"""The fused PBD step: a hand-written CUDA kernel and its plain-torch twin.

Counterpart of `brax_tpu/sim/kernels.py`.  `pbd_step(sys, qp, act)` steps a
whole env batch with one launch of `brax_torch/csrc/pbd_step.cu`, which
replaces the Pallas kernel `_build_tile_step`.  On CPU tensors it runs
`pbd_step_plain`, the same step written with the sim modules' torch
functions (the counterpart of the JAX package's jnp `_pbd_step`); on CUDA
tensors it launches the kernel or raises, and never falls back to the twin.

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
place of the revolute ones.
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
MAX_BODIES, MAX_CONTACTS, MAX_ACT = 16, 32, 32
WARP = 32
# pack_tables' record sizes, in floats: globals, body, joint, actuator, contact
G_SIZE, B_SIZE, J_SIZE, A_SIZE, C_SIZE = 9, 14, 33, 1, 6
# the most dofs of a joint, and so action columns of an actuator
MAX_DOF = 3


# ---------------------------------------------------------------------------
# coverage
# ---------------------------------------------------------------------------


def unsupported_features(sys: System, n_act: int = 0) -> List[str]:
    """Features of `sys` (and of an action width) that the kernel lacks."""
    missing = []
    if sys.dynamics_mode != "pbd":
        missing.append(f"dynamics_mode={sys.dynamics_mode!r}")
    if sys.collider_cutoff:
        missing.append("collider_cutoff")
    for g in sys.joint_groups:
        if g.kind not in ("revolute", "spherical"):
            missing.append(f"{g.kind} joints")
        elif g.kind == "spherical" and g.dof != MAX_DOF:
            missing.append(f"{g.dof}-dof spherical joints")
    if len({g.kind for g in sys.joint_groups}) > 1:
        missing.append("revolute and spherical joints in one System")
    for a in sys.actuator_groups:
        if a.kind != "torque":
            missing.append(f"{a.kind} actuators")
    if sys.force_groups:
        missing.append("thruster/twister forces")
    for c in sys.contact_groups:
        if not isinstance(c, colliders_mod.CapsulePlane):
            missing.append(f"{type(c).__name__} contacts")
        elif not c.com.one_way:
            missing.append("two-way CapsulePlane contacts")
    if sys.num_bodies > MAX_BODIES:
        missing.append(f"{sys.num_bodies} bodies (the kernel holds {MAX_BODIES})")
    if sum(_n_contacts(c) for c in sys.contact_groups) > MAX_CONTACTS:
        missing.append(f"more than {MAX_CONTACTS} contact points")
    if n_act > MAX_ACT:
        missing.append(f"{n_act} action columns (the kernel holds {MAX_ACT})")
    return missing


def supported(sys: System) -> bool:
    """True if the kernel covers this system's features."""
    return not unsupported_features(sys)


def _n_contacts(c) -> int:
    end = getattr(c, "end", None)
    return 0 if end is None else end.shape[0] * end.shape[1]


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
    and contact (end[3], radius, friction, elasticity) records in the float
    table; joint (parent, child), actuator (joint, an action column per dof,
    -1 for a padded dof and past the joint's dofs) and contact (group, body
    a, body b) records in the int table.  Contacts are listed group by group.
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
        end, radius = f64(c.end), f64(c.radius)
        friction, elasticity = f64(c.com.friction), f64(c.com.elasticity)
        for p in range(end.shape[0]):
            for e in range(end.shape[1]):
                fl += [*end[p, e], radius[p], friction[p], elasticity[p]]
                il += [gi, int(c.com.body_a[p]), int(c.com.body_b[p])]
    return np.asarray(fl, dtype=np.float32), np.asarray(il, dtype=np.int32)


# ---------------------------------------------------------------------------
# the launch plan and the generated source
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the generated kernel lays out one System.

    An env spreads over `lanes` lanes (a power of two, at least each of
    nb, nj, na and nc): lane b owns body b, lane j computes joint j, lane k
    actuator k, lane c contact c.  A block is one warp of `envs_per_block`
    envs.  Each body lane gathers, in this order, from the joints where it
    is the child and then the parent (joint order), from the actuators whose
    joint touches it (actuator order, sign +1 parent, -1 child) and, per
    contact group, from its contacts (contact order).  A scene without
    contacts has one empty group.
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
    body_child_joints: Tuple[Tuple[int, ...], ...]
    body_parent_joints: Tuple[Tuple[int, ...], ...]
    body_actuators: Tuple[Tuple[Tuple[int, int], ...], ...]
    body_contacts: Tuple[Tuple[Tuple[int, ...], ...], ...]

    @property
    def ng(self) -> int:
        return len(self.body_contacts)

    @functools.cached_property
    def last_act_col(self) -> int:
        """The highest action column an actuator reads, -1 for none."""
        return max((c for cols in self.act_col for c in cols), default=-1)

    @property
    def threads(self) -> int:
        return self.lanes * self.envs_per_block

    @property
    def widths(self) -> Tuple[int, int, int, int]:
        """(KC, KP, KA, KG): the longest list of each kind, at least 1."""
        longest = lambda lists: max([len(x) for x in lists] + [1])
        return (longest(self.body_child_joints), longest(self.body_parent_joints),
                longest(self.body_actuators),
                longest([x for g in self.body_contacts for x in g]))


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
    a_int = 1 + MAX_DOF
    joints = itab[:2 * nj].reshape(nj, 2)
    acts = itab[2 * nj:2 * nj + a_int * na].reshape(na, a_int)
    contacts = itab[2 * nj + a_int * na:].reshape(nc, 3)
    lanes = _next_pow2(max(nb, nj, na, nc, 1))
    if lanes > WARP:
        raise NotImplementedError(
            f"the CUDA PBD step spreads an env over at most {WARP} lanes; this scene needs "
            f"{lanes} (nb {nb}, nj {nj}, na {na}, nc {nc})")
    parent, child = joints[:, 0].tolist(), joints[:, 1].tolist()
    groups = max(len(sys.contact_groups), 1)
    p = Plan(
        nb=nb, nj=nj, na=na, nc=nc, passes=sys.substeps // 2, lanes=lanes,
        envs_per_block=WARP // lanes,
        spherical=any(g.kind == "spherical" for g in sys.joint_groups),
        joint_parent=tuple(parent), joint_child=tuple(child),
        act_joint=tuple(acts[:, 0].tolist()),
        act_col=tuple(tuple(row) for row in acts[:, 1:].tolist()),
        contact_a=tuple(contacts[:, 1].tolist()), contact_b=tuple(contacts[:, 2].tolist()),
        body_child_joints=tuple(tuple(j for j in range(nj) if child[j] == b) for b in range(nb)),
        body_parent_joints=tuple(tuple(j for j in range(nj) if parent[j] == b)
                                 for b in range(nb)),
        body_actuators=tuple(
            tuple((k, 1 if parent[j] == b else -1) for k, j in enumerate(acts[:, 0].tolist())
                  if b in (parent[j], child[j]))
            for b in range(nb)),
        body_contacts=tuple(
            tuple(tuple(c for c in range(nc) if contacts[c, 0] == g and contacts[c, 1] == b)
                  for b in range(nb))
            for g in range(groups)),
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
    at = np.cumsum([0, G_SIZE, B_SIZE * p.nb, J_SIZE * p.nj, A_SIZE * p.na, C_SIZE * p.nc])
    glob, bodies, joints, acts, contacts = (
        ftab[at[i]:at[i + 1]].reshape(-1, size)
        for i, size in enumerate((G_SIZE, B_SIZE, J_SIZE, A_SIZE, C_SIZE)))
    g = glob[0]
    defines = {
        "PBD_NB": p.nb, "PBD_NJ": p.nj, "PBD_NA": p.na, "PBD_NC": p.nc, "PBD_NG": p.ng,
        "PBD_PASSES": p.passes, "PBD_LANES": L, "PBD_ENVS_PER_BLOCK": p.envs_per_block,
        "PBD_KC": kc, "PBD_KP": kp, "PBD_KA": ka, "PBD_KG": kg,
        "PBD_DT": _f32(g[0]), "PBD_GRAVITY_X": _f32(g[1]), "PBD_GRAVITY_Y": _f32(g[2]),
        "PBD_GRAVITY_Z": _f32(g[3]), "PBD_VEL_DECAY": _f32(g[4]), "PBD_ANG_DECAY": _f32(g[5]),
        "PBD_COLLIDE_SCALE": _f32(g[6]), "PBD_H": _f32(g[7]), "PBD_VEL_THRESHOLD": _f32(g[8]),
    }
    parts = ["// generated by brax_torch/sim/kernels.py::scene_header\n"]
    parts += [f"#define {k} {v}\n" for k, v in defines.items()]
    if p.spherical:
        parts.append("#define PBD_SPHERICAL 1\n")
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
    return "".join(parts)


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
    """Actuator and joint-damping impulses, the kinetic step and the joint
    position projection: what both half-substeps share."""
    dp_a = sum((actuators_mod.apply(a, sys.joint_groups[a.group_index], qp, act, sys.nb)
                for a in sys.actuator_groups), _zero_dp(qp))
    dp_j = sum((joints_mod.damp(g, qp, sys.nb) for g in sys.joint_groups), _zero_dp(qp))
    qp = sys.integrator.update_acc(qp, dp_a + dp_j)
    qp = sys.integrator.kinetic(qp)
    dq_j = sum((joints_mod.pbd_apply(g, qp, sys.nb) for g in sys.joint_groups), _zero_dq(qp))
    return sys.integrator.update_pos(qp, dq_j)


def pbd_step_plain(sys: System, qp: QP, act: Tensor) -> Tuple[QP, Info]:
    """The kernel's plain-torch twin: same inputs, same outputs.

    Position-based dynamics, two physics substeps per collision pass, a
    Python loop over `substeps // 2` passes.  Info.contact holds the contact
    impulses summed over the passes; Info.joint and Info.actuator are zero,
    as the JAX kernel path returns them.
    """
    if sys.dynamics_mode != "pbd":
        raise NotImplementedError(
            f"dynamics_mode={sys.dynamics_mode!r} is not ported yet (see ROADMAP.md)"
        )
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
