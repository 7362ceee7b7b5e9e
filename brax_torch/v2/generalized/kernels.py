"""The fused generalized env step: a hand-written CUDA kernel and its plain
torch version.

Counterpart of `brax_tpu/v2/generalized/kernels.py`.  `gen_step(sys, q, qd,
minv, act, n_frames)` runs all `n_frames` generalized-pipeline frames of an
env step for a whole batch in one launch of `brax_torch/csrc/gen_step.cu`,
which replaces the Pallas kernel `_build_tile_frames`.  On CPU tensors it
runs `gen_step_plain`, the same computation in torch; on CUDA tensors it
launches the kernel or raises, and never falls back.

The semantics are the kernel's, not the pipeline's: each frame recomputes
kinematics, contacts, CoM terms and the mass matrix from (q, qd), refreshes
M^-1 by Newton-Schulz warm-started from the carried inverse, builds the
contact and limit rows, solves the contact forces by FISTA and integrates.
The symmetric products (M, A = J M^-1 J^T, M^-1 diag(d dt) M^-1) are
computed as their upper triangle and mirrored.  A call carries only
(q, qd, M^-1) and returns them with the world transforms, velocities and
contact points of the final q.

The CUDA source is specialised per System: `kernel_source(sys)` writes a
file of compile-time sizes and tree structure followed by the text of
gen_step.cu into `build/brax_torch/`, and `cuda_build` compiles it at first
use.  Scene constants (inertias, frames, axes, limits, gears, contact
geometry) are read from a float table, `pack_tables(sys)`.

The kernel runs a warp per env, the env's workspace in shared memory.
`workspace_bytes` and `block_fixed_bytes` reckon that memory from the
scene's sizes (the header passes both to the source, which checks them
against its own layout); `max_envs_per_block` bounds a block by the 227 KB
a block may take, and `default_envs_per_block` picks the envs per block for
a batch from the waves of blocks the launch takes.

Every sum of the plain version runs left to right, in the order the kernel
sums (`brax_torch/v2/ordered.py`), so that the two round alike.  Kinematics,
contact points, the impedance and the integrator are those of the pipeline
modules (`kinematics`, `geometry/contact`, `generalized/constraint`,
`generalized/integrator`); the CoM terms, mass matrix, Newton-Schulz
refresh, constraint rows and FISTA are written here, per link and per dof,
in the kernel's order.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from brax_torch import cuda_build, maths
from brax_torch.v2 import kinematics, masks, ordered, scan
from brax_torch.v2.base import Q_WIDTHS, QD_WIDTHS, Capsule, Plane, Sphere, System, Tensor
from brax_torch.v2.generalized import constraint, integrator
from brax_torch.v2.generalized.base import State
from brax_torch.v2.geometry import contact

SOURCE = cuda_build.CSRC / "gen_step.cu"
NS_ITERS = 4
# sm_90 (H100): dynamic shared memory one block may take, shared memory per
# SM and the part of it the runtime keeps per resident block; resident
# warps and blocks per SM
MAX_SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
MAX_WARPS_PER_SM = 64
MAX_BLOCKS_PER_SM = 32
# registers: 16,384 in each of an SM's 4 sub-partitions, granted to a warp
# in units of 256
SUBPARTITION_REGISTERS = 16_384
# the kernel's launch bound (gen_step.cu::MAX_ENVS_PER_BLOCK): 16 warps
MAX_ENVS_PER_BLOCK = 16
# A wave of blocks takes about as long with up to this many warps resident
# per SM as with this many, and longer, about as the square root of the
# warps, above it: the per-warp chain of dependent operations sets the
# floor, the SM's issue rate the rise (chip_smoke.py's envs-per-block
# sweep, PERF.md)
WAVE_FLOOR_WARPS = 11
OUT_KEYS = ("q", "qd", "minv", "x_pos", "x_rot", "xd_ang", "xd_vel", "c_pos", "c_pen")

# ---------------------------------------------------------------------------
# coverage
# ---------------------------------------------------------------------------


def unsupported_features(sys: System) -> List[str]:
    """Features of `sys` that the kernel lacks (the JAX package's rule)."""
    missing = []
    bad_links = sorted(set(sys.link_types) - set("f123"))
    if bad_links:
        missing.append(f"link types {bad_links}")
    if sys.actuator_types and set(sys.actuator_types) != {"m"}:
        missing.append(f"actuator types {sorted(set(sys.actuator_types) - {'m'})}")
    for ga, gb in sys.contacts or ():
        if not (isinstance(ga, (Sphere, Capsule)) and isinstance(gb, Plane)):
            missing.append(f"{type(ga).__name__}-{type(gb).__name__} contacts")
        elif gb.link_idx is not None:
            missing.append("planes on a link")
    return missing


def supported(sys: System) -> bool:
    """True when the kernel covers this System."""
    return not unsupported_features(sys)


# ---------------------------------------------------------------------------
# static scene extraction
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, Tensor) else x, np.float32)


def _np_qmul(u, v) -> np.ndarray:
    u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
    return np.asarray([
        u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3],
        u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2],
        u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1],
        u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0],
    ], np.float32)


def _orthogonals_np(n) -> Tuple[np.ndarray, np.ndarray]:
    """maths.orthogonals for a constant normal."""
    n = np.asarray(n, np.float64)
    n_sqr = n[2] * n[2]
    a = n[1] * n[1] + (n_sqr if n_sqr > 0.5 else n[0] * n[0])
    k = np.sqrt(a)
    if a > 0.5:
        p = np.array([0.0, -n[2], n[1]]) * k
        q = np.array([a * k, -n[0] * p[2], n[0] * p[1]])
    else:
        p = np.array([-n[1], n[0], n[1]]) * k
        q = np.array([-n[2] * p[1], n[2] * p[0], a * k])
    return p.astype(np.float32), q.astype(np.float32)


class Plan:
    """A System's static structure and constants, in numpy.

    The counterpart of the JAX package's `_Plan`, whose numbers it repeats:
    the same float32 constants, folded in the same order.
    """

    def __init__(self, sys: System):
        self.nl, self.nq, self.nd = sys.num_links(), sys.q_size(), sys.qd_size()
        self.link_types = sys.link_types
        self.parents = tuple(sys.link_parents)
        self.dt = float(sys.dt)
        self.gravity = _np(sys.gravity)
        self.solver_iters = int(sys.solver_iterations)
        self.q_off, self.qd_off = scan.offsets(sys.link_types)
        self.q_width = [Q_WIDTHS[t] for t in sys.link_types]
        self.qd_width = [QD_WIDTHS[t] for t in sys.link_types]
        self.dof_link = sys.dof_link()
        # transform_com anchors: free links anchor to themselves
        self.com_parent = [i if t == "f" else p
                           for i, (t, p) in enumerate(zip(sys.link_types, self.parents))]

        link = sys.link
        self.t_pos, self.t_rot = _np(link.transform.pos), _np(link.transform.rot)
        self.j_pos, self.j_rot = _np(link.joint.pos), _np(link.joint.rot)
        self.it_pos = _np(link.inertia.transform.pos)
        self.it_rot = _np(link.inertia.transform.rot)
        self.inertia_i, self.mass = _np(link.inertia.i), _np(link.inertia.mass)
        self.link_invweight = _np(link.invweight)
        dof = sys.dof
        self.motion_ang, self.motion_vel = _np(dof.motion.ang), _np(dof.motion.vel)
        self.armature, self.damping = _np(dof.armature), _np(dof.damping)
        self.stiffness, self.dof_invweight = _np(dof.stiffness), _np(dof.invweight)
        self.limit = None if dof.limit is None else (_np(dof.limit[0]), _np(dof.limit[1]))

        self.dof_anc = masks.ancestor_dofs(sys)
        self.sub_link = masks.subtree_links(sys)
        self.dof_pair = masks.dof_pairs(sys)
        self.total_mass = float(self.mass.sum())
        # composite (subtree) masses, summed in float32 from the left
        self.crb_m = [float(sum(self.mass[k] for k in range(self.nl) if self.sub_link[l, k] > 0))
                      for l in range(self.nl)]

        act = sys.actuator
        self.act_gear = _np(act.gear)
        self.act_lo, self.act_hi = _np(act.ctrl_range[:, 0]), _np(act.ctrl_range[:, 1])
        self.act_qdid = [int(i) for i in sys.actuator_qdid]

        # contact points: one per sphere, two per capsule (+end, -end)
        self.points = pts = contact.points(sys)
        self.c_link, self.c_lpos, self.c_normal, self.c_ppos = (
            pts.link, pts.lpos, pts.normal, pts.plane_pos)
        # Python floats: the constants below fold in double, as the JAX plan's do
        self.c_radius = [float(r) for r in pts.radius]
        self.c_friction = [float(f) for f in pts.friction]
        self.nc = len(self.c_link)
        # pyramid directions -(d f - n), constants folded as the JAX plan does
        self.c_dirs = []
        for c in range(self.nc):
            n, fric = self.c_normal[c], self.c_friction[c]
            p, q = _orthogonals_np(n)
            self.c_dirs.append([-(d * f - n) for d in (p, q) for f in (-fric, fric)])
        self.c_diag = [
            float(np.float32(2 * f * f * (t + f * f * t)))
            for f, t in ((self.c_friction[c], float(self.link_invweight[self.c_link[c]]))
                         for c in range(self.nc))]
        # limit rows follow q_idx('123') order
        self.lim_dofs = [d for l, t in enumerate(sys.link_types) if t in "123"
                         for d in range(self.qd_off[l], self.qd_off[l] + self.qd_width[l])]
        self.lim_qs = [qi for l, t in enumerate(sys.link_types) if t in "123"
                       for qi in range(self.q_off[l], self.q_off[l] + self.q_width[l])]
        if self.limit is None:
            self.lim_dofs, self.lim_qs = [], []
        self.nr = 4 * self.nc + len(self.lim_dofs)
        # each row's support: the dofs it touches, ascending
        self.row_dofs = [[d for d in range(self.nd) if self.dof_anc[self.c_link[r // 4], d] > 0]
                         for r in range(4 * self.nc)] + [[d] for d in self.lim_dofs]
        self.dcol = (self.damping.astype(np.float32) * np.float32(self.dt)).astype(np.float32)
        self.has_stiff = [self.link_types[self.dof_link[d]] != "f" and float(self.stiffness[d]) != 0
                          for d in range(self.nd)]
        # static joint frames of roots that are not free (the world anchor)
        self.root_jf = {}
        for l in range(self.nl):
            if self.com_parent[l] == -1:
                self.root_jf[l] = (self.t_pos[l] + contact.np_rotate(self.j_pos[l], self.t_rot[l]),
                                   _np_qmul(self.t_rot[l], self.j_rot[l]))


def plan(sys: System) -> Plan:
    """The System's Plan, built once per System."""
    cached = sys.__dict__.get("_gen_plan")
    if cached is None:
        cached = sys.__dict__["_gen_plan"] = Plan(sys)
    return cached


# ---------------------------------------------------------------------------
# scene tables and the generated source
# ---------------------------------------------------------------------------

# float table records (see gen_step.cu): strides and field offsets
GLOBAL_SIZE = 5  # dt, gravity (3), total mass
LINK_SIZE = 39  # t_pos 3, t_rot 4, j_pos 3, j_rot 4, it_pos 3, it_rot 4, i 9, mass, crb_m,
#                 root joint-frame pos 3, rot 4
DOF_SIZE = 13  # motion ang 3, vel 3, armature, damping, stiffness, damping*dt, invweight,
#                limit lo, limit hi
ACT_SIZE = 3  # gear, ctrl lo, ctrl hi
CONTACT_SIZE = 23  # local pos 3, radius, normal 3, plane pos 3, pyramid dirs 4x3, diag


def pack_tables(sys: System) -> np.ndarray:
    """The scene constants as the kernel's flat float32 table."""
    p = plan(sys)
    fl: List[float] = [p.dt, *p.gravity.tolist(), p.total_mass]
    for l in range(p.nl):
        jf_pos, jf_rot = p.root_jf.get(l, (np.zeros(3), np.array([1.0, 0, 0, 0])))
        fl += [*p.t_pos[l], *p.t_rot[l], *p.j_pos[l], *p.j_rot[l], *p.it_pos[l], *p.it_rot[l],
               *p.inertia_i[l].reshape(-1), p.mass[l], p.crb_m[l], *jf_pos, *jf_rot]
    for d in range(p.nd):
        lo, hi = (-np.inf, np.inf) if p.limit is None else (p.limit[0][d], p.limit[1][d])
        fl += [*p.motion_ang[d], *p.motion_vel[d], p.armature[d], p.damping[d], p.stiffness[d],
               p.dcol[d], p.dof_invweight[d], lo, hi]
    for k in range(len(p.act_qdid)):
        fl += [p.act_gear[k], p.act_lo[k], p.act_hi[k]]
    for c in range(p.nc):
        fl += [*p.c_lpos[c], p.c_radius[c], *p.c_normal[c], *p.c_ppos[c],
               *np.concatenate(p.c_dirs[c]), p.c_diag[c]]
    return np.asarray(fl, dtype=np.float32)


def _r16(n_bytes: int) -> int:
    return -(-n_bytes // 16) * 16


def _dims(p) -> Tuple[int, ...]:
    return p.nl, p.nq, p.nd, p.nc, len(p.act_qdid), p.nr, len(p.lim_dofs)


@functools.lru_cache(maxsize=None)
def _shared_bytes(nl: int, nq: int, nd: int, nc: int, na: int, nr: int,
                  nlim: int) -> Tuple[int, int]:
    """(workspace bytes per env, fixed bytes per block) of a scene's sizes."""
    nc1, na1, nr1 = max(nc, 1), max(na, 1), max(nr, 1)
    size = lambda floats: sum(_r16(4 * f) for f in floats)
    carried = [nq, nd, na1, nd * nd]
    frame = ([3 * nl, 4 * nl, 3 * nc1, nc1, 3, 9 * nl, 3 * nl] + [3 * nd] * 4
             + [3 * nl, 3 * nl, nd * nd, nd, nd])
    scratch = [
        [3 * nl, 4 * nl, 3 * nd, 3 * nd],  # transform_com
        [9 * nl, 3 * nl, 3 * nd, 3 * nd],  # mass_matrix
        [nd * nd] * 4 + [nd],  # inv_ns, the damping fold
        [3 * nl, 3 * nl],  # bias_forces
        [nr1 * nd, nr1 * nd, nr1 * nr1] + [nr1] * 14,  # constraint_forces, fista
        [3 * nl, 3 * nl],  # final velocities
    ]
    workspace = size(carried) + size(frame) + max(size(s) for s in scratch)
    table = GLOBAL_SIZE + nl * LINK_SIZE + nd * DOF_SIZE + na * ACT_SIZE + nc * CONTACT_SIZE
    nlim1 = max(nlim, 1)
    masks = 2 * _r16(8 * nl) + _r16(8 * nd) + _r16(8 * nr1)
    ints = 6 * _r16(4 * nl) + 2 * _r16(4 * nd) + _r16(4 * nc1) + 2 * _r16(4 * nlim1)
    return workspace, _r16(4 * table) + masks + ints


def workspace_bytes(p) -> int:
    """Shared memory of one env's workspace (gen_step.cu's `Work`): every
    member is 16-byte aligned, so a struct is the sum of its members, each
    rounded up to 16 bytes, and the union of stage scratch the largest of
    its structs.  `p` needs nl, nq, nd, nc, nr, act_qdid and lim_dofs (a
    Plan)."""
    return _shared_bytes(*_dims(p))[0]


def block_fixed_bytes(p) -> int:
    """Shared memory of a block before its envs' workspaces: the scene's
    float table and its structure (gen_step.cu's `Scene`)."""
    return _shared_bytes(*_dims(p))[1]


def max_envs_per_block(p) -> int:
    """The most envs one block holds: the shared memory limit, and the
    kernel's launch bound.  Raises NotImplementedError for a scene whose
    workspace does not fit one block with one env."""
    ws, fixed = workspace_bytes(p), block_fixed_bytes(p)
    if fixed + ws > MAX_SMEM_PER_BLOCK:
        raise NotImplementedError(
            f"the generalized kernel needs {fixed + ws} bytes of shared memory for one env "
            f"({ws} of workspace, {fixed} of tables), more than the {MAX_SMEM_PER_BLOCK} a "
            f"block may take")
    return min((MAX_SMEM_PER_BLOCK - fixed) // ws, MAX_ENVS_PER_BLOCK)


def envs_per_sm(p, envs_per_block: int, registers: int = 0) -> int:
    """Envs resident on one SM at `envs_per_block`: by shared memory, warps,
    blocks and, where known, registers per thread."""
    smem = block_fixed_bytes(p) + envs_per_block * workspace_bytes(p)
    blocks = min(SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK), MAX_BLOCKS_PER_SM,
                 MAX_WARPS_PER_SM // envs_per_block)
    if registers:
        per_warp = -(-registers * 32 // 256) * 256
        blocks = min(blocks, 4 * (SUBPARTITION_REGISTERS // per_warp) // envs_per_block)
    return blocks * envs_per_block


def default_envs_per_block(p, n: int, sms: int, registers: int = 0) -> int:
    """Envs per block for n envs on `sms` SMs: the least time by waves of
    blocks, each weighed by the square root of the envs (warps) resident
    per SM, at least WAVE_FLOOR_WARPS; ties go to the larger block, which
    stages the scene once for more envs."""
    def cost(e):
        per_sm = envs_per_sm(p, e, registers)
        if not per_sm:
            return float("inf")
        waves = -(-(-(-n // e)) // (sms * (per_sm // e)))
        return waves * max(per_sm, WAVE_FLOOR_WARPS) ** 0.5
    return min(range(1, max_envs_per_block(p) + 1), key=lambda e: (cost(e), -e))


def launch_geometry(p, n: int, envs_per_block: int) -> Tuple[int, int, int]:
    """(blocks, threads per block, shared memory bytes per block) of one
    launch over n envs, one warp each."""
    if not 1 <= envs_per_block <= max_envs_per_block(p):
        raise ValueError(f"envs_per_block {envs_per_block} is outside 1.."
                         f"{max_envs_per_block(p)} for this scene")
    return (-(-n // envs_per_block), 32 * envs_per_block,
            block_fixed_bytes(p) + envs_per_block * workspace_bytes(p))


def _depths(parents) -> List[int]:
    depth = []
    for par in parents:
        depth.append(0 if par < 0 else depth[par] + 1)
    return depth


def _carray(name: str, ctype: str, values, width: int = 0) -> str:
    vals = [int(v) for v in np.asarray(values).reshape(-1)] or [0]
    dims = f"[{max(len(vals) // width, 1)}][{width}]" if width else f"[{len(vals)}]"
    return f"__constant__ {ctype} {name}{dims} = {{{', '.join(map(str, vals))}}};\n"


def scene_header(sys: System) -> str:
    """Compile-time sizes and tree structure of `sys`, as C++."""
    p = plan(sys)
    na = len(p.act_qdid)
    ltype = [0 if t == "f" else int(t) for t in p.link_types]
    depth = _depths(p.parents)
    # the impedance constants as the JAX package folds them: in double, then
    # rounded to float32 where they meet a float32 array
    dmin, dmax, timeconst = 0.9, 0.95, 0.02
    f32 = lambda v: f"{float(np.float32(v)):.9e}f"
    lines = [
        "// generated by brax_torch/v2/generalized/kernels.py::scene_header\n",
        f"#define GS_IMP_B {f32(2 / (dmax * timeconst))}\n",
        f"#define GS_IMP_K {f32(1 / (dmax * dmax * timeconst * timeconst))}\n",
        f"#define GS_IMP_SPAN {f32(dmax - dmin)}\n",
        f"#define GS_ITERS {p.solver_iters}\n#define GS_NS_ITERS {NS_ITERS}\n",
        f"#define GS_NL {p.nl}\n#define GS_NQ {p.nq}\n#define GS_ND {p.nd}\n",
        f"#define GS_NC {p.nc}\n#define GS_NA {na}\n#define GS_NR {p.nr}\n",
        f"#define GS_NLIM {len(p.lim_dofs)}\n#define GS_DEPTH {max(depth)}\n",
        f"#define GS_WS_BYTES {workspace_bytes(p)}\n",
        f"#define GS_FIXED_BYTES {block_fixed_bytes(p)}\n",
        _carray("LTYPE", "int", ltype),
        _carray("PARENT", "int", p.parents),
        _carray("LDEPTH", "int", depth),
        _carray("COM_PARENT", "int", p.com_parent),
        _carray("Q_OFF", "int", p.q_off),
        _carray("QD_OFF", "int", p.qd_off),
        _carray("QD_WIDTH", "int", p.qd_width),
        _carray("DOF_LINK", "int", p.dof_link),
        _carray("DOF_ANC", "unsigned char", p.dof_anc > 0, p.nd),
        _carray("SUB_LINK", "unsigned char", p.sub_link > 0, p.nl),
        _carray("DOF_PAIR", "unsigned char", p.dof_pair > 0, p.nd),
        _carray("HAS_STIFF", "unsigned char", p.has_stiff),
        _carray("ACT_DOF", "int", p.act_qdid),
        _carray("C_LINK", "int", p.c_link),
        _carray("LIM_Q", "int", p.lim_qs),
        _carray("LIM_D", "int", p.lim_dofs),
    ]
    return "".join(lines)


def kernel_source(sys: System):
    """The path of gen_step.cu specialised to `sys` (written if missing)."""
    text = scene_header(sys) + "#line 1 \"gen_step.cu\"\n" + SOURCE.read_text()
    key = hashlib.sha256(text.encode()).hexdigest()[:16]
    path = cuda_build.BUILD_DIR / f"gen_step_{key}.cu"
    if not path.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(text)
        tmp.replace(path)
    return path


def _setup(lib, path) -> None:
    fn = lib.brax_gen_step
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("brax_gen_step_sizes", "brax_gen_step_init"):
        f = getattr(lib, name)
        f.argtypes, f.restype = [ctypes.c_void_p], ctypes.c_int
    occ = lib.brax_gen_step_occupancy
    occ.argtypes, occ.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int


_LIBRARIES: Dict[str, cuda_build.Library] = {}


def library(sys: System) -> cuda_build.Library:
    """The kernel for `sys` (built at first use, one per scene)."""
    src = kernel_source(sys)
    lib = _LIBRARIES.get(src.name)
    if lib is None:
        lib = _LIBRARIES[src.name] = cuda_build.Library(src, _setup)
    return lib


def _loaded(sys: System, device: torch.device) -> ctypes.CDLL:
    """The loaded kernel for `sys`, its sizes checked against the plan and
    its shared-memory limit raised on `device`; kept on the System so that
    a step does not regenerate the source."""
    lib = sys.__dict__.get("_gen_lib")
    if lib is None:
        p = plan(sys)
        max_envs_per_block(p)  # raises for a workspace that does not fit one block
        lib = library(sys).get()
        sizes = (ctypes.c_int * 9)()
        lib.brax_gen_step_sizes(sizes)
        want = (p.nl, p.nq, p.nd, p.nc, len(p.act_qdid), p.nr, workspace_bytes(p),
                block_fixed_bytes(p), MAX_ENVS_PER_BLOCK)
        if tuple(sizes) != want:
            raise RuntimeError(f"gen_step library sizes {tuple(sizes)} disagree with the plan's "
                               f"{want}")
        sys.__dict__["_gen_lib"] = lib
    ready = sys.__dict__.setdefault("_gen_ready", {})
    if device not in ready:
        attrs = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            err = lib.brax_gen_step_init(attrs)
        if err != 0:
            raise RuntimeError(f"gen_step kernel setup failed: CUDA error {err}")
        ready[device] = {"registers": attrs[0], "local_bytes": attrs[1],
                         "sms": torch.cuda.get_device_properties(device).multi_processor_count}
    return lib


def launch_envs_per_block(sys: System, device: torch.device, n: int) -> int:
    """The default envs per block for n envs of `sys` on `device`
    (`default_envs_per_block` with the loaded kernel's registers)."""
    ready = kernel_attributes(sys, device)
    cache = ready.setdefault("envs_per_block", {})
    if n not in cache:
        cache[n] = default_envs_per_block(plan(sys), n, ready["sms"], ready["registers"])
    return cache[n]


def resident_blocks(sys: System, device: torch.device, envs_per_block: int) -> int:
    """Blocks of `envs_per_block` envs resident per SM on `device`, by the
    CUDA runtime's occupancy calculator."""
    lib = _loaded(sys, device)
    blocks = ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.brax_gen_step_occupancy(envs_per_block, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"gen_step occupancy query failed: CUDA error {err}")
    return blocks.value


def kernel_attributes(sys: System, device: torch.device) -> Dict[str, int]:
    """The loaded kernel on `device`: registers and local (stack) bytes per
    thread as the runtime reports them, and the device's SM count."""
    _loaded(sys, device)
    return sys.__dict__["_gen_ready"][device]


def ptxas_report(sys: System) -> str:
    """nvcc's ptxas output for the kernel of `sys` (registers, stack, spills)."""
    return library(sys).ptxas_report()


def _device_table(sys: System, device: torch.device) -> Tensor:
    cache = sys.__dict__.setdefault("_gen_tables", {})
    if device not in cache:
        cache[device] = torch.as_tensor(pack_tables(sys), device=device)
    return cache[device]


# ---------------------------------------------------------------------------
# the plain version: small algebra on (N, k) tensors, summed left to right
# ---------------------------------------------------------------------------


def _c(v, ref: Tensor) -> Tensor:
    """A constant vector as a tensor on ref's device."""
    return torch.as_tensor(np.asarray(v, np.float32), device=ref.device)


def _q33(q):
    d = ordered.sumsq(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / d
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    return [[1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)]]


def _mm(a, b):
    """(N, m, k) @ (N, k, n), summed over k from the left."""
    out = a[:, :, 0, None] * b[:, None, 0, :]
    for k in range(1, a.shape[2]):
        out = out + a[:, :, k, None] * b[:, None, k, :]
    return out


def _mm_upper(a, b):
    """a @ b for a product known to be symmetric: the upper triangle only,
    each entry summed over k from the left, mirrored into the lower."""
    n = a.shape[1]
    i, j = torch.triu_indices(n, n, device=a.device)
    rows, cols = a[:, i, :], b[:, :, j]
    v = rows[:, :, 0] * cols[:, 0, :]
    for k in range(1, a.shape[2]):
        v = v + rows[:, :, k] * cols[:, k, :]
    out = v.new_empty((a.shape[0], n, n))
    out[:, i, j] = v
    out[:, j, i] = v
    return out


def _transform_com(p: Plan, q, qd, x_pos, x_rot):
    """com, cinr (i (N,3,3), h), cd, cdof, cdofd, as lists per link / dof."""
    xi_pos = [x_pos[l] + ordered.rotate(_c(p.it_pos[l], q).expand_as(x_pos[l]), x_rot[l])
              for l in range(p.nl)]
    xi_rot = [maths.quat_mul(x_rot[l], _c(p.it_rot[l], q).expand_as(x_rot[l]))
              for l in range(p.nl)]
    # divisors are tensors: a CUDA tensor divided by a Python number is
    # multiplied by its reciprocal instead, which rounds otherwise
    com = (ordered.add([float(p.mass[l]) * xi_pos[l] for l in range(p.nl)])
           / q.new_tensor(p.total_mass))

    cinr_i, cinr_h = [], []
    for l in range(p.nl):
        pos = xi_pos[l] - com
        r = _q33(xi_rot[l])
        i0 = p.inertia_i[l]
        ri = [[ordered.add([r[a][k] * float(i0[k, b]) for k in range(3)]) for b in range(3)]
              for a in range(3)]
        h = [maths.cross(pos, _c(-np.eye(3)[k], q).expand_as(pos)) for k in range(3)]
        m = float(p.mass[l])
        cinr_i.append(torch.stack([torch.stack(
            [(ri[a][0] * r[b][0] + ri[a][1] * r[b][1] + ri[a][2] * r[b][2])
             + ordered.dot3(h[a], h[b]) * m for b in range(3)], dim=-1) for a in range(3)],
            dim=-2))
        cinr_h.append(pos * m)

    jf_pos, jf_rot = [], []
    for l in range(p.nl):
        par = p.com_parent[l]
        if par == -1:
            jp, jr = p.root_jf[l]
            jf_pos.append(_c(jp, q).expand_as(com))
            jf_rot.append(_c(jr, q).expand(q.shape[0], 4))
            continue
        a_pos = x_pos[par] + ordered.rotate(_c(p.t_pos[l], q).expand_as(com), x_rot[par])
        a_rot = maths.quat_mul(x_rot[par], _c(p.t_rot[l], q).expand_as(x_rot[par]))
        jf_pos.append(a_pos + ordered.rotate(_c(p.j_pos[l], q).expand_as(com), a_rot))
        jf_rot.append(maths.quat_mul(a_rot, _c(p.j_rot[l], q).expand_as(a_rot)))

    cdof_ang, cdof_vel = [None] * p.nd, [None] * p.nd
    for l, t in enumerate(p.link_types):
        do, qo = p.qd_off[l], p.q_off[l]
        if t == "f":
            for i in range(6):
                d = do + i
                ang = ordered.rotate(_c(p.motion_ang[d], q).expand_as(com), jf_rot[l])
                cdof_ang[d] = ang
                cdof_vel[d] = _c(p.motion_vel[d], q) - maths.cross(com - jf_pos[l], ang)
            continue
        acc_pos = acc_rot = None
        for i in range(p.qd_width[l]):
            d = do + i
            m_ang = _c(p.motion_ang[d], q).expand_as(com)
            m_vel = _c(p.motion_vel[d], q).expand_as(com)
            if acc_rot is None:
                ang_loc, vel_loc = m_ang, m_vel
            else:
                ang_loc = ordered.rotate(m_ang, acc_rot)
                vel_loc = ordered.rotate(m_vel + maths.cross(acc_pos, m_ang), acc_rot)
            ang = ordered.rotate(ang_loc, jf_rot[l])
            cdof_ang[d], cdof_vel[d] = ang, vel_loc - maths.cross(com - jf_pos[l], ang)
            if i + 1 < p.qd_width[l]:
                qi = q[:, qo + i]
                rot_i = ordered.normalize(maths.quat_rot_axis(_c(p.motion_ang[d], q), qi))
                pos_i = _c(p.motion_vel[d], q) * qi[:, None]
                if acc_rot is None:
                    acc_pos, acc_rot = pos_i, rot_i
                else:
                    acc_pos = acc_pos + ordered.rotate(pos_i, acc_rot)
                    acc_rot = maths.quat_mul(acc_rot, rot_i)

    cq_ang = [cdof_ang[d] * qd[:, d, None] for d in range(p.nd)]
    cq_vel = [cdof_vel[d] * qd[:, d, None] for d in range(p.nd)]
    cd_ang, cd_vel = [], []
    for l in range(p.nl):
        dd = [d for d in range(p.nd) if p.dof_anc[l, d] > 0]
        cd_ang.append(ordered.add([cq_ang[d] for d in dd]))
        cd_vel.append(ordered.add([cq_vel[d] for d in dd]))

    cdofd_ang, cdofd_vel = [None] * p.nd, [None] * p.nd
    for l, t in enumerate(p.link_types):
        do = p.qd_off[l]
        if t == "f":
            lin_ang = ordered.add([cq_ang[do + k] for k in range(3)])
            lin_vel = ordered.add([cq_vel[do + k] for k in range(3)])
            for k in range(6):
                d = do + k
                if k < 3:
                    cdofd_ang[d] = cdofd_vel[d] = torch.zeros_like(com)
                else:
                    cdofd_ang[d] = maths.cross(lin_ang, cdof_ang[d])
                    cdofd_vel[d] = (maths.cross(lin_ang, cdof_vel[d])
                                    + maths.cross(lin_vel, cdof_ang[d]))
            continue
        par = p.com_parent[l]
        if par == -1:
            pa = pv = torch.zeros_like(com)
        else:
            pa, pv = cd_ang[par], cd_vel[par]
        for i in range(p.qd_width[l]):
            d = do + i
            cdofd_ang[d] = maths.cross(pa, cdof_ang[d])
            cdofd_vel[d] = maths.cross(pa, cdof_vel[d]) + maths.cross(pv, cdof_ang[d])
            if i + 1 < p.qd_width[l]:
                pa, pv = pa + cq_ang[d], pv + cq_vel[d]
    return com, (cinr_i, cinr_h), (cd_ang, cd_vel), (cdof_ang, cdof_vel), (cdofd_ang, cdofd_vel)


def _mv3(i_mx, v):
    """(N, 3, 3) @ (N, 3), each row summed from the left."""
    return torch.stack([ordered.dot3(i_mx[:, a], v) for a in range(3)], dim=-1)


def _inertia_mul(i_mx, h, mass, m_ang, m_vel):
    return _mv3(i_mx, m_ang) + maths.cross(h, m_vel), mass * m_vel - maths.cross(h, m_ang)


def _bias(p: Plan, qd, cinr, cd, cdof, cdofd):
    """RNE bias force per dof, (N,) each."""
    cinr_i, cinr_h = cinr
    grav = _c(p.gravity, qd)
    cfrc_ang, cfrc_vel = [], []
    for l in range(p.nl):
        dd = [d for d in range(p.nd) if p.dof_anc[l, d] > 0]
        cdd_ang = ordered.add([cdofd[0][d] * qd[:, d, None] for d in dd])
        cdd_vel = ordered.add([cdofd[1][d] * qd[:, d, None] for d in dd]) - grav
        m = float(p.mass[l])
        fa, fv = _inertia_mul(cinr_i[l], cinr_h[l], m, cdd_ang, cdd_vel)
        ia, iv = _inertia_mul(cinr_i[l], cinr_h[l], m, cd[0][l], cd[1][l])
        cfrc_ang.append(fa + maths.cross(cd[0][l], ia) + maths.cross(cd[1][l], iv))
        cfrc_vel.append(fv + maths.cross(cd[0][l], iv))
    bias = []
    for d in range(p.nd):
        ll = [k for k in range(p.nl) if p.sub_link[p.dof_link[d], k] > 0]
        sa, sv = ordered.add([cfrc_ang[k] for k in ll]), ordered.add([cfrc_vel[k] for k in ll])
        bias.append(ordered.dot3(cdof[1][d], sv) + ordered.dot3(cdof[0][d], sa))
    return bias


def _mass_matrix(p: Plan, cinr, cdof):
    """CRB mass matrix (N, nd, nd): lower triangle, mirrored, plus armature."""
    cinr_i, cinr_h = cinr
    f_ang, f_vel = [], []
    for d in range(p.nd):
        l = p.dof_link[d]
        ll = [k for k in range(p.nl) if p.sub_link[l, k] > 0]
        fa, fv = _inertia_mul(ordered.add([cinr_i[k] for k in ll]),
                              ordered.add([cinr_h[k] for k in ll]), p.crb_m[l], cdof[0][d],
                              cdof[1][d])
        f_ang.append(fa)
        f_vel.append(fv)
    zero = torch.zeros_like(f_ang[0][:, 0])
    rows = []
    for i in range(p.nd):
        row = []
        for j in range(p.nd):
            ii, jj = (i, j) if j <= i else (j, i)
            v = (ordered.dot3(f_ang[ii], cdof[0][jj]) + ordered.dot3(f_vel[ii], cdof[1][jj])
                 if p.dof_pair[ii, jj] > 0 else zero)
            if i == j:
                v = v + float(p.armature[i])
            row.append(v)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def _sum_all(m):
    """Sum over the last two axes, row-major from the left."""
    return ordered.add([m[:, i, j] for i in range(m.shape[1]) for j in range(m.shape[2])])


def _inv_ns(mx, minv0, iters=NS_ITERS, tol=1e-12):
    """Newton-Schulz M^-1 warm-started from minv0's upper triangle, mirrored
    (the r0n > 1 fallback starts from 0.5 M / tr(M M)); M is symmetric by
    construction.  The JAX kernel starts from minv0 as it is: each
    iteration doubles its antisymmetric part, which from pipeline.init's
    rounding grows to ~1e-1 over 5 frames (ROADMAP.md, queue C)."""
    nd = mx.shape[1]
    upper = torch.ones((nd, nd), dtype=torch.bool, device=mx.device).triu()
    minv0 = torch.where(upper, minv0, minv0.transpose(1, 2))
    p0 = _mm(mx, minv0)
    tr_p0 = ordered.add([p0[:, i, i] for i in range(nd)])
    r0n = torch.sqrt(torch.clamp(_sum_all(p0 * p0) - 2.0 * tr_p0 + float(nd), min=0.0))
    tr = _sum_all(mx * mx)
    fallback = 0.5 * mx / tr[:, None, None]
    cur = torch.where((r0n > 1.0)[:, None, None], fallback, minv0)
    err = torch.ones_like(r0n)
    for _ in range(iters):
        nxt = 2 * cur - _mm_upper(cur, _mm(mx, cur))
        nxt_err = torch.sqrt(_sum_all((nxt - cur) ** 2))
        live = err > tol
        cur = torch.where(live[:, None, None], nxt, cur)
        err = torch.where(live, nxt_err, err)
    return cur


def _jacobian(p: Plan, q, com, cdof, cpos, cpen):
    """Constraint rows: J (N, nr, nd) with zeros off each row's support,
    pos and diag (N, nr)."""
    n = q.shape[0]
    jac = q.new_zeros((n, p.nr, p.nd))
    pos_rows, diag_rows = [], []
    for c in range(p.nc):
        active = (cpen[c] > 0).to(q.dtype)
        a_vel = {d: cdof[1][d] - maths.cross(cpos[c] - com, cdof[0][d])
                 for d in p.row_dofs[4 * c]}
        for r, dvec in enumerate(p.c_dirs[c]):
            for d, av in a_vel.items():
                jac[:, 4 * c + r, d] = (float(dvec[0]) * av[:, 0] + float(dvec[1]) * av[:, 1]
                                        + float(dvec[2]) * av[:, 2]) * active
            pos_rows.append(-cpen[c] * active)
            diag_rows.append(p.c_diag[c] * active)
    if p.lim_dofs:
        lo, hi = p.limit
        for qi, d in zip(p.lim_qs, p.lim_dofs):
            pos_min = q[:, qi] - float(lo[d])
            pos_max = float(hi[d]) - q[:, qi]
            pos = torch.clamp(torch.minimum(pos_min, pos_max), max=0.0)
            closed = (pos < 0).to(q.dtype)
            jac[:, len(pos_rows), d] = ((pos_min < pos_max).to(q.dtype) * 2 - 1) * closed
            pos_rows.append(pos)
            diag_rows.append(float(p.dof_invweight[d]) * closed)
    return jac, torch.stack(pos_rows, dim=1), torch.stack(diag_rows, dim=1)


def _fista(a, b, maxiter, maxls=5):
    """constraint.fista_nnls with every product summed left to right, in
    the kernel's order.  The pipeline's batched products sum as the JAX
    pipeline's do; over a few frames in contact the line search's accept
    test turns either order's rounding into differences above the
    tolerances, so each route keeps the order of the code it is held to."""
    a_t = a.transpose(1, 2)
    x = torch.zeros_like(b)
    y = x
    t = torch.ones_like(b[:, 0])
    abs_a = torch.abs(a)
    eta = 1.0 / (torch.amax(ordered.add([abs_a[:, :, j] for j in range(a.shape[2])]), dim=1)
                 + 1e-10)
    for _ in range(maxiter):
        r = ordered.rowdot(a, y) + b
        f_y = 0.5 * ordered.sumsq(r)
        g_y = ordered.rowdot(a_t, r)
        etas = [eta * (0.5 ** k) for k in range(maxls)]
        cands, oks = [], []
        for e in etas:
            cand = torch.clamp(y - e[:, None] * g_y, min=0.0)
            diff = cand - y
            f_cand = 0.5 * ordered.sumsq(ordered.rowdot(a, cand) + b)
            dg = ordered.add([diff[:, i] * g_y[:, i] for i in range(diff.shape[1])])
            bound = f_y + dg + 0.5 / e * ordered.sumsq(diff)
            cands.append(cand)
            oks.append(f_cand <= bound + 1e-12)
        x_next, eta_sel, taken = cands[0], etas[0], oks[0]
        for k in range(1, maxls):
            take_k = oks[k] & ~taken
            x_next = torch.where(take_k[:, None], cands[k], x_next)
            eta_sel = torch.where(take_k, etas[k], eta_sel)
            taken = taken | oks[k]
        x_next = torch.where(taken[:, None], x_next, cands[0])
        eta = torch.where(taken, eta_sel, etas[-1] * 0.5)
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = x_next + ((t - 1.0) / t_next)[:, None] * (x_next - x)
        x, t, eta = x_next, t_next, eta * 1.5
    return x


def _frame(sys: System, p: Plan, q, qd, minv_prev, act):
    """One generalized frame: (q, qd, M^-1) -> (q, qd, M^-1)."""
    x_pos, x_rot = kinematics.transforms(sys, q)
    cpos, cpen = contact.penetrations(p.points, x_pos, x_rot)
    com, cinr, cd, cdof, cdofd = _transform_com(p, q, qd, x_pos, x_rot)
    mx = _mass_matrix(p, cinr, cdof)
    minv = _inv_ns(mx, minv_prev)

    bias = _bias(p, qd, cinr, cd, cdof, cdofd)
    tau = [torch.zeros_like(qd[:, 0]) for _ in range(p.nd)]
    for k, d in enumerate(p.act_qdid):
        force = torch.clamp(act[:, k], float(p.act_lo[k]), float(p.act_hi[k]))
        tau[d] = tau[d] + float(p.act_gear[k]) * force
    qf = []
    for d in range(p.nd):
        passive = -float(p.damping[d]) * qd[:, d]
        if p.has_stiff[d]:
            l = p.dof_link[d]
            passive = passive - q[:, p.q_off[l] + (d - p.qd_off[l])] * float(p.stiffness[d])
        qf.append(passive - bias[d] + tau[d])
    qf_smooth = torch.stack(qf, dim=1)

    if p.nr:
        jac, pos_rows, cdiag = _jacobian(p, q, com, cdof, cpos, cpen)
        jqd = torch.stack([ordered.add([jac[:, i, d] * qd[:, d] for d in p.row_dofs[i]])
                           for i in range(p.nr)], dim=1)
        imp, aref = constraint.imp_aref(pos_rows, jqd)
        # jm[i] = row_i @ M^-1 over the row's support
        jm = torch.stack([ordered.add([jac[:, i, d, None] * minv[:, d] for d in p.row_dofs[i]])
                          for i in range(p.nr)], dim=1)
        diag_add = cdiag * (1 - imp) / imp
        cells = [[None] * p.nr for _ in range(p.nr)]
        for i in range(p.nr):
            for j in range(i, p.nr):
                ri, rj = p.row_dofs[i], p.row_dofs[j]
                if len(rj) <= len(ri):
                    v = ordered.add([jac[:, j, d] * jm[:, i, d] for d in rj])
                else:
                    v = ordered.add([jac[:, i, d] * jm[:, j, d] for d in ri])
                if i == j:
                    v = v + diag_add[:, i]
                cells[i][j] = cells[j][i] = v
        amat = torch.stack([torch.stack(r, dim=-1) for r in cells], dim=-2)
        bvec = ordered.rowdot(jm, qf_smooth) - aref
        xsol = _fista(amat, bvec, p.solver_iters)
        qf_c = torch.stack([
            ordered.add([jac[:, i, d] * xsol[:, i] for i in range(p.nr) if d in p.row_dofs[i]]
                        or [torch.zeros_like(qd[:, 0])])
            for d in range(p.nd)], dim=1)
    else:
        qf_c = torch.zeros_like(qd)

    # dof damping folded into M^-1: M^-1 - M^-1 diag(damping dt) M^-1
    minv_d = minv - _mm_upper(minv * _c(p.dcol, q), minv)
    qdd = ordered.rowdot(minv_d, qf_smooth + qf_c)
    q, qd = integrator.integrate(sys, q, qd, qdd, p.dt)
    return q, qd, minv


def gen_step_plain(sys: System, q: Tensor, qd: Tensor, minv: Tensor, act: Tensor,
                   n_frames: int) -> Dict[str, Tensor]:
    """The kernel's plain-torch version: n_frames generalized frames.

    q (N, nq), qd (N, nd), minv (N, nd, nd) and act (N, na) float32.
    Returns {q, qd, minv, x_pos (N, nl, 3), x_rot (N, nl, 4), xd_ang, xd_vel,
    c_pos (N, nc, 3), c_pen (N, nc)}: minv is the inverse the last frame
    used, the rest belong to the final q and qd.
    """
    missing = unsupported_features(sys)
    if missing:
        raise NotImplementedError("the generalized kernel does not cover: " + ", ".join(missing)
                                  + " (see ROADMAP.md, queue B item 2)")
    p = plan(sys)
    for _ in range(n_frames):
        q, qd, minv = _frame(sys, p, q, qd, minv, act)
    x_pos, x_rot = kinematics.transforms(sys, q)
    xd_ang, xd_vel = kinematics.motions(sys, q, qd, x_pos, x_rot)
    cpos, cpen = contact.penetrations(p.points, x_pos, x_rot)
    stack = lambda xs: torch.stack(xs, dim=1)
    out = dict(q=q, qd=qd, minv=minv, x_pos=stack(x_pos), x_rot=stack(x_rot),
               xd_ang=stack(xd_ang), xd_vel=stack(xd_vel))
    if p.nc:
        out.update(c_pos=stack(cpos), c_pen=stack(cpen))
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def out_shapes(sys: System) -> Dict[str, Tuple[int, ...]]:
    """Each output's per-env shape, in OUT_KEYS order."""
    p = plan(sys)
    shapes = dict(q=(p.nq,), qd=(p.nd,), minv=(p.nd, p.nd), x_pos=(p.nl, 3), x_rot=(p.nl, 4),
                  xd_ang=(p.nl, 3), xd_vel=(p.nl, 3))
    if p.nc:
        shapes.update(c_pos=(p.nc, 3), c_pen=(p.nc,))
    return shapes


def gen_step_soa(sys: System, q_t: Tensor, qd_t: Tensor, minv_t: Tensor, act_t: Tensor,
                 n_frames: int, block: int = 0) -> Dict[str, Tensor]:
    """The kernel on its own layout: one launch, no transposes.

    Inputs are (field, N): q_t (nq, N), qd_t (nd, N), minv_t (nd*nd, N) and
    act_t (na, N), contiguous float32 on one CUDA device.  Each env takes
    one warp; `block` is the number of envs (warps) per block, 0 for
    `default_envs_per_block`.  Returns the outputs of `gen_step_plain` in
    the same layout, each (fields, N).
    """
    ins = (q_t, qd_t, minv_t, act_t)
    device = q_t.device
    if device.type != "cuda" or any(t.device != device for t in ins):
        raise ValueError(f"gen_step_soa needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in ins]}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("gen_step_soa takes float32 tensors only")
    if any(not t.is_contiguous() for t in ins):
        raise ValueError("gen_step_soa takes contiguous tensors only")
    missing = unsupported_features(sys)
    if missing:
        raise NotImplementedError("the generalized kernel does not cover: " + ", ".join(missing)
                                  + " (see ROADMAP.md, queue B item 2)")
    p = plan(sys)
    n = q_t.shape[-1]
    na = len(p.act_qdid)
    for name, t, rows in (("q", q_t, p.nq), ("qd", qd_t, p.nd), ("minv", minv_t, p.nd * p.nd),
                          ("act", act_t, na)):
        if t.shape != (rows, n):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(rows, n)}")
    lib = _loaded(sys, device)
    block = block or launch_envs_per_block(sys, device, n)
    launch_geometry(p, n, block)  # checks block against the scene's shared memory
    outs = {k: torch.empty((int(np.prod(s)), n), device=device, dtype=torch.float32)
            for k, s in out_shapes(sys).items()}
    if not p.nc:  # the kernel always takes contact outputs
        outs["c_pos"] = outs["c_pen"] = torch.empty((1, n), device=device)
    table = _device_table(sys, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.brax_gen_step(*[t.data_ptr() for t in ins],
                            *[outs[k].data_ptr() for k in OUT_KEYS], table.data_ptr(),
                            n, n_frames, block, stream)
    if err != 0:
        raise RuntimeError(f"gen_step kernel launch failed: CUDA error {err}")
    gen_step_soa.launches += 1
    if not p.nc:
        del outs["c_pos"], outs["c_pen"]
    return outs


gen_step_soa.launches = 0


def gen_step(sys: System, q: Tensor, qd: Tensor, minv: Tensor, act: Tensor,
             n_frames: int) -> Dict[str, Tensor]:
    """n_frames frames for the batch: the plain version on CPU tensors, one
    kernel launch (`gen_step_soa`) on CUDA tensors.  Shapes as in
    `gen_step_plain`; on CUDA the outputs are (N, ...) views of the
    kernel's (fields, N) outputs."""
    if all(t.device.type == "cpu" for t in (q, qd, minv, act)):
        return gen_step_plain(sys, q, qd, minv, act, n_frames)
    n = q.shape[0]
    soa = lambda x: x.reshape(n, -1).t().contiguous()
    outs = gen_step_soa(sys, soa(q), soa(qd), soa(minv), soa(act), n_frames)
    shapes = out_shapes(sys)
    return {k: v.t().reshape((n,) + shapes[k]) for k, v in outs.items()}


def gen_step_state(sys: System, state: State, act: Tensor, n_frames: int) -> State:
    """An env step of the pipeline State through `gen_step`.

    As in the JAX package's kernel path, only q, qd, x, xd, the contact
    points and mass_mx_inv are refreshed; the other cached fields keep the
    values they came in with (no env or wrapper reads them between steps).
    """
    out = gen_step(sys, state.q, state.qd, state.mass_mx_inv, act, n_frames)
    new = state.replace(
        q=out["q"], qd=out["qd"], mass_mx_inv=out["minv"],
        x=state.x.replace(pos=out["x_pos"], rot=out["x_rot"]),
        xd=state.xd.replace(ang=out["xd_ang"], vel=out["xd_vel"]))
    if "c_pos" in out and state.contact is not None:
        new = new.replace(contact=state.contact.replace(pos=out["c_pos"],
                                                        penetration=out["c_pen"]))
    return new
