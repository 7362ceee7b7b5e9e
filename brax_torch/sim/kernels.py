"""The fused PBD step: a hand-written CUDA kernel and its plain-torch twin.

Counterpart of `brax_tpu/sim/kernels.py`.  `pbd_step(sys, qp, act)` steps a
whole env batch with one launch of `brax_torch/csrc/pbd_step.cu`, which
replaces the Pallas kernel `_build_tile_step`.  On CPU tensors it runs
`pbd_step_plain`, the same step written with the sim modules' torch
functions (the counterpart of the JAX package's jnp `_pbd_step`); on CUDA
tensors it launches the kernel or raises, and never falls back to the twin.

The kernel is built with nvcc at first use, into `build/brax_torch/` beside
the package, keyed by a hash of its source, and loaded with ctypes
(`brax_torch/cuda_build.py`).
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, List, Tuple

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
# must equal MAX_BODIES / MAX_CONTACTS / MAX_ACT in pbd_step.cu (checked at load)
MAX_BODIES, MAX_CONTACTS, MAX_ACT = 16, 16, 32
# 64-thread blocks: 4096 envs spread over 64 blocks, so over 64 of the 132 SMs
BLOCK = 64


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
        if g.kind != "revolute":
            missing.append(f"{g.kind} joints")
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
    """The scene as the kernel's flat float32 and int32 tables.

    Layouts (see pbd_step.cu): globals, then per body, joint, actuator and
    contact records in the float table; joint, actuator and contact index
    records in the int table.  Contacts are listed group by group.
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
        for j in range(g.n):
            fl += [*off_p[j], *off_c[j], *axis_p[j].reshape(-1), *axis_c[j].reshape(-1),
                   limit[j, 0, 0], limit[j, 0, 1], damping[j], sp[j], sa[j]]
            il += [int(g.parent[j]), int(g.child[j])]
    for a in sys.actuator_groups:
        strength = f64(a.strength)
        for k in range(a.n):
            fl.append(strength[k])
            il += [joint_base[a.group_index] + int(a.joint_sel[k]), int(a.act_index[k][0])]
    for gi, c in enumerate(sys.contact_groups):
        end, radius = f64(c.end), f64(c.radius)
        friction, elasticity = f64(c.com.friction), f64(c.com.elasticity)
        for p in range(end.shape[0]):
            for e in range(end.shape[1]):
                fl += [*end[p, e], radius[p], friction[p], elasticity[p]]
                il += [gi, int(c.com.body_a[p]), int(c.com.body_b[p])]
    return np.asarray(fl, dtype=np.float32), np.asarray(il, dtype=np.int32)


def _device_tables(sys: System, device: torch.device) -> Tuple[Tensor, Tensor]:
    """pack_tables on `device`, built once per System and device."""
    cache = sys.__dict__.setdefault("_kernel_tables", {})
    if device not in cache:
        ftab, itab = pack_tables(sys)
        cache[device] = (torch.as_tensor(ftab, device=device),
                         torch.as_tensor(itab, device=device))
    return cache[device]


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------


def _setup(lib, path) -> None:
    fn = lib.brax_pbd_step
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name, want in (("brax_pbd_step_max_bodies", MAX_BODIES),
                       ("brax_pbd_step_max_contacts", MAX_CONTACTS),
                       ("brax_pbd_step_max_act", MAX_ACT)):
        getter = getattr(lib, name)
        getter.argtypes, getter.restype = [], ctypes.c_int
        if getter() != want:
            raise RuntimeError(f"{name} in {path} disagrees with kernels.py")


_LIBRARY = cuda_build.Library(SOURCE, _setup)


def ptxas_report() -> str:
    """nvcc's ptxas output for the loaded kernel (registers, spills)."""
    return _LIBRARY.ptxas_report()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


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


def pbd_step_soa(sys: System, pos: Tensor, rot: Tensor, vel: Tensor, ang: Tensor,
                 act_t: Tensor) -> Tuple[Tensor, ...]:
    """The kernel on its own layout: one launch, no transposes.

    pos/vel/ang are (nb, 3, N), rot (nb, 4, N) and act_t (n_act, N), all
    contiguous float32 on one CUDA device.  Returns new pos, rot, vel, ang
    and the contact vel/ang impulses summed over substeps, each (nb, C, N).
    """
    ins = (pos, rot, vel, ang, act_t)
    device = pos.device
    if device.type != "cuda" or any(t.device != device for t in ins):
        raise ValueError(f"pbd_step_soa needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in ins]}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("pbd_step_soa takes float32 tensors only")
    if any(not t.is_contiguous() for t in ins):
        raise ValueError("pbd_step_soa takes contiguous tensors only")
    nb, n = sys.num_bodies, pos.shape[-1]
    for name, t, c in (("pos", pos, 3), ("rot", rot, 4), ("vel", vel, 3), ("ang", ang, 3)):
        if t.shape != (nb, c, n):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(nb, c, n)}")
    if act_t.dim() != 2 or act_t.shape[1] != n:
        raise ValueError(f"act_t has shape {tuple(act_t.shape)}, expected (n_act, {n})")
    n_act = act_t.shape[0]
    missing = unsupported_features(sys, n_act)
    if missing:
        raise NotImplementedError(
            "the CUDA PBD step does not cover: " + ", ".join(missing)
            + " (see ROADMAP.md, queue B item 1)"
        )
    used = [int(a.act_index.max()) for a in sys.actuator_groups if a.n]
    if used and max(used) >= n_act:
        raise ValueError(f"act has {n_act} columns; the actuators read column {max(used)}")

    outs = tuple(torch.empty((nb, c, n), device=device, dtype=torch.float32)
                 for c in (3, 4, 3, 3, 3, 3))
    ftab, itab = _device_tables(sys, device)
    nj = sum(g.n for g in sys.joint_groups)
    na = sum(a.n for a in sys.actuator_groups)
    nc = sum(_n_contacts(c) for c in sys.contact_groups)
    lib = _LIBRARY.get()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.brax_pbd_step(
        *[t.data_ptr() for t in ins + outs], ftab.data_ptr(), itab.data_ptr(),
        n, nb, nj, na, nc, n_act, sys.substeps // 2, BLOCK, stream,
    )
    if err != 0:
        raise RuntimeError(f"pbd_step kernel launch failed: CUDA error {err}")
    pbd_step_soa.launches += 1
    return outs


pbd_step_soa.launches = 0


def pbd_step(sys: System, qp: QP, act: Tensor) -> Tuple[QP, Info]:
    """One PBD env step for the batch: the twin on CPU tensors, one kernel
    launch (`pbd_step_soa`) on CUDA tensors.

    qp holds (N, nb, 3/4) float32 tensors and act (N, n_act).  On CUDA the
    returned QP and Info.contact are (N, nb, C) views of the kernel's
    (nb, C, N) outputs, so feeding them back into the next step costs no
    transpose.
    """
    tensors = (qp.pos, qp.rot, qp.vel, qp.ang, act)
    if all(t.device.type == "cpu" for t in tensors):
        return pbd_step_plain(sys, qp, act)
    n = qp.pos.shape[0]
    soa = lambda x: x.permute(1, 2, 0).contiguous()  # (N, nb, C) -> (nb, C, N)
    outs = pbd_step_soa(sys, soa(qp.pos), soa(qp.rot), soa(qp.vel), soa(qp.ang),
                        act.t().contiguous())
    aos = lambda x: x.permute(2, 0, 1)  # (nb, C, N) -> (N, nb, C) view
    qp_out = QP(pos=aos(outs[0]), rot=aos(outs[1]), vel=aos(outs[2]), ang=aos(outs[3]))
    return qp_out, _kernel_info(DP(vel=aos(outs[4]), ang=aos(outs[5])), n, qp.pos.device)
