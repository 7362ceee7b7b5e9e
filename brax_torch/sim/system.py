"""The compiled physics system and its batched step, batch-first.

Counterpart of `brax_tpu/sim/system.py`.  A `System` holds dense tensor
tables built from a scene `Config` by `brax_torch.sim.builder`.  One call
steps the whole env batch, so the JAX package's `custom_vmap` rerouting has no
counterpart: `step` goes straight to the fused kernel's wrapper,
`kernels.pbd_step`, which runs the CUDA kernel on CUDA tensors and its
plain-torch twin (`kernels.pbd_step_plain`, the counterpart of `_pbd_step`)
on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from brax_torch.sim import actuators as actuators_mod
from brax_torch.sim import colliders as colliders_mod
from brax_torch.sim import joints as joints_mod
from brax_torch.sim import kernels
from brax_torch.sim.integrator import Integrator
from brax_torch.sim.types import DP, DQ, QP, Info, Tensor


@dataclass
class System:
    """Dense compiled physics system."""

    num_bodies: int
    num_joints: int
    num_joint_dof: int
    num_actuators: int
    num_forces_dof: int
    substeps: int
    dynamics_mode: str
    num_contacts: int
    debug: bool = False
    collider_cutoff: int = 0

    mass: Tensor = None  # (nb,)
    inv_inertia: Tensor = None  # (nb, 3)
    active: Tensor = None  # (nb,) 1.0 if affected by physics
    integrator: Integrator = None
    solver: colliders_mod.SolverParams = None
    joint_groups: Tuple[joints_mod.JointGroup, ...] = ()
    actuator_groups: Tuple[actuators_mod.ActuatorGroup, ...] = ()
    force_groups: Tuple[Any, ...] = ()
    contact_groups: Tuple[colliders_mod.CapsulePlane, ...] = ()

    @property
    def nb(self) -> int:
        return self.num_bodies

    def step(self, qp: QP, act: Tensor) -> Tuple[QP, Info]:
        return step(self, qp, act)

    def info(self, qp: QP) -> Info:
        return info(self, qp)

    def joint_angle_vel(self, qp: QP):
        """Concatenated joint angles/velocities across groups (obs helper)."""
        angles, vels = [], []
        for g in self.joint_groups:
            a, v = joints_mod.angle_vel(g, qp)
            angles.append(a)
            vels.append(v)
        return torch.cat(angles, dim=-1), torch.cat(vels, dim=-1)

    @classmethod
    def from_numpy(cls, tables: Dict[str, Any], device="cuda") -> "System":
        """Loads a System from `flatten` output, e.g. of a JAX-built System."""
        return _unflatten(tables, "", device)


# ---------------------------------------------------------------------------
# tables <-> System
# ---------------------------------------------------------------------------


def flatten(obj) -> Dict[str, Any]:
    """Leaves of a System (this package's, or the JAX package's) as a flat dict.

    Keys are dotted field paths ("joint_groups.0.off_p"); each dataclass also
    records its class name under "<path>.__class__".  Tensors and arrays
    become numpy arrays; None leaves are left out.
    """
    out: Dict[str, Any] = {}

    def walk(x, path):
        if dataclasses.is_dataclass(x):
            out[".".join(path + ["__class__"])] = type(x).__name__
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), path + [f.name])
        elif isinstance(x, (tuple, list)) and x and dataclasses.is_dataclass(x[0]):
            for i, item in enumerate(x):
                walk(item, path + [str(i)])
        elif isinstance(x, (tuple, list)) and not x:
            pass
        elif x is None:
            pass
        elif isinstance(x, (str, bool, int, float)):
            out[".".join(path)] = x
        elif isinstance(x, torch.Tensor):
            out[".".join(path)] = x.detach().cpu().numpy()
        else:
            out[".".join(path)] = np.asarray(x)

    walk(obj, [])
    return out


def _classes():
    return {
        c.__name__: c
        for c in (
            System, Integrator, colliders_mod.SolverParams, joints_mod.JointGroup,
            actuators_mod.ActuatorGroup, colliders_mod.GroupCommon,
            colliders_mod.CapsulePlane,
        )
    }


def _unflatten(tables: Dict[str, Any], prefix: str, device):
    name = tables[prefix + "__class__"]
    cls = _classes().get(name)
    if cls is None:
        raise NotImplementedError(
            f"{name} is not ported yet (see ROADMAP.md, queue B item 1)"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if key + ".__class__" in tables:
            kwargs[f.name] = _unflatten(tables, key + ".", device)
        elif key + ".0.__class__" in tables:
            items = []
            while f"{key}.{len(items)}.__class__" in tables:
                items.append(_unflatten(tables, f"{key}.{len(items)}.", device))
            kwargs[f.name] = tuple(items)
        elif key in tables:
            val = tables[key]
            if f.name == "free_dofs":
                val = tuple(int(v) for v in val)
            elif isinstance(val, np.ndarray) and val.dtype.kind == "f":
                val = torch.tensor(val, dtype=torch.float32, device=device)
            elif isinstance(val, np.ndarray):
                val = val.astype(np.int32)
            kwargs[f.name] = val
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def step(sys: System, qp: QP, act: Tensor) -> Tuple[QP, Info]:
    """One env step for the whole batch: the CUDA kernel on CUDA tensors,
    the plain-torch twin on CPU tensors."""
    return kernels.pbd_step(sys, qp, act)


def info(sys: System, qp: QP) -> Info:
    """State telemetry for reset: contact impulses and joint corrections."""
    nb = sys.nb
    zero = DP(torch.zeros_like(qp.pos), torch.zeros_like(qp.pos))
    collide = [colliders_mod.spring_apply(g, qp, sys.solver, nb) for g in sys.contact_groups]
    contacts = [c[1] for c in collide]
    batch = qp.pos.shape[:-2]
    if contacts:
        pos = torch.cat([c.pos.reshape(batch + (-1, 3)) for c in contacts], dim=-2)
        normal = torch.cat([c.normal.reshape(batch + (-1, 3)) for c in contacts], dim=-2)
        pen = torch.cat([c.penetration.reshape(batch + (-1,)) for c in contacts], dim=-1)
    else:  # one placeholder contact per env
        pos = torch.zeros(batch + (1, 3), device=qp.pos.device)
        normal = torch.zeros_like(pos)
        pen = -torch.ones(batch + (1,), device=qp.pos.device)
    return Info(
        contact=sum((c[0] for c in collide), zero),
        joint=sum((joints_mod.pbd_apply(g, qp, nb) for g in sys.joint_groups),
                  DQ(torch.zeros_like(qp.pos), torch.zeros_like(qp.rot))),
        actuator=zero,
        contact_pos=pos,
        contact_normal=normal,
        contact_penetration=pen,
    )
