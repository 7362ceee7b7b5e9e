"""Dense batched actuators and direct forces, batch-first.

Counterpart of `brax_tpu/sim/actuators.py`.  An `ActuatorGroup` drives a
subset of one joint group; the action vector is gathered with a static index
table whose -1 entries (padded dofs) are masked out.  Torque actuators are
ported, and angle actuators (a PD torque toward the action's angle per
dof; a padded dof of a spherical joint reads no column and PDs toward
clip(0, lo, hi), as in the JAX package).  A
`ForceGroup` pushes bodies straight from three action columns each: a
thruster's linear, a twister's angular velocity change.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from brax_torch.sim import joints as joints_mod
from brax_torch.sim.types import DP, QP, Tensor, index


@dataclass
class ActuatorGroup:
    kind: str  # 'torque' | 'angle'
    group_index: int  # which joint group
    joint_sel: np.ndarray  # (na,) indices into the joint group
    act_index: np.ndarray  # (na, dof) with -1 padding
    strength: Tensor = None  # (na,)

    @property
    def n(self) -> int:
        return len(self.joint_sel)


def _take_group(g: joints_mod.JointGroup, sel: np.ndarray) -> joints_mod.JointGroup:
    """Selects a subset of joints from a group (static selection)."""
    changes = {"parent": g.parent[sel], "child": g.child[sel], "free_dofs": None}
    for f in dataclasses.fields(g):
        val = getattr(g, f.name)
        if isinstance(val, torch.Tensor):
            changes[f.name] = val[index(sel, val.device)]
    return dataclasses.replace(g, **changes)


def apply(a: ActuatorGroup, g: joints_mod.JointGroup, qp: QP, act: Tensor, nb: int) -> DP:
    """Applies actuator torques to the joints' parent/child bodies."""
    if a.kind not in ("torque", "angle"):
        raise ValueError(f"unknown actuator kind: {a.kind}")
    sub = _take_group(g, a.joint_sel)
    qp_p = qp.take(sub.parent)
    qp_c = qp.take(sub.child)

    act_mask = torch.as_tensor(a.act_index >= 0, dtype=act.dtype, device=act.device)
    act_g = act[..., index(np.clip(a.act_index, 0, None), act.device)] * act_mask

    axes, angles = joints_mod.axis_angle(sub, qp_p, qp_c)  # (..., na, dof, 3), (..., na, dof)
    limit_min = sub.limit[..., 0]  # (na, dof)
    limit_max = sub.limit[..., 1]

    if a.kind == "angle":
        # PD toward the action's angle (degrees), clipped to the limits; the
        # parent is pushed opposite to a torque actuator's
        target = torch.clamp(act_g * math.pi / 180, limit_min, limit_max)
        torque_scalar = (target - angles) * a.strength[..., None]
        torque = torch.sum(axes * torque_scalar[..., None], dim=-2)
        dang_p = -sub.inertia_p * torque
        dang_c = sub.inertia_c * torque
    else:
        # -1 so that positive actuation increases the parent-child angle
        torque_scalar = act_g * a.strength[..., None] * -1.0
        torque_scalar = torch.where(angles < limit_min, 0.0, torque_scalar)
        torque_scalar = torch.where(angles > limit_max, 0.0, torque_scalar)
        torque = torch.sum(axes * torque_scalar[..., None], dim=-2)
        dang_p = sub.inertia_p * torque
        dang_c = -sub.inertia_c * torque

    dang = joints_mod._scatter_add3(dang_p, dang_c, sub.parent, sub.child, nb)
    return DP(vel=torch.zeros_like(dang), ang=dang)


@dataclass
class ForceGroup:
    """Direct linear force (thruster) or torque (twister) on bodies."""

    kind: str  # 'thruster' | 'twister'
    body: np.ndarray  # (nf,)
    act_index: np.ndarray  # (nf, 3)
    strength: Tensor = None  # (nf,)
    mass: Tensor = None  # (nf,)

    @property
    def n(self) -> int:
        return len(self.body)


def force_apply(f: ForceGroup, qp: QP, act: Tensor, nb: int) -> DP:
    """Each force's three action columns times strength / mass, on its body.

    The columns are clipped to the width of `act`, as the JAX package's
    `jnp.take(mode="clip")` clips them: inverted_pendulum's thruster reads
    columns 0-2 of a 1-wide action, (a0, a0, a0)."""
    cols = np.clip(f.act_index, 0, act.shape[-1] - 1)
    d = act[..., index(cols, act.device)] * f.strength[..., None] / f.mass[..., None]
    out = act.new_zeros(act.shape[:-1] + (nb, 3))
    moved = joints_mod.scatter_add_bodies(out, f.body, d)
    if f.kind == "thruster":
        return DP(vel=moved, ang=out)
    return DP(vel=out, ang=moved)
