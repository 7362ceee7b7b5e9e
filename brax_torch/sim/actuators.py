"""Dense batched actuators, batch-first.

Counterpart of `brax_tpu/sim/actuators.py`.  An `ActuatorGroup` drives a
subset of one joint group; the action vector is gathered with a static index
table whose -1 entries (padded dofs) are masked out.  This slice ports the
torque actuator; angle actuators and thruster/twister forces are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from brax_torch.sim import joints as joints_mod
from brax_torch.sim.types import DP, QP, Tensor, index


@dataclass
class ActuatorGroup:
    kind: str  # only 'torque' is ported
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
    if a.kind != "torque":
        raise NotImplementedError(
            f"{a.kind} actuators are not ported yet (see ROADMAP.md, queue B item 1)"
        )
    sub = _take_group(g, a.joint_sel)
    qp_p = qp.take(sub.parent)
    qp_c = qp.take(sub.child)

    act_mask = torch.as_tensor(a.act_index >= 0, dtype=act.dtype, device=act.device)
    act_g = act[..., index(np.clip(a.act_index, 0, None), act.device)] * act_mask

    axes, angles = joints_mod.axis_angle(sub, qp_p, qp_c)  # (..., na, dof, 3), (..., na, dof)
    limit_min = sub.limit[..., 0]  # (na, dof)
    limit_max = sub.limit[..., 1]

    # -1 so that positive actuation increases the parent-child angle
    torque_scalar = act_g * a.strength[..., None] * -1.0
    torque_scalar = torch.where(angles < limit_min, 0.0, torque_scalar)
    torque_scalar = torch.where(angles > limit_max, 0.0, torque_scalar)
    torque = torch.sum(axes * torque_scalar[..., None], dim=-2)
    dang_p = sub.inertia_p * torque
    dang_c = -sub.inertia_c * torque

    dang = joints_mod._scatter_add3(dang_p, dang_c, sub.parent, sub.child, nb)
    return DP(vel=torch.zeros_like(dang), ang=dang)
