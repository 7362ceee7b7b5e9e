"""Per-component observation builders, batch-first.

Counterpart of `brax_tpu/composer/observers.py`.  Named observers produce
(name, (N, k) tensor) entries per component; the env concatenates them in
a fixed order.  The `cfrc` observer reads `Info.contact`, which the kernel
route returns (its `Info.actuator` and `Info.joint` are zero, as in the JAX
package's kernel route).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from brax_torch.sim.types import QP, Info, Tensor


def component_obs(env, comp: dict, qp: QP, info: Info) -> List[Tuple[str, Tensor]]:
    """Returns ordered (name, (N, k)) observation entries for one component."""
    out = []
    name = comp["name"]
    n = qp.pos.shape[0]
    body_idx = comp["body_idx"]  # list of global body indices
    root = comp["root_idx"]
    for obs_name in comp["observers"]:
        if obs_name == "root_z_joints":
            angles, vels = _component_joints(env, comp, qp)
            out.append((f"{name}_root_z", qp.pos[:, root, 2:]))
            out.append((f"{name}_root_rot", qp.rot[:, root]))
            out.append((f"{name}_root_vel", qp.vel[:, root]))
            out.append((f"{name}_root_ang", qp.ang[:, root]))
            out.append((f"{name}_joint_angles", angles))
            out.append((f"{name}_joint_vels", vels))
        elif obs_name == "cfrc":
            cfrc = torch.cat(
                [
                    torch.clamp(info.contact.vel[:, body_idx], -1, 1).reshape(n, -1),
                    torch.clamp(info.contact.ang[:, body_idx], -1, 1).reshape(n, -1),
                ],
                dim=-1,
            )
            out.append((f"{name}_cfrc", cfrc))
        elif obs_name == "qp":
            out.append((f"{name}_qp_pos", qp.pos[:, body_idx].reshape(n, -1)))
            out.append((f"{name}_qp_rot", qp.rot[:, body_idx].reshape(n, -1)))
            out.append((f"{name}_qp_vel", qp.vel[:, body_idx].reshape(n, -1)))
            out.append((f"{name}_qp_ang", qp.ang[:, body_idx].reshape(n, -1)))
        else:
            raise ValueError(f"unknown observer {obs_name!r}")
    return out


def edge_obs(env, comp_a: dict, comp_b: dict, desc: dict, qp: QP):
    """Edge observer entry (ma_descs extra_observers: root_vec)."""
    kind = desc.get("observer_type", "root_vec")
    if kind == "root_vec":
        idx = list(desc.get("indices", (0, 1)))
        vec = (qp.pos[:, comp_a["root_idx"]] - qp.pos[:, comp_b["root_idx"]])[:, idx]
        return (f"{comp_a['name']}__{comp_b['name']}_root_vec", vec)
    raise ValueError(f"unknown edge observer {kind!r}")


def _component_joints(env, comp: dict, qp: QP):
    """Joint angles/velocities restricted to this component's joints.  The
    indices count a sphericalized joint's padded dofs, which the angles
    leave out; an index past the end reads the last column, as the JAX
    package's gather clamps it."""
    sel = comp["joint_dof_idx"]
    if not sel:
        empty = qp.pos.new_zeros((qp.pos.shape[0], 0))
        return empty, empty
    angles, vels = env.sys.joint_angle_vel(qp)
    sel = [min(i, angles.shape[-1] - 1) for i in sel]
    return angles[:, sel], vels[:, sel]
