"""Actuator controls to joint forces.

Counterpart of `brax_tpu/v2/actuator.py::to_tau`, for motor actuators.
"""

from __future__ import annotations

import torch

from brax_torch.v2.base import System, Tensor


def to_tau(sys: System, act: Tensor, q: Tensor) -> Tensor:
    """Controls act (N, na) -> generalized forces tau (N, nd): each motor
    applies gear * clip(ctrl, ctrl_range) to its dof."""
    n = act.shape[0]
    tau = act.new_zeros((n, sys.qd_size()))
    if sys.act_size() == 0:
        return tau
    if set(sys.actuator_types) != {"m"}:
        raise NotImplementedError(
            f"actuator types {sorted(set(sys.actuator_types) - {'m'})} are not ported yet; "
            "brax_torch.v2 has motors ('m') only (see ROADMAP.md, queue A item 7)")
    rng = sys.actuator.ctrl_range
    force = torch.minimum(torch.maximum(act, rng[:, 0]), rng[:, 1])
    idx = torch.as_tensor(sys.actuator_qdid, device=act.device)
    return tau.index_add(1, idx, sys.actuator.gear * force)
