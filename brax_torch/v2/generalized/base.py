"""State of the generalized pipeline (`brax_tpu/v2/generalized/base.py`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from brax_torch.v2 import base
from brax_torch.v2.base import Inertia, Motion, System, Tensor, Transform


@dataclass
class State(base.State):
    """Generalized state, (N, ...): the base State plus the CoM-frame terms
    (com, cinr, cd, cdof, cdofd), the mass matrix and its inverse, the
    constraint rows (con_jac, con_pos, con_diag) and the joint forces."""

    com: Tensor
    cinr: Inertia
    cd: Motion
    cdof: Motion
    cdofd: Motion
    mass_mx: Tensor
    mass_mx_inv: Tensor
    con_jac: Optional[Tensor]
    con_pos: Optional[Tensor]
    con_diag: Optional[Tensor]
    qf_smooth: Tensor
    qf_constraint: Tensor
    qdd: Tensor

    @classmethod
    def zero(cls, sys: System, n: int) -> "State":
        nl, nd, dev = sys.num_links(), sys.qd_size(), sys.device
        z = lambda *s: torch.zeros((n,) + s, device=dev)
        eye = torch.eye(nd, device=dev).expand(n, nd, nd).clone()
        return State(
            q=z(sys.q_size()), qd=z(nd), x=Transform.zero((n, nl), dev),
            xd=Motion.zero((n, nl), dev), contact=None, com=z(3),
            cinr=Inertia(transform=Transform.zero((n, nl), dev), i=z(nl, 3, 3), mass=z(nl)),
            cd=Motion.zero((n, nl), dev), cdof=Motion.zero((n, nd), dev),
            cdofd=Motion.zero((n, nd), dev), mass_mx=eye, mass_mx_inv=eye.clone(),
            con_jac=None, con_pos=None, con_diag=None, qf_smooth=z(nd), qf_constraint=z(nd),
            qdd=z(nd),
        )
