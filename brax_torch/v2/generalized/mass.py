"""Composite-rigid-body mass matrix and its inverse, batch-first.

Counterpart of `brax_tpu/v2/generalized/mass.py`.
"""

from __future__ import annotations

import torch

from brax_torch import maths
from brax_torch.maths import NS_ITERS
from brax_torch.v2 import masks
from brax_torch.v2.base import Inertia, System, Tensor, Transform
from brax_torch.v2.generalized.base import State

__all__ = ["matrix", "matrix_inv", "NS_ITERS"]


def matrix(sys: System, state: State) -> Tensor:
    """(N, nd, nd) joint-space mass matrix: M[i, j] = cdof_j . (crb[link(i)]
    * cdof_i) over ancestor pairs, lower triangle mirrored, plus armature."""
    sub = torch.as_tensor(masks.subtree_links(sys), dtype=state.q.dtype, device=state.q.device)
    cinr = state.cinr
    crb = Inertia(
        transform=Transform(pos=torch.einsum("lj,njc->nlc", sub, cinr.transform.pos),
                            rot=cinr.transform.rot),
        i=torch.einsum("lj,njab->nlab", sub, cinr.i),
        mass=cinr.mass @ sub.T,
    )
    dof_link = sys.dof_link()
    crb = Inertia(transform=Transform(pos=crb.transform.pos[:, dof_link], rot=None),
                  i=crb.i[:, dof_link], mass=crb.mass[:, dof_link])
    f = crb.mul(state.cdof)
    f6 = torch.cat([f.ang, f.vel], dim=-1)
    cdof6 = torch.cat([state.cdof.ang, state.cdof.vel], dim=-1)
    mx = f6 @ cdof6.transpose(-1, -2)
    mx = mx * torch.as_tensor(masks.dof_pairs(sys), dtype=mx.dtype, device=mx.device)
    mx = torch.tril(mx) + torch.tril(mx, -1).transpose(-1, -2)
    return mx + torch.diag(sys.dof.armature)


def matrix_inv(sys: System, state: State, approximate: bool = False) -> State:
    """Updates mass_mx and mass_mx_inv: the exact SPD inverse, or with
    approximate=True Newton-Schulz warm-started from the state's inverse."""
    mx = matrix(sys, state)
    if approximate:
        mx_inv = maths.inv_approximate(mx, state.mass_mx_inv, maxiter=NS_ITERS)
    else:
        eye = torch.eye(sys.qd_size(), dtype=mx.dtype, device=mx.device)
        mx_inv = torch.cholesky_solve(eye.expand_as(mx), torch.linalg.cholesky(mx))
    return state.replace(mass_mx=mx, mass_mx_inv=mx_inv)
