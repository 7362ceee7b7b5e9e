"""Constraint rows and the non-negative least-squares contact solve.

Counterpart of `brax_tpu/v2/generalized/constraint.py`: 4 pyramid rows per
contact point and one row per joint limit, MuJoCo's default impedance, and
`min 0.5 |A x + b|^2, x >= 0` by fixed-iteration FISTA with a backtracking
line search of at most `maxls` halvings, all evaluated at once.  The
generalized kernel's plain version (`kernels.py::gen_step_plain`) calls
`imp_aref` as it is; it runs its own FISTA, which sums in the kernel's
order where this one takes batched products, as the JAX pipeline does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from brax_torch import maths
from brax_torch.v2 import masks
from brax_torch.v2.base import System, Tensor
from brax_torch.v2.generalized.base import State


def pt_jac(sys: System, com: Tensor, cdof_ang: Tensor, cdof_vel: Tensor, pos: Tensor,
           link_idx: int) -> Tensor:
    """(N, nd, 3) translational jacobian at world pos (N, 3) of link
    link_idx's ancestor-chain dofs (zero for the world, link_idx -1)."""
    if link_idx < 0:
        return torch.zeros_like(cdof_vel)
    mask = torch.as_tensor(masks.ancestor_dofs(sys)[link_idx], dtype=com.dtype,
                           device=com.device)[:, None]
    ang, vel = cdof_ang * mask, cdof_vel * mask
    return vel - maths.cross((pos - com)[:, None], ang)


def imp_aref(pos: Tensor, vel: Tensor) -> Tuple[Tensor, Tensor]:
    """Impedance and reference acceleration, MuJoCo's default solref/solimp
    (timeconst 0.02, dampratio 1, dmin/dmax 0.9/0.95, width 0.001, mid 0.5,
    power 2)."""
    timeconst, dampratio = 0.02, 1.0
    dmin, dmax, width, mid, power = 0.9, 0.95, 0.001, 0.5, 2.0
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which rounds otherwise than the CUDA kernel's division
    imp_x = torch.abs(pos) / pos.new_tensor(width)
    imp_a = (1.0 / mid ** (power - 1)) * imp_x ** power
    imp_b = 1 - (1.0 / (1 - mid) ** (power - 1)) * (1 - imp_x) ** power
    imp_y = torch.where(imp_x < mid, imp_a, imp_b)
    imp = dmin + imp_y * (dmax - dmin)
    imp = torch.clamp(imp, dmin, dmax)
    imp = torch.where(imp_x > 1.0, torch.full_like(imp, dmax), imp)
    b = 2 / (dmax * timeconst)
    k = 1 / (dmax * dmax * timeconst * timeconst * dampratio * dampratio)
    return imp, -b * vel - k * imp * pos


def jac_limit(sys: System, state: State):
    """Joint-limit rows: (N, nlim, nd) jacobian, (N, nlim) pos and diag."""
    n, nd = state.q.shape[0], sys.qd_size()
    if sys.dof.limit is None:
        z = state.q.new_zeros((n, 0))
        return state.q.new_zeros((n, 0, nd)), z, z
    q_idx, qd_idx = sys.q_idx("123"), sys.qd_idx("123")
    lo, hi = sys.dof.limit
    q = state.q[:, q_idx]
    pos_min = q - lo[qd_idx]
    pos_max = hi[qd_idx] - q
    pos = torch.clamp(torch.minimum(pos_min, pos_max), max=0.0)
    side = ((pos_min < pos_max).to(q.dtype) * 2 - 1) * (pos < 0)
    eye = torch.eye(nd, dtype=q.dtype, device=q.device)[qd_idx]
    return eye * side[..., None], pos, sys.dof.invweight[qd_idx] * (pos < 0)


def jac_contact(sys: System, state: State):
    """Contact rows, 4 pyramid directions per contact: (N, 4 nc, nd)
    jacobian, (N, 4 nc) pos and diag, zero where a contact is apart."""
    c = state.contact
    n, nd = state.q.shape[0], sys.qd_size()
    if c is None:
        z = state.q.new_zeros((n, 0))
        return state.q.new_zeros((n, 0, nd)), z, z
    jacs, poss, diags = [], [], []
    iw = sys.link.invweight
    for k in range(c.pos.shape[1]):
        link_a, link_b = int(c.link_idx[0][0, k]), int(c.link_idx[1][0, k])
        pos = c.pos[:, k]
        a = pt_jac(sys, state.com, state.cdof.ang, state.cdof.vel, pos, link_a)
        b = pt_jac(sys, state.com, state.cdof.ang, state.cdof.vel, pos, link_b)
        diff = b - a
        normal, fric, pen = c.normal[:, k], c.friction[:, k], c.penetration[:, k]
        rows = []
        for d in maths.orthogonals(normal):
            for f in (-fric, fric):
                rows.append((diff @ (d * f[:, None] - normal)[..., None])[..., 0])
        t = iw[link_a] + (iw[link_b] if link_b > -1 else 0.0)
        diag = 2 * fric * fric * (t + fric * fric * t)
        active = (pen > 0).to(pos.dtype)
        jacs.append(torch.stack(rows, dim=1) * active[:, None, None])
        poss.append((-pen * active)[:, None].expand(n, 4))
        diags.append((diag * active)[:, None].expand(n, 4))
    return torch.cat(jacs, dim=1), torch.cat(poss, dim=1), torch.cat(diags, dim=1)


def jacobian(sys: System, state: State) -> State:
    """Stacks the contact and limit rows into the state."""
    (jc, pc, dc), (jl, pl, dl) = jac_contact(sys, state), jac_limit(sys, state)
    return state.replace(con_jac=torch.cat([jc, jl], dim=1), con_pos=torch.cat([pc, pl], dim=1),
                         con_diag=torch.cat([dc, dl], dim=1))


def fista_nnls(a: Tensor, b: Tensor, maxiter: int, maxls: int = 5) -> Tensor:
    """min 0.5 |a x + b|^2 s.t. x >= 0 for a (N, r, r), b (N, r).

    Each iteration projects a gradient step from the momentum point onto
    x >= 0, taking the first of maxls halvings of the step whose quadratic
    bound holds (if none does, the first candidate, with the step halved
    once more); then the step may grow by 1.5."""
    a_t = a.transpose(-1, -2)
    halvings = 0.5 ** torch.arange(maxls, dtype=a.dtype, device=a.device)
    x = torch.zeros_like(b)
    y = x
    t = torch.ones_like(b[:, 0])
    eta = 1.0 / (torch.abs(a).sum(dim=2).amax(dim=1) + 1e-10)
    rows = torch.arange(b.shape[0], device=b.device)
    for _ in range(maxiter):
        r = (a @ y[..., None])[..., 0] + b
        f_y = 0.5 * torch.sum(r * r, dim=-1)
        g_y = (a_t @ r[..., None])[..., 0]
        etas = eta[:, None] * halvings
        cands = torch.clamp(y[:, None] - etas[..., None] * g_y[:, None], min=0.0)
        diffs = cands - y[:, None]
        f_cands = 0.5 * torch.sum((cands @ a_t + b[:, None]) ** 2, dim=-1)
        bounds = (f_y[:, None] + (diffs @ g_y[..., None])[..., 0]
                  + 0.5 / etas * torch.sum(diffs * diffs, dim=-1))
        ok = f_cands <= bounds + 1e-12
        any_ok = ok.any(dim=1)
        k = torch.where(any_ok, torch.argmax(ok.to(torch.int8), dim=1), torch.zeros_like(rows))
        eta_next = torch.where(any_ok, etas[rows, k], etas[:, -1] * 0.5)
        x_next = cands[rows, k]
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = x_next + ((t - 1.0) / t_next)[:, None] * (x_next - x)
        x, t, eta = x_next, t_next, eta_next * 1.5
    return x


def force(sys: System, state: State) -> Tensor:
    """Constraint force in joint coordinates (N, nd)."""
    jac = state.con_jac
    if jac is None or jac.shape[1] == 0:
        return torch.zeros_like(state.qd)
    imp, aref = imp_aref(state.con_pos, (jac @ state.qd[..., None])[..., 0])
    jm = jac @ state.mass_mx_inv
    a = jm @ jac.transpose(-1, -2)
    a = a + torch.diag_embed(state.con_diag * (1 - imp) / imp)
    b = (jm @ state.qf_smooth[..., None])[..., 0] - aref
    x = fista_nnls(a, b, maxiter=sys.solver_iterations)
    return (jac.transpose(-1, -2) @ x[..., None])[..., 0]
