"""Small algebra on batch-first tensors whose sums run left to right.

`brax_torch/csrc/gen_step.cu` sums every dot product and reduction in index
order.  The v2 modules that its plain version shares (kinematics, contact,
integrator) compute with these helpers, so that the plain version rounds as
the kernel does.
"""

from __future__ import annotations

from typing import Sequence

import torch

from brax_torch import maths

Tensor = torch.Tensor


def add(terms: Sequence[Tensor]) -> Tensor:
    """terms[0] + terms[1] + ..., from the left."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def dot3(a: Tensor, b: Tensor) -> Tensor:
    """Dot product of (..., 3) vectors, no keepdim."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sumsq(a: Tensor) -> Tensor:
    """Sum of squares over the last axis."""
    return add([a[..., i] * a[..., i] for i in range(a.shape[-1])])


def rowdot(a: Tensor, x: Tensor) -> Tensor:
    """The rows of a (N, r, k) dotted with x (N, k): (N, r)."""
    return add([a[:, :, k] * x[:, None, k] for k in range(a.shape[2])])


def rotate(v: Tensor, q: Tensor) -> Tensor:
    """v (..., 3) rotated by the unit quaternion q (..., 4):
    2 (u.v) u + (s^2 - u.u) v + 2 s (u x v)."""
    s, u = q[..., 0:1], q[..., 1:4]
    uv = dot3(u, v)[..., None]
    uu = dot3(u, u)[..., None]
    return 2 * (uv * u) + (s * s - uu) * v + 2 * s * maths.cross(u, v)


def normalize(x: Tensor) -> Tensor:
    """maths.normalize_with_norm's x / |x|: unit inputs pass unchanged."""
    is_zero = torch.all(torch.abs(x) <= 1e-8, dim=-1, keepdim=True)
    n = torch.sqrt(sumsq(torch.where(is_zero, torch.ones_like(x), x)))[..., None]
    n = torch.where(is_zero, torch.zeros_like(n), n)
    return x / (n + 1e-6 * (n == 0.0))
