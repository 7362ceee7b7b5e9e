"""Batched quaternion / rotation algebra on torch tensors.

Counterpart of `brax_tpu/maths.py`.  Every function broadcasts over leading
batch axes: a vector is `(..., 3)`, a quaternion `(..., 4)` in (w, x, y, z)
order.  `arctan2` is the minimax-polynomial form that both JAX physics paths
reach (`brax_tpu/maths.py:119-150`, `brax_tpu/sim/kernels.py:126-150`), not
`torch.atan2`, so the port's twin and its CUDA kernel round like the kernel
they replace.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def vdot(a: Tensor, b: Tensor) -> Tensor:
    """Dot product over the last axis (no keepdim)."""
    return torch.sum(a * b, dim=-1)


def dot1(a: Tensor, b: Tensor) -> Tensor:
    """Dot product over the last axis, keepdim for broadcasting."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis, with broadcasting."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def safe_norm(x: Tensor, dim: int = -1) -> Tensor:
    """norm(x), exactly 0 where every component of the row is <= 1e-8."""
    is_zero = torch.all(torch.abs(x) <= 1e-8, dim=dim, keepdim=True)
    xsafe = torch.where(is_zero, torch.ones_like(x), x)
    n = torch.sqrt(torch.sum(xsafe * xsafe, dim=dim))
    return torch.where(is_zero.squeeze(dim), torch.zeros_like(n), n)


def jnp_abs(x: Tensor) -> Tensor:
    """|x| with jnp.abs's gradient: 1 at x == 0, where torch.abs's is 0.
    The same values (0 keeps its sign)."""
    return torch.where(x >= 0, x, -x)


class _SafeArccos(torch.autograd.Function):
    """arccos whose gradient clips its input to (-1, 1)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.acos(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        xc = torch.clamp(x, -1 + 1e-7, 1 - 1e-7)
        return -grad / torch.sqrt(1.0 - xc * xc)


def safe_arccos(x: Tensor) -> Tensor:
    return _SafeArccos.apply(x)


def rotate(vec: Tensor, quat: Tensor) -> Tensor:
    """Rotates vec (..., 3) by the unit quaternion quat (..., 4)."""
    s = quat[..., 0:1]
    u = quat[..., 1:]
    r = 2 * (dot1(u, vec) * u) + (s * s - dot1(u, u)) * vec
    return r + 2 * s * cross(u, vec)


def inv_rotate(vec: Tensor, quat: Tensor) -> Tensor:
    """Rotates vec by quat^-1."""
    return rotate(vec, quat_inv(quat))


def ang_to_quat(ang: Tensor) -> Tensor:
    """Angular velocity (..., 3) -> quaternion with zero w."""
    return torch.cat([torch.zeros_like(ang[..., :1]), ang], dim=-1)


def euler_to_quat(v: Tensor) -> Tensor:
    """Euler degrees (intrinsic x-y'-z'') -> quaternion."""
    c = torch.cos(v * math.pi / 360)
    s = torch.sin(v * math.pi / 360)
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    w = c1 * c2 * c3 - s1 * s2 * s3
    x = s1 * c2 * c3 + c1 * s2 * s3
    y = c1 * s2 * c3 - s1 * c2 * s3
    z = c1 * c2 * s3 + s1 * s2 * c3
    return torch.stack([w, x, y, z], dim=-1)


# odd minimax polynomial for arctan on [-1, 1] (|err| ~ 1e-7), highest
# coefficient first; the same numbers as brax_tpu/maths.py:125-127
_ARCTAN_COEFFS = (
    -0.0040540580, 0.0218612288, -0.0559098861, 0.0964200441,
    -0.1390853351, 0.1994653599, -0.3332985605, 0.9999993329,
)


def _arctan_poly(t: Tensor) -> Tensor:
    """arctan(t); |t| > 1 reduces with atan(t) = sign(t) pi/2 - atan(1/t).
    1/t is taken only where |t| > 1: elsewhere a tiny t would make the
    unused branch's gradient 0 x inf, NaN."""
    big = torch.abs(t) > 1.0
    tt = torch.where(big, 1.0 / torch.where(big, t, torch.ones_like(t)), t)
    z = tt * tt
    p = torch.full_like(t, _ARCTAN_COEFFS[0])
    for c in _ARCTAN_COEFFS[1:]:
        p = p * z + c
    r = tt * p
    return torch.where(big, torch.sign(t) * (math.pi / 2) - r, r)


def arctan2(y: Tensor, x: Tensor) -> Tensor:
    """atan2 with the quadrant rebuilt around `_arctan_poly`."""
    safe_x = torch.where(x == 0, torch.ones_like(x), x)
    base = _arctan_poly(y / safe_x)
    pi = math.pi
    zero = torch.zeros_like(base)
    out = base
    out = torch.where((x < 0) & (y >= 0), base + pi, out)
    out = torch.where((x < 0) & (y < 0), base - pi, out)
    out = torch.where((x == 0) & (y > 0), zero + pi / 2, out)
    out = torch.where((x == 0) & (y < 0), zero - pi / 2, out)
    out = torch.where((x == 0) & (y == 0), zero, out)
    return out


def quat_to_euler(q: Tensor) -> Tensor:
    """Quaternion -> intrinsic x-y'-z'' Euler angles in radians, (..., 3).

    As the JAX package's outside its kernels: torch.atan2 and torch.asin of
    the clipped sine (an observation's maths, not differentiated)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ez = torch.atan2(-2 * x * y + 2 * w * z, x * x + w * w - z * z - y * y)
    ey = torch.asin(torch.clamp(2 * x * z + 2 * w * y, -1.0, 1.0))
    ex = torch.atan2(-2 * y * z + 2 * w * x, z * z - y * y - x * x + w * w)
    return torch.stack([ex, ey, ez], dim=-1)


def signed_angle(axis: Tensor, ref_p: Tensor, ref_c: Tensor) -> Tensor:
    """Signed angle between two vectors around an axis."""
    return arctan2(vdot(cross(ref_p, ref_c), axis), vdot(ref_p, ref_c))


def quat_mul(u: Tensor, v: Tensor) -> Tensor:
    """Quaternion product u * v."""
    u0, u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    v0, v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return torch.stack(
        [
            u0 * v0 - u1 * v1 - u2 * v2 - u3 * v3,
            u0 * v1 + u1 * v0 + u2 * v3 - u3 * v2,
            u0 * v2 - u1 * v3 + u2 * v0 + u3 * v1,
            u0 * v3 + u1 * v2 - u2 * v1 + u3 * v0,
        ],
        dim=-1,
    )


def vec_quat_mul(u: Tensor, v: Tensor) -> Tensor:
    """(0, u) * v quaternion product for a 3-vector u."""
    u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
    v0, v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return torch.stack(
        [
            -u0 * v1 - u1 * v2 - u2 * v3,
            u0 * v0 + u1 * v3 - u2 * v2,
            -u0 * v3 + u1 * v0 + u2 * v1,
            u0 * v2 - u1 * v1 + u2 * v0,
        ],
        dim=-1,
    )


def quat_rot_axis(axis: Tensor, angle: Tensor) -> Tensor:
    """Quaternion rotating by angle (...) around axis (..., 3)."""
    s = torch.sin(angle / 2)[..., None]
    qw = torch.cos(angle / 2)[..., None]
    return torch.cat([qw, axis * s], dim=-1)


def quat_inv(q: Tensor) -> Tensor:
    """Inverse (conjugate) of a unit quaternion."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def relative_quat(q1: Tensor, q2: Tensor) -> Tensor:
    """Relative quaternion from q1 to q2."""
    return quat_mul(q2, quat_inv(q1))


def normalize(v: Tensor, epsilon: float = 1e-6) -> Tensor:
    """v / (epsilon + |v|)."""
    return v / (epsilon + safe_norm(v)[..., None])


def quat_to_3x3(q: Tensor) -> Tensor:
    """Quaternion -> rotation matrix (..., 3, 3)."""
    d = vdot(q, q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / d
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    rows = [
        torch.stack([1 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def normalize_with_norm(x: Tensor, dim: int = -1):
    """(x / |x|, |x|), zero-safe: the epsilon is added only where the norm
    is exactly zero, so unit vectors pass through bit-exact."""
    n = safe_norm(x, dim=dim)
    return x / (n + 1e-6 * (n == 0.0)).unsqueeze(dim), n


def orthogonals(n: Tensor):
    """Two orthogonal in-plane vectors for the plane normal n (..., 3)."""
    n_sqr = n[..., 2] * n[..., 2]
    a = n[..., 1] * n[..., 1] + torch.where(n_sqr > 0.5, n_sqr, n[..., 0] * n[..., 0])
    k = torch.sqrt(a)
    zero = torch.zeros_like(k)
    big = (a > 0.5)[..., None]
    p_gt = torch.stack([zero, -n[..., 2], n[..., 1]], dim=-1)
    p_lt = torch.stack([-n[..., 1], n[..., 0], n[..., 1]], dim=-1)
    p = torch.where(big, p_gt, p_lt) * k[..., None]
    q_gt = torch.stack([a * k, -n[..., 0] * p[..., 2], n[..., 0] * p[..., 1]], dim=-1)
    q_lt = torch.stack([-n[..., 2] * p[..., 1], n[..., 2] * p[..., 0], a * k], dim=-1)
    return p, torch.where(big, q_gt, q_lt)


def from_to(v1: Tensor, v2: Tensor) -> Tensor:
    """Quaternion rotating unit vector v1 onto unit vector v2."""
    w = 1.0 + vdot(v1, v2)[..., None]
    rot = torch.cat([w, cross(v1, v2)], dim=-1)
    # antiparallel fallback: rotate pi about any axis orthogonal to v1
    x, y = v1.new_tensor([1.0, 0.0, 0.0]), v1.new_tensor([0.0, 1.0, 0.0])
    near_x = (torch.abs(vdot(v1, x.expand_as(v1))) > 0.99)[..., None]
    rot_axis = torch.where(near_x, cross(v1, y.expand_as(v1)), cross(v1, x.expand_as(v1)))
    flip = quat_rot_axis(rot_axis, torch.full(v1.shape[:-1], math.pi, dtype=v1.dtype,
                                              device=v1.device))
    rot = torch.where(rot[..., 0:1] < 1e-6, flip, rot)
    return rot / torch.linalg.vector_norm(rot, dim=-1, keepdim=True)


NS_ITERS = 4


def inv_approximate(a: Tensor, a_inv: Tensor, tol: float = 1e-12,
                    maxiter: int = 10) -> Tensor:
    """Newton-Schulz inverse of the (..., n, n) matrices a, warm-started
    from a_inv; where the start's residual norm exceeds 1 it starts from the
    scaled transpose 0.5 a^T / tr(a a^T) instead.  Runs maxiter iterations,
    freezing each matrix once its step falls to tol."""
    a_t = a.transpose(-1, -2)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    r0 = torch.linalg.matrix_norm(eye - a @ a_inv)
    tr = torch.diagonal(a @ a_t, dim1=-2, dim2=-1).sum(-1)
    cur = torch.where((r0 > 1)[..., None, None], 0.5 * a_t / tr[..., None, None], a_inv)
    err = torch.ones_like(r0)
    for _ in range(maxiter):
        nxt = 2 * cur - cur @ a_t @ cur
        nxt_err = torch.linalg.matrix_norm(nxt - cur)
        live = err > tol
        cur = torch.where(live[..., None, None], nxt, cur)
        err = torch.where(live, nxt_err, err)
    return cur
