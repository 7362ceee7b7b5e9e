"""Narrowphase geometry, batch-first.

Counterpart of `brax_tpu/sim/geometry.py`, limited to what the capsule-plane,
box-plane and capsule-capsule colliders need: the contact point, normal and
penetration of capsule cap spheres against an infinite plane, a unit box's
corners, and the closest points of two segments.  Triangle and clipping
routines arrive with the colliders that use them.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from brax_torch import maths
from brax_torch.maths import dot1, vdot
from brax_torch.sim.types import Tensor

# the corners of a unit box, in the JAX package's order:
# itertools.product((-1, 1), (-1, 1), (-1, 1))
BOX_CORNERS = np.array(list(itertools.product((-1, 1), (-1, 1), (-1, 1))), dtype=np.float64)


def cap_ends_plane(pos_a: Tensor, rot_a: Tensor, end: Tensor, radius: Tensor,
                   pos_b: Tensor, rot_b: Tensor):
    """Cap spheres of body a against the +z plane of body b.

    pos_a/pos_b (..., np, 3) and rot_a/rot_b (..., np, 4) are the pair bodies'
    states, end (np, ne, 3) the body-local cap centers and radius (np,).
    Returns the contact points (..., np, ne, 3), the plane normal (..., np, 1, 3)
    and the penetration depths (..., np, ne).
    """
    cap_end_world = pos_a[..., None, :] + maths.rotate(end, rot_a[..., None, :])
    z = torch.zeros_like(pos_b)
    z[..., 2] = 1.0
    normal = maths.rotate(z, rot_b)[..., None, :]
    pos = cap_end_world - normal * radius[:, None, None]
    penetration = vdot(pos_b[..., None, :] - pos, normal)
    return pos, normal, penetration


def closest_segment_point(a: Tensor, b: Tensor, pt: Tensor) -> Tensor:
    """Closest point on segment a-b to point pt."""
    ab = b - a
    t = dot1(pt - a, ab) / (dot1(ab, ab) + 1e-6)
    return a + torch.clamp(t, 0.0, 1.0) * ab


def closest_segment_point_and_dist(a: Tensor, b: Tensor, pt: Tensor):
    """Closest point on segment a-b to pt, and its squared distance."""
    p = closest_segment_point(a, b, pt)
    v = pt - p
    return p, vdot(v, v)


def closest_segment_to_segment_points(a0: Tensor, a1: Tensor, b0: Tensor, b1: Tensor):
    """Closest points between segments a0-a1 and b0-b1, (..., 3) each.

    The closest points of the two infinite lines, each clipped to its
    segment; then whichever segment end point projection is nearer replaces
    one of them (d1 < d2 picks the point on a).  A zero-length segment gets
    a length of 1e-6, so parallel and degenerate segments stay finite.
    """
    def direction(p0, p1):
        d = p1 - p0
        length = maths.safe_norm(d)[..., None]
        length = length + 1e-6 * (length == 0.0)
        return d / length, length

    dir_a, len_a = direction(a0, a1)
    dir_b, len_b = direction(b0, b1)
    half_a, half_b = len_a * 0.5, len_b * 0.5
    a_mid = a0 + dir_a * half_a
    b_mid = b0 + dir_b * half_b
    trans = a_mid - b_mid

    dab = dot1(dir_a, dir_b)
    dat = dot1(dir_a, trans)
    dbt = dot1(dir_b, trans)
    denom = 1 - dab * dab
    t_a = (-dat + dab * dbt) / (denom + 1e-6)
    t_b = dbt + t_a * dab
    t_a = torch.minimum(torch.maximum(t_a, -half_a), half_a)
    t_b = torch.minimum(torch.maximum(t_b, -half_b), half_b)
    best_a = a_mid + dir_a * t_a
    best_b = b_mid + dir_b * t_b

    new_a, d1 = closest_segment_point_and_dist(a0, a1, best_b)
    new_b, d2 = closest_segment_point_and_dist(b0, b1, best_a)
    lt = (d1 < d2)[..., None]
    return torch.where(lt, new_a, best_a), torch.where(lt, best_b, new_b)
