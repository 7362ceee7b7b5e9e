"""Narrowphase geometry, batch-first.

Counterpart of `brax_tpu/sim/geometry.py`, limited to what the capsule-plane
collider needs: the contact point, normal and penetration of capsule cap
spheres against an infinite plane.  Segment, triangle and clipping routines
arrive with the colliders that use them.
"""

from __future__ import annotations

import torch

from brax_torch import maths
from brax_torch.sim.types import Tensor


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
    penetration = maths.vdot(pos_b[..., None, :] - pos, normal)
    return pos, normal, penetration
