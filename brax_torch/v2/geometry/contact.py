"""Narrowphase contacts, batch-first.

Counterpart of `brax_tpu/v2/geometry/contact.py` for the pairs the ported
envs use: sphere-plane and capsule-plane with a static plane.  A capsule
gives two contacts, one per end sphere (+end, then -end), interleaved per
capsule as the JAX package orders them.

Each contact point is fixed in its link's frame, so `points(sys)` folds the
scene's constants once (in float64, rounded to float32, as the JAX kernel's
plan folds them) and `penetrations` places the points at the links' world
transforms.  The generalized kernel's plain version runs `penetrations` as
it is.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from brax_torch.v2 import ordered
from brax_torch.v2.base import Capsule, Contact, Plane, Sphere, System, Tensor, Transform


def np_rotate(v, q) -> np.ndarray:
    """Quaternion rotation of a constant in float64, rounded to float32."""
    v = np.asarray(v, np.float64)
    w, x, y, z = np.asarray(q, np.float64)
    u = np.array([x, y, z])
    return np.asarray(v * (w * w - u @ u) + 2.0 * u * (u @ v) + 2.0 * w * np.cross(u, v),
                      np.float32)


class Points(NamedTuple):
    """A scene's contact points: per point, its link, its centre in the
    link's frame, the sphere radius, the pair's friction and elasticity, and
    the plane's world normal and position (float32 numpy, leading axis nc)."""

    link: List[int]
    lpos: np.ndarray
    radius: np.ndarray
    friction: np.ndarray
    elasticity: np.ndarray
    normal: np.ndarray
    plane_pos: np.ndarray


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy(), np.float32)


def points(sys: System) -> Points:
    """The contact points of `sys`, folded once per System."""
    cached = sys.__dict__.get("_contact_points")
    if cached is not None:
        return cached
    link, lpos, radius, friction, elasticity, normal, plane_pos = ([] for _ in range(7))
    for ga, gb in sys.contacts or ():
        if isinstance(gb, (Sphere, Capsule)) and isinstance(ga, Plane):
            ga, gb = gb, ga
        if not (isinstance(ga, (Sphere, Capsule)) and isinstance(gb, Plane)):
            raise NotImplementedError(
                f"{type(ga).__name__}-{type(gb).__name__} contacts are not ported yet; "
                "brax_torch.v2 has sphere-plane and capsule-plane (see ROADMAP.md, queue A "
                "item 7)")
        if gb.link_idx is not None:
            raise NotImplementedError("contacts with a plane on a link are not ported yet")
        s_pos, s_rot, s_rad = _np(ga.transform.pos), _np(ga.transform.rot), _np(ga.radius)
        p_pos, p_rot = _np(gb.transform.pos), _np(gb.transform.rot)
        fric = np.maximum(_np(ga.friction), _np(gb.friction))
        elast = np.maximum(_np(ga.elasticity), _np(gb.elasticity))
        ends = [None] if isinstance(ga, Sphere) else [0.5, -0.5]
        for k in range(s_pos.shape[0]):
            for sign in ends:
                centre = s_pos[k]
                if sign is not None:
                    seg = np_rotate([0.0, 0.0, float(_np(ga.length)[k])], s_rot[k])
                    centre = centre + np.float32(sign) * seg
                w, x, y, z = p_rot[k]
                link.append(int(ga.link_idx[k]))
                lpos.append(np.asarray(centre, np.float32))
                radius.append(s_rad[k])
                friction.append(fric[k])
                elasticity.append(elast[k])
                normal.append(np.array([2 * (x * z + w * y), 2 * (y * z - w * x),
                                        w * w - x * x - y * y + z * z], np.float32))
                plane_pos.append(p_pos[k])
    arr = lambda v, shape: np.asarray(v, np.float32).reshape(shape)
    nc = len(link)
    cached = Points(link, arr(lpos, (nc, 3)), arr(radius, (nc,)), arr(friction, (nc,)),
                    arr(elasticity, (nc,)), arr(normal, (nc, 3)), arr(plane_pos, (nc, 3)))
    sys.__dict__["_contact_points"] = cached
    return cached


def penetrations(pts: Points, x_pos: Sequence[Tensor],
                 x_rot: Sequence[Tensor]) -> Tuple[List[Tensor], List[Tensor]]:
    """Contact positions (N, 3) and penetrations (N,) of every point, given
    each link's world position and rotation."""
    cpos, cpen = [], []
    for c, l in enumerate(pts.link):
        ref = x_pos[l]
        n = torch.as_tensor(pts.normal[c], device=ref.device)
        lpos = torch.as_tensor(pts.lpos[c], device=ref.device)
        spos = ref + ordered.rotate(lpos.expand_as(ref), x_rot[l])
        pen = float(pts.radius[c]) - ordered.dot3(
            spos - torch.as_tensor(pts.plane_pos[c], device=ref.device), n)
        cpos.append(spos - n * (float(pts.radius[c]) - 0.5 * pen)[:, None])
        cpen.append(pen)
    return cpos, cpen


def contact(sys: System, x: Transform) -> Optional[Contact]:
    """All contacts of the scene, (N, nc, ...), at the links' world
    transforms x (N, nl, ...); None without contact pairs."""
    pts = points(sys)
    if not pts.link:
        return None
    cpos, cpen = penetrations(pts, x.pos.unbind(1), x.rot.unbind(1))
    n, device = x.pos.shape[0], x.pos.device
    per_point = lambda v: torch.as_tensor(v, device=device).expand((n,) + v.shape)
    link = torch.as_tensor(pts.link, device=device)
    return Contact(pos=torch.stack(cpos, dim=1), normal=per_point(pts.normal),
                   penetration=torch.stack(cpen, dim=1), friction=per_point(pts.friction),
                   elasticity=per_point(pts.elasticity),
                   link_idx=(link.expand(n, -1), torch.full_like(link, -1).expand(n, -1)))
