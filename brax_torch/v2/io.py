"""Serialization + HTML viewer for v2 systems and trajectories.

Counterpart of `brax_tpu/v2/io.py` (`dumps`, `save_html`) on the port's
`v2/base` System and State.  It emits the viewer JSON schema of
`brax_torch.io.json` (bodies with colliders + pos/rot frames), so the
viewer (`brax_torch/viewer/viewer.js`) renders v2 scenes unchanged; the
page template is `brax_torch.io.html`'s.  Each State is one env's: its
`x.pos` (links, 3) or (1, links, 3).  The port's v2 geometries are spheres,
capsules and planes (boxes and meshes wait on ROADMAP queue A item 7).
"""

from __future__ import annotations

import json
from typing import List

import numpy as onp
import torch

from brax_torch.io import file as io_file
from brax_torch.io import html
from brax_torch.v2.base import Capsule, Plane, Sphere, State, System


def _np(x: torch.Tensor) -> onp.ndarray:
    return x.detach().cpu().numpy()


def _geom_dict(g) -> dict:
    pos = _np(g.transform.pos).tolist()
    rot = _quat_to_euler_deg(_np(g.transform.rot))
    d: dict = {"position": pos, "rotation": rot}
    if isinstance(g, Capsule):
        d["capsule"] = {"radius": float(g.radius),
                        "length": float(g.length) + 2 * float(g.radius)}
    elif isinstance(g, Sphere):
        d["sphere"] = {"radius": float(g.radius)}
    elif isinstance(g, Plane):
        d["plane"] = {}
    else:
        raise NotImplementedError(f"{type(g).__name__} geometries are not ported to brax_torch.v2")
    return d


def _quat_to_euler_deg(q) -> List[float]:
    """wxyz quaternion -> intrinsic xyz euler degrees (viewer convention)."""
    w, x, y, z = q
    ex = onp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    ey = onp.arcsin(onp.clip(2 * (w * y - z * x), -1, 1))
    ez = onp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return [float(onp.degrees(v)) for v in (ex, ey, ez)]


def dumps(sys: System, states: List[State]) -> str:
    """Serializes a v2 System + one env's state trajectory to viewer JSON."""
    n = sys.num_links()
    bodies = []
    for li in range(n):
        colliders = [_geom_dict(g) for g in sys.geoms
                     if g.link_idx is not None and int(g.link_idx) == li]
        bodies.append({"name": sys.link_names[li], "colliders": colliders})
    # one extra world "body" carrying static geoms (floor planes etc.)
    world_colliders = [_geom_dict(g) for g in sys.geoms if g.link_idx is None]
    if world_colliders:
        bodies.append({"name": "world", "colliders": world_colliders})

    pos = [_np(s.x.pos).reshape(-1, 3) for s in states]
    rot = [_np(s.x.rot).reshape(-1, 4) for s in states]
    if world_colliders:
        zero = onp.zeros((len(pos[0]) + 1, 3))
        ident = onp.tile(onp.array([1.0, 0, 0, 0]), (len(rot[0]) + 1, 1))
        pos = [onp.concatenate([p, zero[-1:]]) for p in pos]
        rot = [onp.concatenate([r, ident[-1:]]) for r in rot]

    d = {
        "config": {
            "bodies": bodies,
            "meshGeometries": {},
            "dt": float(sys.dt),
        },
        "pos": [p.tolist() for p in pos],
        "rot": [r.tolist() for r in rot],
        "debug": False,
    }
    return json.dumps(d)


def render_html(sys: System, states: List[State]) -> str:
    """Standalone HTML page visualizing one env's v2 trajectory."""
    return html.page(dumps(sys, states))


def save_html(path: str, sys: System, states: List[State]):
    with io_file.File(path, "w") as fout:
        fout.write(render_html(sys, states))
