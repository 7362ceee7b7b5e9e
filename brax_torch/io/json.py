"""Scene + trajectory serialization for the web viewer.

Counterpart of `brax_tpu/io/json.py`, with the same schema over the port's
own `Config` (`brax_torch/sim/config.py`): the scene description (body
colliders), the trajectory (pos/rot per frame) and optionally padded
contact-point debug overlays.  Each QP (and Info) is one env's: (bodies, 3)
and (bodies, 4) tensors.  For the same values the string is the JAX
package's, so `brax_torch/viewer/viewer.js` (a copy of the JAX viewer)
plays port trajectories unchanged.
"""

import dataclasses
import json
from typing import Any, List, Optional

import numpy as onp
import torch

from brax_torch.io import file
from brax_torch.sim.config import Config
from brax_torch.sim.types import Info, QP


def _np(x) -> onp.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


class _Encoder(json.JSONEncoder):
    def default(self, obj):
        if hasattr(obj, "tolist"):
            return obj.tolist()
        if dataclasses.is_dataclass(obj):
            return dataclasses.asdict(obj)
        return json.JSONEncoder.default(self, obj)


def _collider_dict(c) -> dict:
    d: dict = {"position": list(c.position), "rotation": list(c.rotation)}
    if c.capsule is not None:
        d["capsule"] = {"radius": c.capsule.radius, "length": c.capsule.length}
    elif c.sphere is not None:
        d["sphere"] = {"radius": c.sphere.radius}
    elif c.box is not None:
        d["box"] = {"halfsize": list(c.box.halfsize)}
    elif c.plane is not None:
        d["plane"] = {}
    elif c.clipped_plane is not None:
        d["clippedPlane"] = {
            "halfsizeX": c.clipped_plane.halfsize_x,
            "halfsizeY": c.clipped_plane.halfsize_y,
        }
    elif c.heightmap is not None:
        d["heightMap"] = {"size": c.heightmap.size, "data": list(c.heightmap.data)}
    elif c.mesh is not None:
        d["mesh"] = {"name": c.mesh.name, "scale": c.mesh.scale}
    if c.color:
        d["color"] = c.color
    if c.hidden:
        d["hidden"] = True
    return d


def dumps(config: Config, qps: List[QP], info: Optional[List[Info]] = None) -> str:
    """Serializes a scene config and one env's QP trajectory to JSON."""
    meshes = {
        m.name: {"vertices": [list(v) for v in m.vertices], "faces": list(m.faces)}
        for m in getattr(config, "mesh_geometries", [])
    }
    d: Any = {
        "config": {
            "bodies": [
                {
                    "name": b.name,
                    "colliders": [_collider_dict(c) for c in b.colliders],
                }
                for b in config.bodies
            ],
            "meshGeometries": meshes,
            "dt": config.dt,
        },
        "pos": [_np(qp.pos) for qp in qps],
        "rot": [_np(qp.rot) for qp in qps],
        "debug": info is not None,
    }
    if info:
        # pad per-frame active contacts to a fixed length for the overlay
        pens = [_np(i.contact_penetration) for i in info]
        max_len = max(int(onp.sum(p > 0)) for p in pens) if pens else 0

        def pad(arr, n):
            arr = onp.asarray(arr)
            shape = (n - arr.shape[0],) + arr.shape[1:]
            return onp.concatenate([arr, -onp.ones(shape)]) if shape[0] else arr

        d["contact_pos"] = [
            pad(_np(i.contact_pos)[p > 0], max_len) for i, p in zip(info, pens)
        ]
        d["contact_normal"] = [
            pad(_np(i.contact_normal)[p > 0], max_len) for i, p in zip(info, pens)
        ]
        d["contact_penetration"] = [pad(p[p > 0], max_len) for p in pens]
    return json.dumps(d, cls=_Encoder)


def save(path: str, config: Config, qps: List[QP], info: Optional[List[Info]] = None):
    """Saves a scene + trajectory as JSON."""
    with file.File(path, "w") as fout:
        fout.write(dumps(config, qps, info))
