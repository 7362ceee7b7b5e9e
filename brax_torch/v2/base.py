"""Spatial algebra and the generalized-coordinate System, batch-first.

Counterpart of `brax_tpu/v2/base.py`.  Every type is a dataclass of torch
tensors with the JAX package's field names.  A System's tensors carry no
batch axis; a State's lead with the env batch N, and every operation
broadcasts, so `x.do(y)` works for a batched x and an unbatched y.

`System.from_numpy(tree)` builds a System from a nested dict of numpy
arrays (each dataclass a dict of its fields plus "__type__", its class
name): the form in which a System made elsewhere, such as by the JAX
package, is carried across.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from brax_torch import maths

Tensor = torch.Tensor

Q_WIDTHS = {"f": 7, "1": 1, "2": 2, "3": 3}
QD_WIDTHS = {"f": 6, "1": 1, "2": 2, "3": 3}


def map_tensors(fn, obj):
    """Applies fn to every tensor of a tree of dataclasses, lists and tuples."""
    if isinstance(obj, Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        changes = {f.name: map_tensors(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)
                   if f.metadata.get("static") is None}
        return dataclasses.replace(obj, **changes)
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, x) for x in obj)
    return obj


class _Base:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        return map_tensors(lambda t: t.to(device), self)


@dataclass
class Transform(_Base):
    """Position (..., 3) and wxyz quaternion rotation (..., 4) of a frame."""

    pos: Tensor
    rot: Tensor

    def do(self, o: Any) -> Any:
        """Applies this transform to a Transform, Motion, Force or Inertia."""
        if isinstance(o, Transform):
            return Transform(pos=self.pos + maths.rotate(o.pos, self.rot),
                             rot=maths.quat_mul(self.rot, o.rot))
        if isinstance(o, Motion):
            inv = maths.quat_inv(self.rot)
            return Motion(ang=maths.rotate(o.ang, inv),
                          vel=maths.rotate(o.vel - maths.cross(self.pos, o.ang), inv))
        if isinstance(o, Force):
            vel = maths.rotate(o.vel, self.rot)
            return Force(vel=vel, ang=maths.rotate(o.ang, self.rot) + maths.cross(self.pos, vel))
        if isinstance(o, Inertia):
            # h[..., k, :] = cross(pos, -e_k); i' = R i R^T + h h^T m
            eye = torch.eye(3, dtype=self.pos.dtype, device=self.pos.device)
            h = maths.cross(self.pos[..., None, :], -eye)
            rot = maths.quat_to_3x3(self.rot)
            i = (rot @ o.i @ rot.transpose(-1, -2)
                 + h @ h.transpose(-1, -2) * o.mass[..., None, None])
            transform = Transform(pos=self.pos * o.mass[..., None], rot=self.rot)
            return Inertia(transform=transform, i=i, mass=o.mass)
        raise TypeError(f"cannot transform {type(o)}")

    def inv(self) -> "Transform":
        return Transform(pos=-1.0 * self.pos, rot=maths.quat_inv(self.rot))

    @classmethod
    def create(cls, pos: Optional[Tensor] = None, rot: Optional[Tensor] = None):
        if pos is None and rot is None:
            raise ValueError("must specify either pos or rot")
        if pos is None:
            pos = torch.zeros(rot.shape[:-1] + (3,), dtype=rot.dtype, device=rot.device)
        if rot is None:
            rot = torch.zeros(pos.shape[:-1] + (4,), dtype=pos.dtype, device=pos.device)
            rot[..., 0] = 1.0
        return Transform(pos=pos, rot=rot)

    @classmethod
    def zero(cls, shape=(), device="cpu") -> "Transform":
        rot = torch.zeros(shape + (4,), device=device)
        rot[..., 0] = 1.0
        return Transform(pos=torch.zeros(shape + (3,), device=device), rot=rot)


@dataclass
class Motion(_Base):
    """Spatial motion: angular and linear velocity, each (..., 3)."""

    ang: Tensor
    vel: Tensor

    def __add__(self, o: "Motion") -> "Motion":
        return Motion(ang=self.ang + o.ang, vel=self.vel + o.vel)

    def cross(self, other):
        """The spatial cross product self x other."""
        if isinstance(other, Force):
            return Force(ang=maths.cross(self.ang, other.ang) + maths.cross(self.vel, other.vel),
                         vel=maths.cross(self.ang, other.vel))
        return Motion(ang=maths.cross(self.ang, other.ang),
                      vel=maths.cross(self.ang, other.vel) + maths.cross(self.vel, other.ang))

    def dot(self, m) -> Tensor:
        return maths.vdot(self.vel, m.vel) + maths.vdot(self.ang, m.ang)

    @classmethod
    def zero(cls, shape=(), device="cpu") -> "Motion":
        return Motion(ang=torch.zeros(shape + (3,), device=device),
                      vel=torch.zeros(shape + (3,), device=device))


@dataclass
class Force(_Base):
    """Spatial force: torque and linear force, each (..., 3)."""

    ang: Tensor
    vel: Tensor

    def __add__(self, o: "Force") -> "Force":
        return Force(ang=self.ang + o.ang, vel=self.vel + o.vel)


@dataclass
class Inertia(_Base):
    """Spatial inertia: CoM transform, rotational inertia (..., 3, 3), mass."""

    transform: Transform
    i: Tensor
    mass: Tensor

    def mul(self, m: Motion) -> Force:
        """Inertia times motion: a force."""
        ang = (self.i @ m.ang[..., None])[..., 0] + maths.cross(self.transform.pos, m.vel)
        vel = self.mass[..., None] * m.vel - maths.cross(self.transform.pos, m.ang)
        return Force(ang=ang, vel=vel)


@dataclass
class Link(_Base):
    """Rigid segments: parent-frame transform, joint anchor, inertia."""

    transform: Transform
    joint: Transform
    inertia: Inertia
    invweight: Tensor
    constraint_stiffness: Tensor
    constraint_damping: Tensor
    constraint_limit_stiffness: Tensor
    constraint_ang_damping: Tensor


@dataclass
class DoF(_Base):
    """Degrees of freedom: motion axes, armature, stiffness, damping, limits."""

    motion: Motion
    armature: Tensor
    stiffness: Tensor
    damping: Tensor
    limit: Optional[Tuple[Tensor, Tensor]]
    invweight: Tensor


@dataclass
class Geometry(_Base):
    """A collidable shape on a link (link_idx None: static in the world)."""

    link_idx: Optional[Tensor]
    transform: Transform
    friction: Tensor
    elasticity: Tensor


@dataclass
class Sphere(Geometry):
    radius: Tensor


@dataclass
class Capsule(Geometry):
    radius: Tensor
    length: Tensor


@dataclass
class Plane(Geometry):
    """Infinite plane with +z normal in its own frame."""


@dataclass
class Contact(_Base):
    """Contact points between geometries, (N, nc, ...)."""

    pos: Tensor
    normal: Tensor
    penetration: Tensor
    friction: Tensor
    elasticity: Tensor
    link_idx: Tuple[Tensor, Tensor]


@dataclass
class Actuator(_Base):
    ctrl_range: Tensor
    gear: Tensor


@dataclass
class State(_Base):
    """Dynamic pipeline state, batch-first."""

    q: Tensor
    qd: Tensor
    x: Transform
    xd: Motion
    contact: Optional[Contact]


def _static():
    return dataclasses.field(metadata={"static": True})


@dataclass
class System(_Base):
    """A physical scene: links, joints, geometries and actuators."""

    dt: Tensor
    gravity: Tensor
    link: Link
    dof: DoF
    geoms: List[Geometry]
    contacts: List[Tuple[Geometry, Geometry]]
    actuator: Actuator
    init_q: Tensor
    vel_damping: Tensor
    ang_damping: Tensor
    baumgarte_erp: Tensor
    link_names: Tuple[str, ...] = _static()
    link_types: str = _static()
    link_parents: Tuple[int, ...] = _static()
    actuator_types: str = _static()
    actuator_link_id: Tuple[int, ...] = _static()
    actuator_qid: Tuple[int, ...] = _static()
    actuator_qdid: Tuple[int, ...] = _static()
    solver_iterations: int = _static()

    def num_links(self) -> int:
        return len(self.link_types)

    def dof_link(self) -> List[int]:
        """The link of each dof."""
        return [i for i, t in enumerate(self.link_types) for _ in range(QD_WIDTHS[t])]

    def q_idx(self, link_type: str) -> List[int]:
        idx, idxs = 0, []
        for typ in self.link_types:
            if typ in link_type:
                idxs.extend(range(idx, idx + Q_WIDTHS[typ]))
            idx += Q_WIDTHS[typ]
        return idxs

    def qd_idx(self, link_type: str) -> List[int]:
        idx, idxs = 0, []
        for typ in self.link_types:
            if typ in link_type:
                idxs.extend(range(idx, idx + QD_WIDTHS[typ]))
            idx += QD_WIDTHS[typ]
        return idxs

    def q_size(self) -> int:
        return sum(Q_WIDTHS[t] for t in self.link_types)

    def qd_size(self) -> int:
        return sum(QD_WIDTHS[t] for t in self.link_types)

    def act_size(self) -> int:
        """One control per actuator (as the JAX package counts them)."""
        return len(self.actuator_types)

    @property
    def device(self) -> torch.device:
        return self.dt.device

    @classmethod
    def from_numpy(cls, tree: Dict[str, Any], device="cuda") -> "System":
        """A System from nested dicts of numpy arrays (see the module doc)."""
        return _from_tree(tree, torch.device(device))


_TYPES = {c.__name__: c for c in (Transform, Motion, Force, Inertia, Link, DoF, Sphere,
                                  Capsule, Plane, Contact, Actuator, System)}


def _from_tree(tree, device):
    if isinstance(tree, dict):
        typ = _TYPES.get(tree.get("__type__"))
        if typ is None:
            raise NotImplementedError(f"{tree.get('__type__')} is not ported to brax_torch.v2")
        kw = {}
        for f in dataclasses.fields(typ):
            v = tree[f.name]
            kw[f.name] = v if f.metadata.get("static") else _from_tree(v, device)
        return typ(**kw)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_tree(x, device) for x in tree)
    if tree is None:
        return None
    arr = np.array(tree)
    dtype = torch.int64 if arr.dtype.kind in "iu" else torch.float32
    return torch.as_tensor(arr, dtype=dtype, device=device)
