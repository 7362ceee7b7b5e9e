"""Core simulation state types, batch-first.

Counterpart of `brax_tpu/sim/types.py`.  A state `QP` holds four tensors of
shape `(N, nb, 3)` / `(N, nb, 4)`: the same layout that `jax.vmap` gives the
JAX package's per-env `(nb, 3)` arrays.  Index tables, which the JAX package
keeps as hashable `HArray`s, are host numpy int arrays here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from brax_torch import maths

Tensor = torch.Tensor


def index(idx, device) -> Tensor:
    """A host index table as a long tensor on `device`."""
    return torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)


@dataclass
class QP:
    """Maximal-coordinate state of every body: (..., nb, 3/4) tensors."""

    pos: Tensor
    rot: Tensor
    vel: Tensor
    ang: Tensor

    @classmethod
    def zero(cls, shape=(), device="cuda") -> "QP":
        rot = torch.zeros(shape + (4,), device=device)
        rot[..., 0] = 1.0
        return cls(
            pos=torch.zeros(shape + (3,), device=device),
            rot=rot,
            vel=torch.zeros(shape + (3,), device=device),
            ang=torch.zeros(shape + (3,), device=device),
        )

    @classmethod
    def from_numpy(cls, pos, rot, vel, ang, device="cuda") -> "QP":
        """A float32 QP on `device` from array-likes (e.g. JAX state)."""
        t = lambda x: torch.as_tensor(np.array(x, dtype=np.float32), device=device)
        return cls(pos=t(pos), rot=t(rot), vel=t(vel), ang=t(ang))

    def numpy(self):
        """(pos, rot, vel, ang) as host numpy arrays."""
        return tuple(x.detach().cpu().numpy() for x in (self.pos, self.rot, self.vel, self.ang))

    def replace(self, **kw) -> "QP":
        return dataclasses.replace(self, **kw)

    def take(self, idx) -> "QP":
        """Gathers per-body state along the body axis (dim -2)."""
        i = index(idx, self.pos.device)
        return QP(
            pos=self.pos[..., i, :],
            rot=self.rot[..., i, :],
            vel=self.vel[..., i, :],
            ang=self.ang[..., i, :],
        )

    def to_world(self, rpos: Tensor):
        """World position/velocity of body-local point(s) rpos (..., 3)."""
        rpos_off = maths.rotate(rpos, self.rot)
        rvel = maths.cross(self.ang, rpos_off)
        return self.pos + rpos_off, self.vel + rvel


@dataclass
class DP:
    """Velocity-level deltas (velocity, angular velocity)."""

    vel: Tensor
    ang: Tensor

    def __add__(self, o: "DP") -> "DP":
        return DP(self.vel + o.vel, self.ang + o.ang)


@dataclass
class DQ:
    """Position-level deltas (position, quaternion)."""

    pos: Tensor
    rot: Tensor

    def __add__(self, o: "DQ") -> "DQ":
        return DQ(self.pos + o.pos, self.rot + o.rot)


@dataclass
class Contact:
    """Contact manifold data, (..., npairs, ncontacts, 3) / (..., npairs, ncontacts)."""

    pos: Tensor
    vel: Tensor
    normal: Tensor
    penetration: Tensor


@dataclass
class Info:
    """Per-step force/contact telemetry."""

    contact: DP
    joint: Any
    actuator: DP
    contact_pos: Tensor
    contact_normal: Tensor
    contact_penetration: Tensor
