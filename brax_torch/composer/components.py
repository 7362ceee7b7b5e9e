"""Component registry for scene composition.

Counterpart of `brax_tpu/composer/components.py`.  Each component provides
a scene-config factory (bodies, joints, actuators and forces without a
ground plane), a root body, the bodies it collides with, a termination
function over the batch and its default observers.  The octopus component
is a legacy-spring scene (28 bodies and 50 contact points once composed),
which the PBD kernel's wide route steps.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from brax_torch import maths
from brax_torch.sim import config as cfg


@dataclasses.dataclass
class ComponentSpecs:
    config: cfg.Config  # bodies/joints/actuators only (no ground, no dt)
    root: str
    collides: Sequence[str]
    term_fn: Optional[Callable] = None
    observers: Sequence[str] = ("root_z_joints",)


_COMPONENTS: Dict[str, Callable[..., ComponentSpecs]] = {}


def register_component(name: str, fn: Callable[..., ComponentSpecs]):
    _COMPONENTS[name] = fn


def load_component(component: str, **kwargs) -> ComponentSpecs:
    return _COMPONENTS[component](**kwargs)


def list_components():
    return sorted(_COMPONENTS)


# --- termination helpers: done (N,), qp batch-first ---------------------------


def height_term_fn(done, qp, body_idx, min_height=0.2, max_height=1.0):
    z = qp.pos[:, body_idx, 2]
    done = torch.where(z < min_height, 1.0, done)
    return torch.where(z > max_height, 1.0, done)


def upright_term_fn(done, qp, body_idx):
    """Terminates when the root's +z axis points down."""
    rot = qp.rot[:, body_idx]
    up = maths.rotate(torch.tensor([0.0, 0.0, 1.0], device=rot.device).expand(rot.shape[0], 3),
                      rot)
    return torch.where(up[:, 2] < 0, 1.0, done)


# --- built-in components -----------------------------------------------------


def _strip_ground(config: cfg.Config) -> cfg.Config:
    config = copy.deepcopy(config)
    ground_names = {
        b.name for b in config.bodies
        if any(c.plane is not None for c in b.colliders)
    }
    config.bodies = [b for b in config.bodies if b.name not in ground_names]
    config.collide_include = [
        p for p in config.collide_include
        if p[0] not in ground_names and p[1] not in ground_names
    ]
    return config


def _ground() -> ComponentSpecs:
    body = cfg.Body(
        name="Ground",
        colliders=[cfg.Collider(plane=cfg.Plane())],
        inertia=(1.0, 1.0, 1.0),
        mass=1.0,
        frozen=cfg.FrozenAxes(all=True),
    )
    return ComponentSpecs(
        config=cfg.Config(bodies=[body], dt=0.05, substeps=10),
        root="Ground",
        collides=("Ground",),
        term_fn=None,
        observers=(),
    )


def _ant_term_fn(done, qp, root_idx):
    done = height_term_fn(done, qp, root_idx, min_height=0.2, max_height=1.0)
    return upright_term_fn(done, qp, root_idx)


def _ant() -> ComponentSpecs:
    from brax_torch.envs.assets.ant import ant_config

    return ComponentSpecs(
        config=_strip_ground(ant_config()),
        root="$ Torso",
        collides=("$ Torso", "$ Body 4", "$ Body 7", "$ Body 10", "$ Body 13"),
        term_fn=_ant_term_fn,
        observers=("root_z_joints", "cfrc"),
    )


def _halfcheetah() -> ComponentSpecs:
    from brax_torch.envs.assets.half_cheetah import halfcheetah_config

    return ComponentSpecs(
        config=_strip_ground(halfcheetah_config()),
        root="torso",
        collides=("torso", "bfoot", "ffoot"),
        term_fn=None,
        observers=("root_z_joints",),
    )


def _ball(radius: float = 0.5, mass: float = 1.0, frozen: bool = False) -> ComponentSpecs:
    body = cfg.Body(
        name="Ball",
        colliders=[cfg.Collider(capsule=cfg.Capsule(radius=radius, length=2 * radius))],
        inertia=(1.0, 1.0, 1.0),
        mass=mass,
        frozen=cfg.FrozenAxes(all=True) if frozen else cfg.FrozenAxes(),
    )
    return ComponentSpecs(
        config=cfg.Config(bodies=[body], dt=0.05, substeps=10),
        root="Ball",
        collides=("Ball",),
        term_fn=None,
        observers=("qp",),
    )


def _singleton(
    size=0.25,
    collider_type: str = "sphere",
    no_obs: bool = False,
    mass: Optional[float] = None,
) -> ComponentSpecs:
    """Single primitive object: a sphere of radius `size`, or a capsule with
    `size=(radius, length)`."""
    if collider_type == "sphere":
        collider = cfg.Collider(sphere=cfg.Sphere(radius=float(size)))
        scale = float(size)
    elif collider_type == "capsule":
        radius, length = size
        collider = cfg.Collider(
            capsule=cfg.Capsule(radius=float(radius), length=float(length))
        )
        scale = float(radius)
    else:
        raise NotImplementedError(collider_type)
    body = cfg.Body(
        name="object",
        colliders=[collider],
        inertia=(1.0, 1.0, 1.0),
        mass=mass if mass is not None else 1.0 * scale**3,
    )
    return ComponentSpecs(
        config=cfg.Config(bodies=[body], dt=0.05, substeps=10),
        root="object",
        collides=("object",),
        term_fn=None,
        observers=() if no_obs else ("qp",),
    )


def _pointmass(radius: float = 0.25, strength: float = 20.0) -> ComponentSpecs:
    """Thruster-driven sphere: the cheapest actuated agent (3 action dims),
    planar (frozen z and rotations)."""
    body = cfg.Body(
        name="object",
        colliders=[cfg.Collider(sphere=cfg.Sphere(radius=radius))],
        inertia=(1.0, 1.0, 1.0),
        mass=1.0,
        frozen=cfg.FrozenAxes(position=(0.0, 0.0, 1.0), rotation=(1.0, 1.0, 1.0)),
    )
    force = cfg.Force(
        name="object_thrust", body="object", strength=strength, kind="thruster"
    )
    return ComponentSpecs(
        config=cfg.Config(bodies=[body], forces=[force], dt=0.05, substeps=10),
        root="object",
        collides=("object",),
        term_fn=None,
        observers=("qp",),
    )


def _pro_ant(num_legs: int = 10) -> ComponentSpecs:
    """Procedural N-legged ant: a torso capsule with `num_legs` two-segment
    legs spaced evenly around it, with the standard ant's segment geometry
    and joint parameters."""
    aux_len = 0.4428427219390869
    low_len = 0.7256854176521301
    r = 0.08
    bodies = [
        cfg.Body(
            name="torso",
            colliders=[cfg.Collider(capsule=cfg.Capsule(radius=0.25, length=0.5, end=1))],
            inertia=(1.0, 1.0, 1.0),
            mass=10.0,
        )
    ]
    joints, actuators, collides = [], [], ["torso"]
    for i in range(num_legs):
        theta = 2.0 * np.pi * i / num_legs
        aux, low = f"aux_{i}", f"lower_{i}"
        bodies += [
            cfg.Body(
                name=aux,
                colliders=[
                    cfg.Collider(
                        capsule=cfg.Capsule(radius=r, length=aux_len),
                        rotation=(90.0, -90.0, 0.0),
                    )
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            cfg.Body(
                name=low,
                colliders=[
                    cfg.Collider(
                        capsule=cfg.Capsule(radius=r, length=low_len, end=-1),
                        rotation=(90.0, -90.0, 0.0),
                    )
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
        ]
        hip_off = aux_len / 2.0 + r
        joints += [
            cfg.Joint(
                name=f"hip_{i}",
                parent="torso",
                child=aux,
                parent_offset=(hip_off * np.cos(theta), hip_off * np.sin(theta), 0.0),
                rotation=(0.0, -90.0, 0.0),
                reference_rotation=(0.0, 0.0, float(np.degrees(theta))),
                angle_limits=[(-30.0, 30.0)],
                angular_damping=35.0,
            ),
            cfg.Joint(
                name=f"knee_{i}",
                parent=aux,
                child=low,
                parent_offset=(aux_len / 2.0 - r, 0.0, 0.0),
                child_offset=(-low_len / 2.0 + r, 0.0, 0.0),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(30.0, 70.0)],
                angular_damping=35.0,
            ),
        ]
        actuators += [
            cfg.Actuator(name=f"hip_{i}", joint=f"hip_{i}", strength=350.0, kind="torque"),
            cfg.Actuator(name=f"knee_{i}", joint=f"knee_{i}", strength=350.0, kind="torque"),
        ]
        collides += [aux, low]

    return ComponentSpecs(
        config=cfg.Config(
            bodies=bodies, joints=joints, actuators=actuators, dt=0.05, substeps=10
        ),
        root="torso",
        collides=tuple(collides),
        term_fn=_ant_term_fn,
        observers=("root_z_joints", "cfrc"),
    )


def _octopus() -> ComponentSpecs:
    """27-body octopus: 8 three-segment tentacles under a soft body, root
    frozen (it hangs from the root); legacy spring."""
    from brax_torch.composer.assets.octopus import octopus_config

    config = octopus_config()
    collides = tuple(
        b.name for b in config.bodies if b.name not in ("octopus", "octopus_body")
    )
    return ComponentSpecs(
        config=config,
        root="octopus",
        collides=collides,
        term_fn=upright_term_fn,
        observers=("root_z_joints",),
    )


def _humanoid() -> ComponentSpecs:
    from brax_torch.envs.assets.humanoid import humanoid_config

    def term_fn(done, qp, root_idx):
        return height_term_fn(done, qp, root_idx, min_height=0.6, max_height=2.1)

    return ComponentSpecs(
        config=_strip_ground(humanoid_config()),
        root="torso",
        collides=("torso", "left_shin", "right_shin"),
        term_fn=term_fn,
        observers=("root_z_joints",),
    )


register_component("ground", _ground)
register_component("ant", _ant)
register_component("halfcheetah", _halfcheetah)
register_component("humanoid", _humanoid)
register_component("ball", _ball)
register_component("singleton", _singleton)
register_component("pointmass", _pointmass)
register_component("pro_ant", _pro_ant)
register_component("octopus", _octopus)
