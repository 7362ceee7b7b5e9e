"""Scene description schema.

A copy of `brax_tpu/sim/config.py`: plain-Python dataclasses that scenes are
written in, and `validate`, which normalizes a config before it is built.
The port keeps its own copy so that it imports nothing of `brax_tpu`.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Vec3 = Tuple[float, float, float]

ZERO3: Vec3 = (0.0, 0.0, 0.0)


@dataclass
class Capsule:
    radius: float
    length: float
    end: int = 0  # 0: both ends, 1: +z end only, -1: -z end only


@dataclass
class Sphere:
    radius: float


@dataclass
class Box:
    halfsize: Vec3 = ZERO3


@dataclass
class Plane:
    pass


@dataclass
class ClippedPlane:
    halfsize_x: float = 0.0
    halfsize_y: float = 0.0


@dataclass
class HeightMap:
    size: float = 0.0
    data: Tuple[float, ...] = ()


@dataclass
class MeshRef:
    name: str = ""
    scale: float = 0.0


@dataclass
class MeshGeometry:
    """A triangle mesh asset: flat vertex list + triangle index list."""

    name: str = ""
    path: str = ""
    vertices: Tuple[Vec3, ...] = ()
    faces: Tuple[int, ...] = ()
    face_normals: Tuple[Vec3, ...] = ()


@dataclass
class Material:
    friction: float = 0.0
    elasticity: float = 0.0


@dataclass
class Collider:
    # exactly one geometry:
    capsule: Optional[Capsule] = None
    sphere: Optional[Sphere] = None
    box: Optional[Box] = None
    plane: Optional[Plane] = None
    clipped_plane: Optional[ClippedPlane] = None
    heightmap: Optional[HeightMap] = None
    mesh: Optional[MeshRef] = None
    position: Vec3 = ZERO3
    rotation: Vec3 = ZERO3  # euler degrees, intrinsic x-y'-z''
    material: Optional[Material] = None
    no_contact: bool = False
    color: str = ""
    hidden: bool = False

    def kind(self) -> str:
        for k in ("capsule", "sphere", "box", "plane", "clipped_plane", "heightmap", "mesh"):
            if getattr(self, k) is not None:
                return k
        raise ValueError("collider has no geometry")


@dataclass
class FrozenAxes:
    position: Vec3 = ZERO3  # 1.0 => frozen along that axis
    rotation: Vec3 = ZERO3
    all: bool = False


@dataclass
class Body:
    name: str = ""
    colliders: List[Collider] = field(default_factory=list)
    inertia: Vec3 = ZERO3  # zeros => (1,1,1) after validation
    mass: float = 0.0
    frozen: FrozenAxes = field(default_factory=FrozenAxes)


@dataclass
class Joint:
    name: str = ""
    parent: str = ""
    child: str = ""
    parent_offset: Vec3 = ZERO3
    child_offset: Vec3 = ZERO3
    rotation: Vec3 = ZERO3  # joint frame, euler degrees
    reference_rotation: Vec3 = ZERO3
    angle_limits: List[Tuple[float, float]] = field(default_factory=list)  # degrees
    angular_damping: float = 0.0
    stiffness: float = 0.0  # legacy_spring only
    spring_damping: float = 0.0
    limit_strength: float = 0.0


@dataclass
class Actuator:
    name: str = ""
    joint: str = ""
    strength: float = 0.0
    kind: str = "torque"  # 'torque' | 'angle'


@dataclass
class Force:
    name: str = ""
    body: str = ""
    strength: float = 0.0
    kind: str = "thruster"  # 'thruster' | 'twister'


@dataclass
class DefaultQP:
    name: str = ""
    pos: Vec3 = ZERO3
    rot: Vec3 = ZERO3  # euler degrees
    vel: Vec3 = ZERO3
    ang: Vec3 = ZERO3


@dataclass
class DefaultAngle:
    name: str = ""
    angle: Vec3 = ZERO3  # degrees


@dataclass
class Defaults:
    angles: List[DefaultAngle] = field(default_factory=list)
    qps: List[DefaultQP] = field(default_factory=list)


@dataclass
class Config:
    bodies: List[Body] = field(default_factory=list)
    joints: List[Joint] = field(default_factory=list)
    actuators: List[Actuator] = field(default_factory=list)
    forces: List[Force] = field(default_factory=list)
    friction: float = 0.0
    elasticity: float = 0.0
    gravity: Vec3 = ZERO3
    velocity_damping: float = 0.0
    angular_damping: float = 0.0
    baumgarte_erp: float = 0.0
    dt: float = 0.0
    substeps: int = 0
    frozen: FrozenAxes = field(default_factory=FrozenAxes)
    collide_include: List[Tuple[str, str]] = field(default_factory=list)
    defaults: List[Defaults] = field(default_factory=list)
    collider_cutoff: int = 0
    mesh_geometries: List[MeshGeometry] = field(default_factory=list)
    dynamics_mode: str = ""  # 'pbd' | 'legacy_spring'
    solver_scale_pos: float = 0.0
    solver_scale_ang: float = 0.0
    solver_scale_collide: float = 0.0


def _v3(v) -> Vec3:
    return (float(v[0]), float(v[1]), float(v[2]))


def validate(config: Config) -> Config:
    """Validates and normalizes a config (parity: brax/physics/base.py:156-254)."""
    config = copy.deepcopy(config)

    if config.dt <= 0:
        raise ValueError("config.dt must be positive")
    if config.substeps == 0:
        config.substeps = 1
    config.solver_scale_collide = config.solver_scale_collide or 1.0

    for objs in (config.bodies, config.joints, config.actuators, config.mesh_geometries):
        names = set()
        for o in objs:
            if o.name in names:
                raise RuntimeError(f"duplicate name in config: {o.name}")
            names.add(o.name)

    if config.dynamics_mode == "legacy_spring":
        if any(j.stiffness == 0 for j in config.joints):
            raise ValueError("joint.stiffness must be >0 when dynamics_mode == legacy_spring")
    elif config.dynamics_mode == "pbd":
        if any(j.stiffness != 0 for j in config.joints):
            raise ValueError("joint.stiffness is invalid when dynamics_mode == pbd")
        if config.baumgarte_erp:
            raise ValueError("baumgarte_erp is invalid when dynamics_mode == pbd")
    elif any(j.stiffness != 0 for j in config.joints):
        config.dynamics_mode = "legacy_spring"
    else:
        config.dynamics_mode = "pbd"

    # reify frozen dimensions
    frozen = config.frozen
    if frozen.all:
        frozen.position = (1.0, 1.0, 1.0)
        frozen.rotation = (1.0, 1.0, 1.0)
    if all(list(frozen.position) + list(frozen.rotation)):
        frozen.all = True
    for b in config.bodies:
        if b.inertia == (0.0, 0.0, 0.0):
            b.inertia = (1.0, 1.0, 1.0)
        bp, br = list(b.frozen.position), list(b.frozen.rotation)
        b.frozen.position = tuple(bp[i] or frozen.position[i] for i in range(3))
        b.frozen.rotation = tuple(br[i] or frozen.rotation[i] for i in range(3))
        if b.frozen.all:
            b.frozen.position = (1.0, 1.0, 1.0)
            b.frozen.rotation = (1.0, 1.0, 1.0)
        if all(list(b.frozen.position) + list(b.frozen.rotation)):
            b.frozen.all = True
        for c in b.colliders:
            if c.material is None:
                c.material = Material(friction=config.friction, elasticity=config.elasticity)

    frozen.all = all(b.frozen.all for b in config.bodies)
    return config
