"""Scene config for swimmer, as data.

A copy of `brax_tpu/envs/assets/swimmer.py`: `swimmer_config` (PBD), kept
here so that the port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def swimmer_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='torso',
                colliders=[
                    Collider(capsule=Capsule(radius=0.10000000149011612, length=1.2000000476837158, end=0), rotation=(0.0, -90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.3560471832752228,
            ),
            Body(
                name='mid',
                colliders=[
                    Collider(capsule=Capsule(radius=0.10000000149011612, length=1.2000000476837158, end=0), rotation=(0.0, -90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.3560471832752228,
            ),
            Body(
                name='back',
                colliders=[
                    Collider(capsule=Capsule(radius=0.10000000149011612, length=1.2000000476837158, end=0), rotation=(0.0, -90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.3560471832752228,
            ),
            Body(
                name='floor',
                colliders=[
                    Collider(plane=Plane()),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
                frozen=FrozenAxes(all=True),
            ),
        ],
        joints=[
            Joint(
                name='rot2',
                parent='torso',
                child='mid',
                parent_offset=(0.5, 0.0, 0.0),
                child_offset=(-0.5, 0.0, 0.0),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-100.0, 100.0)],
                angular_damping=10.0,
            ),
            Joint(
                name='rot3',
                parent='mid',
                child='back',
                parent_offset=(0.5, 0.0, 0.0),
                child_offset=(-0.5, 0.0, 0.0),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-100.0, 100.0)],
                angular_damping=10.0,
            ),
        ],
        actuators=[
            Actuator(name='rot2', joint='rot2', strength=30.0, kind='torque'),
            Actuator(name='rot3', joint='rot3', strength=30.0, kind='torque'),
        ],
        forces=[
            Force(name='torso_viscosity_thruster', body='torso', strength=1.0, kind='thruster'),
            Force(name='mid_viscosity_thruster', body='mid', strength=1.0, kind='thruster'),
            Force(name='back_viscosity_thruster', body='back', strength=1.0, kind='thruster'),
        ],
        friction=0.6000000238418579,
        gravity=(0.0, 0.0, 0.0),
        angular_damping=-0.05000000074505806,
        dt=0.03999999910593033,
        substeps=12,
        frozen=FrozenAxes(rotation=(1.0, 1.0, 0.0)),
        collide_include=[
            ('', ''),
        ],
        dynamics_mode='pbd',
    )
