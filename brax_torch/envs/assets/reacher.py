"""Scene configs for reacher, as data.

A copy of `brax_tpu/envs/assets/reacher.py`: `reacher_config`
(PBD) and `reacher_config_spring` (legacy spring), kept here so that the
port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def reacher_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='ground',
                colliders=[
                    Collider(plane=Plane()),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
                frozen=FrozenAxes(all=True),
            ),
            Body(
                name='body0',
                colliders=[
                    Collider(capsule=Capsule(radius=0.009999999776482582, length=0.11999999731779099, end=0), position=(0.05000000074505806, 0.0, 0.0), rotation=(0.0, 90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.03560471534729004,
            ),
            Body(
                name='body1',
                colliders=[
                    Collider(capsule=Capsule(radius=0.009999999776482582, length=0.11999999731779099, end=0), position=(0.05000000074505806, 0.0, 0.0), rotation=(0.0, 90.0, 0.0)),
                    Collider(sphere=Sphere(radius=0.009999999776482582), position=(0.10999999940395355, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.03560471534729004,
            ),
            Body(
                name='target',
                colliders=[
                    Collider(sphere=Sphere(radius=0.008999999612569809)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
                frozen=FrozenAxes(all=True),
            ),
        ],
        joints=[
            Joint(
                name='joint0',
                parent='ground',
                child='body0',
                parent_offset=(0.0, 0.0, 0.009999999776482582),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-360.0, 360.0)],
            ),
            Joint(
                name='joint1',
                parent='body0',
                child='body1',
                parent_offset=(0.10000000149011612, 0.0, 0.0),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-360.0, 360.0)],
            ),
        ],
        actuators=[
            Actuator(name='joint0', joint='joint0', strength=25.0, kind='torque'),
            Actuator(name='joint1', joint='joint1', strength=25.0, kind='torque'),
        ],
        gravity=(0.0, 0.0, -9.8100004196167),
        dt=0.019999999552965164,
        substeps=4,
        frozen=FrozenAxes(position=(0.0, 0.0, 1.0), rotation=(1.0, 1.0, 0.0)),
        collide_include=[
            ('', ''),
        ],
        dynamics_mode='pbd',
    )

def reacher_config_spring() -> Config:
    return Config(
        bodies=[
            Body(
                name='ground',
                colliders=[
                    Collider(plane=Plane()),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
                frozen=FrozenAxes(all=True),
            ),
            Body(
                name='body0',
                colliders=[
                    Collider(capsule=Capsule(radius=0.009999999776482582, length=0.11999999731779099, end=0), position=(0.05000000074505806, 0.0, 0.0), rotation=(0.0, 90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.03560471534729004,
            ),
            Body(
                name='body1',
                colliders=[
                    Collider(capsule=Capsule(radius=0.009999999776482582, length=0.11999999731779099, end=0), position=(0.05000000074505806, 0.0, 0.0), rotation=(0.0, 90.0, 0.0)),
                    Collider(sphere=Sphere(radius=0.009999999776482582), position=(0.10999999940395355, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.03560471534729004,
            ),
            Body(
                name='target',
                colliders=[
                    Collider(sphere=Sphere(radius=0.008999999612569809)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
                frozen=FrozenAxes(all=True),
            ),
        ],
        joints=[
            Joint(
                name='joint0',
                parent='ground',
                child='body0',
                parent_offset=(0.0, 0.0, 0.009999999776482582),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-360.0, 360.0)],
                stiffness=100.0,
                spring_damping=3.0,
                limit_strength=0.0,
            ),
            Joint(
                name='joint1',
                parent='body0',
                child='body1',
                parent_offset=(0.10000000149011612, 0.0, 0.0),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-360.0, 360.0)],
                stiffness=100.0,
                spring_damping=3.0,
                limit_strength=0.0,
            ),
        ],
        actuators=[
            Actuator(name='joint0', joint='joint0', strength=25.0, kind='torque'),
            Actuator(name='joint1', joint='joint1', strength=25.0, kind='torque'),
        ],
        gravity=(0.0, 0.0, -9.8100004196167),
        baumgarte_erp=0.10000000149011612,
        dt=0.019999999552965164,
        substeps=4,
        frozen=FrozenAxes(position=(0.0, 0.0, 1.0), rotation=(1.0, 1.0, 0.0)),
        collide_include=[
            ('', ''),
        ],
        dynamics_mode='legacy_spring',
    )
