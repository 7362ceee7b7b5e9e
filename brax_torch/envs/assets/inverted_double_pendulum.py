"""Scene configs for inverted_double_pendulum, as data.

A copy of `brax_tpu/envs/assets/inverted_double_pendulum.py`: `inverted_double_pendulum_config`
(PBD) and `inverted_double_pendulum_config_spring` (legacy spring), kept here so that the
port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def inverted_double_pendulum_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='cart',
                colliders=[
                    Collider(capsule=Capsule(radius=0.10000000149011612, length=0.4000000059604645, end=0), rotation=(90.0, 0.0, 90.0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=10.471975326538086,
                frozen=FrozenAxes(position=(0.0, 1.0, 1.0), rotation=(1.0, 1.0, 1.0)),
            ),
            Body(
                name='pole',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04899999871850014, length=0.6980008482933044, end=0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=5.018591403961182,
                frozen=FrozenAxes(position=(0.0, 1.0, 0.0), rotation=(1.0, 0.0, 1.0)),
            ),
            Body(
                name='pole2',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04899999871850014, length=0.6980008482933044, end=0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=5.018591403961182,
                frozen=FrozenAxes(position=(0.0, 1.0, 0.0), rotation=(1.0, 0.0, 1.0)),
            ),
        ],
        joints=[
            Joint(
                name='hinge',
                parent='cart',
                child='pole',
                child_offset=(0.0, 0.0, -0.30000001192092896),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-360.0, 360.0)],
            ),
            Joint(
                name='hinge2',
                parent='pole',
                child='pole2',
                parent_offset=(0.0, 0.0, 0.30000001192092896),
                child_offset=(0.0, 0.0, -0.30000001192092896),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-360.0, 360.0)],
            ),
        ],
        forces=[
            Force(name='thruster', body='cart', strength=500.0, kind='thruster'),
        ],
        gravity=(0.0, 0.0, -9.8100004196167),
        dt=0.05000000074505806,
        substeps=12,
        collide_include=[
            ('', ''),
        ],
        dynamics_mode='pbd',
    )

def inverted_double_pendulum_config_spring() -> Config:
    return Config(
        bodies=[
            Body(
                name='cart',
                colliders=[
                    Collider(capsule=Capsule(radius=0.10000000149011612, length=0.4000000059604645, end=0), rotation=(90.0, 0.0, 90.0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=10.471975326538086,
                frozen=FrozenAxes(position=(0.0, 1.0, 1.0), rotation=(1.0, 1.0, 1.0)),
            ),
            Body(
                name='pole',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04899999871850014, length=0.6980008482933044, end=0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=5.018591403961182,
                frozen=FrozenAxes(position=(0.0, 1.0, 0.0), rotation=(1.0, 0.0, 1.0)),
            ),
            Body(
                name='pole2',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04899999871850014, length=0.6980008482933044, end=0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=5.018591403961182,
                frozen=FrozenAxes(position=(0.0, 1.0, 0.0), rotation=(1.0, 0.0, 1.0)),
            ),
        ],
        joints=[
            Joint(
                name='hinge',
                parent='cart',
                child='pole',
                child_offset=(0.0, 0.0, -0.30000001192092896),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(0.0, 0.0)],
                stiffness=30000.0,
                spring_damping=500.0,
                limit_strength=0.0,
            ),
            Joint(
                name='hinge2',
                parent='pole',
                child='pole2',
                parent_offset=(0.0, 0.0, 0.30000001192092896),
                child_offset=(0.0, 0.0, -0.30000001192092896),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(0.0, 0.0)],
                stiffness=30000.0,
                spring_damping=500.0,
                limit_strength=0.0,
            ),
        ],
        forces=[
            Force(name='thruster', body='cart', strength=500.0, kind='thruster'),
        ],
        gravity=(0.0, 0.0, -9.8100004196167),
        dt=0.05000000074505806,
        substeps=12,
        collide_include=[
            ('', ''),
        ],
        dynamics_mode='legacy_spring',
    )
