"""Scene config for acrobot, as data.

A copy of `brax_tpu/envs/assets/acrobot.py`: `acrobot_config` (PBD), kept
here so that the port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def acrobot_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='cart',
                colliders=[
                    Collider(capsule=Capsule(radius=0.10000000149011612, length=0.4000000059604645, end=0), rotation=(90.0, 0.0, 90.0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=10.471975326538086,
                frozen=FrozenAxes(position=(1.0, 1.0, 1.0), rotation=(1.0, 1.0, 1.0)),
            ),
            Body(
                name='pole',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04899999871850014, length=1.0, end=0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=2.5,
                frozen=FrozenAxes(position=(0.0, 1.0, 0.0), rotation=(1.0, 0.0, 1.0)),
            ),
            Body(
                name='pole2',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04899999871850014, length=1.0, end=0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=2.5,
                frozen=FrozenAxes(position=(0.0, 1.0, 0.0), rotation=(1.0, 0.0, 1.0)),
            ),
        ],
        joints=[
            Joint(
                name='hinge',
                parent='cart',
                child='pole',
                child_offset=(0.0, 0.0, -0.44999998807907104),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-360.0, 360.0)],
            ),
            Joint(
                name='hinge2',
                parent='pole',
                child='pole2',
                parent_offset=(0.0, 0.0, 0.44999998807907104),
                child_offset=(0.0, 0.0, -0.44999998807907104),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-360.0, 360.0)],
            ),
        ],
        actuators=[
            Actuator(name='hinge2', joint='hinge2', strength=25.0, kind='torque'),
        ],
        gravity=(0.0, 0.0, -9.8100004196167),
        dt=0.009999999776482582,
        substeps=4,
        collide_include=[
            ('', ''),
        ],
        defaults=[
            Defaults(
                angles=[
                    DefaultAngle(name='hinge', angle=(180.0, 0.0, 0.0)),
                ],
            ),
        ],
        dynamics_mode='pbd',
    )
