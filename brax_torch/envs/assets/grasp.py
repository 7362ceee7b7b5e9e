"""Scene config for grasp, as data.

A copy of `brax_tpu/envs/assets/grasp.py`: `grasp_config` (PBD), kept
here so that the port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def grasp_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='Ground',
                colliders=[
                    Collider(plane=Plane()),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
                frozen=FrozenAxes(all=True),
            ),
            Body(
                name='Object',
                colliders=[
                    Collider(capsule=Capsule(radius=1.0, length=2.0199999809265137, end=0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbProximal',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbDistal',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbMiddle',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandPalm',
                colliders=[
                    Collider(capsule=Capsule(radius=1.5, length=3.0999999046325684, end=0), rotation=(120.0, 0.0, 0.0)),
                ],
                inertia=(5000.03515625, 10000.72265625, 10000.72265625),
                mass=1.0,
                frozen=FrozenAxes(all=True),
            ),
            Body(
                name='HandThumbProximalTwo',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbMiddleTwo',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbDistalTwo',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbProximalThree',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(0.0, 90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbMiddleThree',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(0.0, 90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbDistalThree',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(0.0, 90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbProximalFour',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(0.0, 90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbMiddleFour',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(0.0, 90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='HandThumbDistalFour',
                colliders=[
                    Collider(capsule=Capsule(radius=0.5, length=2.0, end=0), rotation=(0.0, 90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Target',
                colliders=[
                    Collider(sphere=Sphere(radius=1.100000023841858)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=0.0,
                frozen=FrozenAxes(all=True),
            ),
        ],
        joints=[
            Joint(
                name='HandThumbMiddle_HandThumbDistal',
                parent='HandThumbMiddle',
                child='HandThumbDistal',
                parent_offset=(0.0, 0.75, 0.0),
                child_offset=(0.0, -0.75, 0.0),
                angle_limits=[(-90.0, 0.0), (-0.10000000149011612, 0.10000000149011612), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandThumbProximal_HandThumbMiddle',
                parent='HandThumbProximal',
                child='HandThumbMiddle',
                parent_offset=(0.0, 0.75, 0.0),
                child_offset=(0.0, -0.75, 0.0),
                angle_limits=[(-90.0, 0.0), (-0.10000000149011612, 0.10000000149011612), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandPalm_HandThumbProximal',
                parent='HandPalm',
                child='HandThumbProximal',
                parent_offset=(0.0, 1.5, -0.5),
                child_offset=(0.0, -0.75, 0.0),
                angle_limits=[(-45.0, 45.0), (-45.0, 45.0), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandThumbMiddleTwo_HandThumbDistalTwo',
                parent='HandThumbMiddleTwo',
                child='HandThumbDistalTwo',
                parent_offset=(0.0, -0.75, 0.0),
                child_offset=(0.0, 0.75, 0.0),
                angle_limits=[(0.0, 90.0), (-0.10000000149011612, 0.10000000149011612), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandThumbProximalTwo_HandThumbMiddleTwo',
                parent='HandThumbProximalTwo',
                child='HandThumbMiddleTwo',
                parent_offset=(0.0, -0.75, 0.0),
                child_offset=(0.0, 0.75, 0.0),
                angle_limits=[(0.0, 90.0), (-0.10000000149011612, 0.10000000149011612), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandPalm_HandThumbProximalTwo',
                parent='HandPalm',
                child='HandThumbProximalTwo',
                parent_offset=(0.0, -1.5, -0.5),
                child_offset=(0.0, 0.75, 0.0),
                angle_limits=[(-45.0, 45.0), (-45.0, 45.0), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandThumbMiddleThree_HandThumbDistalThree',
                parent='HandThumbMiddleThree',
                child='HandThumbDistalThree',
                parent_offset=(-0.75, 0.0, 0.0),
                child_offset=(0.75, 0.0, 0.0),
                rotation=(0.0, 0.0, -90.0),
                angle_limits=[(0.0, 90.0), (-0.10000000149011612, 0.10000000149011612), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandThumbProximalThree_HandThumbMiddleThree',
                parent='HandThumbProximalThree',
                child='HandThumbMiddleThree',
                parent_offset=(-0.75, 0.0, 0.0),
                child_offset=(0.75, 0.0, 0.0),
                rotation=(0.0, 0.0, -90.0),
                angle_limits=[(0.0, 90.0), (-0.10000000149011612, 0.10000000149011612), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandPalm_HandThumbProximalThree',
                parent='HandPalm',
                child='HandThumbProximalThree',
                parent_offset=(-1.5, 0.0, -0.5),
                child_offset=(0.75, 0.0, 0.0),
                rotation=(0.0, 0.0, -90.0),
                angle_limits=[(-45.0, 45.0), (-45.0, 45.0), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandThumbMiddleFour_HandThumbDistalFour',
                parent='HandThumbMiddleFour',
                child='HandThumbDistalFour',
                parent_offset=(0.75, 0.0, 0.0),
                child_offset=(-0.75, 0.0, 0.0),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(0.0, 90.0), (-0.10000000149011612, 0.10000000149011612), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandThumbProximalFour_HandThumbMiddleFour',
                parent='HandThumbProximalFour',
                child='HandThumbMiddleFour',
                parent_offset=(0.75, 0.0, 0.0),
                child_offset=(-0.75, 0.0, 0.0),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(0.0, 90.0), (-0.10000000149011612, 0.10000000149011612), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
            Joint(
                name='HandPalm_HandThumbProximalFour',
                parent='HandPalm',
                child='HandThumbProximalFour',
                parent_offset=(1.5, 0.0, -0.5),
                child_offset=(-0.75, 0.0, 0.0),
                rotation=(180.0, 0.0, -90.0),
                angle_limits=[(-45.0, 45.0), (-45.0, 45.0), (-0.10000000149011612, 0.10000000149011612)],
                angular_damping=50.0,
            ),
        ],
        actuators=[
            Actuator(name='HandThumbMiddle_HandThumbDistal', joint='HandThumbMiddle_HandThumbDistal', strength=300.0, kind='angle'),
            Actuator(name='HandThumbProximal_HandThumbMiddle', joint='HandThumbProximal_HandThumbMiddle', strength=300.0, kind='angle'),
            Actuator(name='HandPalm_HandThumbProximal', joint='HandPalm_HandThumbProximal', strength=300.0, kind='angle'),
            Actuator(name='HandThumbMiddleTwo_HandThumbDistalTwo', joint='HandThumbMiddleTwo_HandThumbDistalTwo', strength=300.0, kind='angle'),
            Actuator(name='HandThumbProximalTwo_HandThumbMiddleTwo', joint='HandThumbProximalTwo_HandThumbMiddleTwo', strength=300.0, kind='angle'),
            Actuator(name='HandPalm_HandThumbProximalTwo', joint='HandPalm_HandThumbProximalTwo', strength=300.0, kind='angle'),
            Actuator(name='HandThumbMiddleThree_HandThumbDistalThree', joint='HandThumbMiddleThree_HandThumbDistalThree', strength=300.0, kind='angle'),
            Actuator(name='HandThumbProximalThree_HandThumbMiddleThree', joint='HandThumbProximalThree_HandThumbMiddleThree', strength=300.0, kind='angle'),
            Actuator(name='HandPalm_HandThumbProximalThree', joint='HandPalm_HandThumbProximalThree', strength=300.0, kind='angle'),
            Actuator(name='HandThumbMiddleFour_HandThumbDistalFour', joint='HandThumbMiddleFour_HandThumbDistalFour', strength=300.0, kind='angle'),
            Actuator(name='HandThumbProximalFour_HandThumbMiddleFour', joint='HandThumbProximalFour_HandThumbMiddleFour', strength=300.0, kind='angle'),
            Actuator(name='HandPalm_HandThumbProximalFour', joint='HandPalm_HandThumbProximalFour', strength=300.0, kind='angle'),
        ],
        friction=1.0,
        gravity=(0.0, 0.0, -9.800000190734863),
        angular_damping=-0.05000000074505806,
        dt=0.019999999552965164,
        substeps=4,
        collide_include=[
            ('Ground', 'Object'),
            ('HandThumbDistal', 'Object'),
            ('HandThumbDistalTwo', 'Object'),
            ('HandThumbDistalThree', 'Object'),
            ('HandThumbDistalFour', 'Object'),
            ('HandPalm', 'Object'),
        ],
        dynamics_mode='pbd',
    )
