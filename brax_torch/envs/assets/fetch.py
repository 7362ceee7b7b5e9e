"""Scene config for fetch, as data.

A copy of `brax_tpu/envs/assets/fetch.py`: `fetch_config` (PBD), kept
here so that the port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def fetch_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='Torso',
                colliders=[
                    Collider(box=Box(halfsize=(0.75, 0.25, 0.125))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Shoulders',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.75, 0.125))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Hips',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.75, 0.125))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Front Right Upper',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.125, 0.5))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Front Right Lower',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.125, 0.5))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Front Left Upper',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.125, 0.5))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Front Left Lower',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.125, 0.5))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Back Right Upper',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.125, 0.5))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Back Right Lower',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.125, 0.5))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Back Left Upper',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.125, 0.5))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Back Left Lower',
                colliders=[
                    Collider(box=Box(halfsize=(0.25, 0.125, 0.5))),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Ground',
                colliders=[
                    Collider(plane=Plane()),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=0.0,
                frozen=FrozenAxes(all=True),
            ),
            Body(
                name='Target',
                colliders=[
                    Collider(sphere=Sphere(radius=2.0)),
                ],
                inertia=(0.0, 0.0, 0.0),
                mass=0.0,
                frozen=FrozenAxes(all=True),
            ),
        ],
        joints=[
            Joint(
                name='Torso_Shoulders',
                parent='Torso',
                child='Shoulders',
                parent_offset=(1.0, 0.0, 0.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
            Joint(
                name='Torso_Hips',
                parent='Torso',
                child='Hips',
                parent_offset=(-1.0, 0.0, 0.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
            Joint(
                name='Shoulders_Front Right Upper',
                parent='Shoulders',
                child='Front Right Upper',
                parent_offset=(0.0, -0.875, 0.0),
                child_offset=(0.0, 0.0, 0.375),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
            Joint(
                name='Front Right Upper_Front Right Lower',
                parent='Front Right Upper',
                child='Front Right Lower',
                parent_offset=(0.0, 0.25, -0.25),
                child_offset=(0.0, 0.0, 0.25),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
            Joint(
                name='Shoulders_Front Left Upper',
                parent='Shoulders',
                child='Front Left Upper',
                parent_offset=(0.0, 0.875, 0.0),
                child_offset=(0.0, 0.0, 0.375),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
            Joint(
                name='Front Left Upper_Front Left Lower',
                parent='Front Left Upper',
                child='Front Left Lower',
                parent_offset=(0.0, -0.25, -0.25),
                child_offset=(0.0, 0.0, 0.25),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
            Joint(
                name='Hips_Back Right Upper',
                parent='Hips',
                child='Back Right Upper',
                parent_offset=(0.0, -0.875, 0.0),
                child_offset=(0.0, 0.0, 0.375),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
            Joint(
                name='Back Right Upper_Back Right Lower',
                parent='Back Right Upper',
                child='Back Right Lower',
                parent_offset=(0.0, 0.25, -0.25),
                child_offset=(0.0, 0.0, 0.25),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
            Joint(
                name='Hips_Back Left Upper',
                parent='Hips',
                child='Back Left Upper',
                parent_offset=(0.0, 0.875, 0.0),
                child_offset=(0.0, 0.0, 0.375),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
            Joint(
                name='Back Left Upper_Back Left Lower',
                parent='Back Left Upper',
                child='Back Left Lower',
                parent_offset=(0.0, -0.25, -0.25),
                child_offset=(0.0, 0.0, 0.25),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-60.0, 60.0)],
                angular_damping=35.0,
            ),
        ],
        actuators=[
            Actuator(name='Torso_Shoulders', joint='Torso_Shoulders', strength=300.0, kind='torque'),
            Actuator(name='Torso_Hips', joint='Torso_Hips', strength=300.0, kind='torque'),
            Actuator(name='Shoulders_Front Right Upper', joint='Shoulders_Front Right Upper', strength=300.0, kind='torque'),
            Actuator(name='Front Right Upper_Front Right Lower', joint='Front Right Upper_Front Right Lower', strength=300.0, kind='torque'),
            Actuator(name='Shoulders_Front Left Upper', joint='Shoulders_Front Left Upper', strength=300.0, kind='torque'),
            Actuator(name='Front Left Upper_Front Left Lower', joint='Front Left Upper_Front Left Lower', strength=300.0, kind='torque'),
            Actuator(name='Hips_Back Right Upper', joint='Hips_Back Right Upper', strength=300.0, kind='torque'),
            Actuator(name='Back Right Upper_Back Right Lower', joint='Back Right Upper_Back Right Lower', strength=300.0, kind='torque'),
            Actuator(name='Hips_Back Left Upper', joint='Hips_Back Left Upper', strength=300.0, kind='torque'),
            Actuator(name='Back Left Upper_Back Left Lower', joint='Back Left Upper_Back Left Lower', strength=300.0, kind='torque'),
        ],
        friction=0.7745966911315918,
        gravity=(0.0, 0.0, -9.800000190734863),
        angular_damping=-0.05000000074505806,
        dt=0.019999999552965164,
        substeps=4,
        collide_include=[
            ('Front Right Lower', 'Ground'),
            ('Front Left Lower', 'Ground'),
            ('Back Right Lower', 'Ground'),
            ('Back Left Lower', 'Ground'),
        ],
    )
