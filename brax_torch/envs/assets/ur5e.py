"""Scene config for ur5e, as data.

A copy of `brax_tpu/envs/assets/ur5e.py`: `ur5e_config` (PBD), kept
here so that the port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def ur5e_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='floor',
                colliders=[
                    Collider(plane=Plane()),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
                frozen=FrozenAxes(all=True),
            ),
            Body(
                name='shoulder_link',
                colliders=[
                    Collider(capsule=Capsule(radius=0.05945208668708801, length=0.13365983963012695, end=0), position=(0.0, 0.06682991981506348, 0.0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='upper_arm_link',
                colliders=[
                    Collider(capsule=Capsule(radius=0.05968618765473366, length=0.5446449518203735, end=0), position=(0.0, 0.0, 0.21287038922309875)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='forearm_link',
                colliders=[
                    Collider(capsule=Capsule(radius=0.05584339052438736, length=0.48926496505737305, end=0), position=(0.0, 0.0, 0.1851803958415985)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='wrist_1_link',
                colliders=[
                    Collider(capsule=Capsule(radius=0.038744933903217316, length=0.10467606782913208, end=0), position=(0.0, 0.10467606782913208, 0.0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='wrist_2_link',
                colliders=[
                    Collider(capsule=Capsule(radius=0.03879201412200928, length=0.10468810051679611, end=0), position=(0.0, 0.0, 0.052344050258398056)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='wrist_3_link',
                colliders=[
                    Collider(capsule=Capsule(radius=0.01725015603005886, length=0.08051565289497375, end=0), position=(0.0, -0.04025782644748688, 0.0), rotation=(90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Target',
                colliders=[
                    Collider(sphere=Sphere(radius=0.10000000149011612)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
                frozen=FrozenAxes(all=True),
            ),
        ],
        joints=[
            Joint(
                name='shoulder_pan_joint',
                parent='floor',
                child='shoulder_link',
                parent_offset=(0.0, 0.0, 0.16300000250339508),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-360.0, 360.0)],
                angular_damping=50.0,
            ),
            Joint(
                name='shoulder_lift_joint',
                parent='shoulder_link',
                child='upper_arm_link',
                parent_offset=(0.0, 0.1379999965429306, 0.0),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-360.0, 360.0)],
                angular_damping=50.0,
            ),
            Joint(
                name='elbow_joint',
                parent='upper_arm_link',
                child='forearm_link',
                parent_offset=(0.0, -0.12999999523162842, 0.42500001192092896),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-360.0, 360.0)],
                angular_damping=50.0,
            ),
            Joint(
                name='wrist_1_joint',
                parent='forearm_link',
                child='wrist_1_link',
                parent_offset=(0.0, 0.0, 0.3919999897480011),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-360.0, 360.0)],
                angular_damping=50.0,
            ),
            Joint(
                name='wrist_2_joint',
                parent='wrist_1_link',
                child='wrist_2_link',
                parent_offset=(0.0, 0.12700000405311584, 0.0),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-360.0, 360.0)],
                angular_damping=50.0,
            ),
            Joint(
                name='wrist_3_joint',
                parent='wrist_2_link',
                child='wrist_3_link',
                parent_offset=(0.0, 0.0, 0.10000000149011612),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-360.0, 360.0)],
                angular_damping=50.0,
            ),
        ],
        actuators=[
            Actuator(name='shoulder_pan_joint', joint='shoulder_pan_joint', strength=100.0, kind='torque'),
            Actuator(name='shoulder_lift_joint', joint='shoulder_lift_joint', strength=100.0, kind='torque'),
            Actuator(name='elbow_joint', joint='elbow_joint', strength=100.0, kind='torque'),
            Actuator(name='wrist_1_joint', joint='wrist_1_joint', strength=100.0, kind='torque'),
            Actuator(name='wrist_2_joint', joint='wrist_2_joint', strength=100.0, kind='torque'),
            Actuator(name='wrist_3_joint', joint='wrist_3_joint', strength=100.0, kind='torque'),
        ],
        gravity=(0.0, 0.0, -9.8100004196167),
        angular_damping=-0.05000000074505806,
        dt=0.019999999552965164,
        substeps=8,
        collide_include=[
            ('', ''),
        ],
        dynamics_mode='pbd',
    )
