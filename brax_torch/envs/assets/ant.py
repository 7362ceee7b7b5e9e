"""Scene config for ant, as data.

A copy of `brax_tpu/envs/assets/ant.py::ant_config` (the PBD scene; the
legacy-spring variant is not ported yet), kept here so that the port imports
nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Capsule, Collider, Config, FrozenAxes, Joint, Plane,
)


def ant_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='$ Torso',
                colliders=[
                    Collider(capsule=Capsule(radius=0.25, length=0.5, end=1)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=10.0,
            ),
            Body(
                name='Aux 1',
                colliders=[
                    Collider(capsule=Capsule(radius=0.07999999821186066, length=0.4428427219390869, end=0), rotation=(90.0, -45.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='$ Body 4',
                colliders=[
                    Collider(capsule=Capsule(radius=0.07999999821186066, length=0.7256854176521301, end=-1), rotation=(90.0, -45.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Aux 2',
                colliders=[
                    Collider(capsule=Capsule(radius=0.07999999821186066, length=0.4428427219390869, end=0), rotation=(90.0, 45.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='$ Body 7',
                colliders=[
                    Collider(capsule=Capsule(radius=0.07999999821186066, length=0.7256854176521301, end=-1), rotation=(90.0, 45.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Aux 3',
                colliders=[
                    Collider(capsule=Capsule(radius=0.07999999821186066, length=0.4428427219390869, end=0), rotation=(-90.0, 45.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='$ Body 10',
                colliders=[
                    Collider(capsule=Capsule(radius=0.07999999821186066, length=0.7256854176521301, end=-1), rotation=(-90.0, 45.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Aux 4',
                colliders=[
                    Collider(capsule=Capsule(radius=0.07999999821186066, length=0.4428427219390869, end=0), rotation=(-90.0, -45.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='$ Body 13',
                colliders=[
                    Collider(capsule=Capsule(radius=0.07999999821186066, length=0.7256854176521301, end=-1), rotation=(-90.0, -45.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.0,
            ),
            Body(
                name='Ground',
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
                name='hip_1',
                parent='$ Torso',
                child='Aux 1',
                parent_offset=(0.20000000298023224, 0.20000000298023224, 0.0),
                child_offset=(-0.10000000149011612, -0.10000000149011612, 0.0),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-30.0, 30.0)],
                angular_damping=20.0,
            ),
            Joint(
                name='ankle_1',
                parent='Aux 1',
                child='$ Body 4',
                parent_offset=(0.10000000149011612, 0.10000000149011612, 0.0),
                child_offset=(-0.20000000298023224, -0.20000000298023224, 0.0),
                rotation=(0.0, 0.0, 135.0),
                angle_limits=[(30.0, 70.0)],
                angular_damping=20.0,
            ),
            Joint(
                name='hip_2',
                parent='$ Torso',
                child='Aux 2',
                parent_offset=(-0.20000000298023224, 0.20000000298023224, 0.0),
                child_offset=(0.10000000149011612, -0.10000000149011612, 0.0),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-30.0, 30.0)],
                angular_damping=20.0,
            ),
            Joint(
                name='ankle_2',
                parent='Aux 2',
                child='$ Body 7',
                parent_offset=(-0.10000000149011612, 0.10000000149011612, 0.0),
                child_offset=(0.20000000298023224, -0.20000000298023224, 0.0),
                rotation=(0.0, 0.0, 45.0),
                angle_limits=[(-70.0, -30.0)],
                angular_damping=20.0,
            ),
            Joint(
                name='hip_3',
                parent='$ Torso',
                child='Aux 3',
                parent_offset=(-0.20000000298023224, -0.20000000298023224, 0.0),
                child_offset=(0.10000000149011612, 0.10000000149011612, 0.0),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-30.0, 30.0)],
                angular_damping=20.0,
            ),
            Joint(
                name='ankle_3',
                parent='Aux 3',
                child='$ Body 10',
                parent_offset=(-0.10000000149011612, -0.10000000149011612, 0.0),
                child_offset=(0.20000000298023224, 0.20000000298023224, 0.0),
                rotation=(0.0, 0.0, 135.0),
                angle_limits=[(-70.0, -30.0)],
                angular_damping=20.0,
            ),
            Joint(
                name='hip_4',
                parent='$ Torso',
                child='Aux 4',
                parent_offset=(0.20000000298023224, -0.20000000298023224, 0.0),
                child_offset=(-0.10000000149011612, 0.10000000149011612, 0.0),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-30.0, 30.0)],
                angular_damping=20.0,
            ),
            Joint(
                name='ankle_4',
                parent='Aux 4',
                child='$ Body 13',
                parent_offset=(0.10000000149011612, -0.10000000149011612, 0.0),
                child_offset=(-0.20000000298023224, 0.20000000298023224, 0.0),
                rotation=(0.0, 0.0, 45.0),
                angle_limits=[(30.0, 70.0)],
                angular_damping=20.0,
            ),
        ],
        actuators=[
            Actuator(name='hip_1', joint='hip_1', strength=350.0, kind='torque'),
            Actuator(name='ankle_1', joint='ankle_1', strength=350.0, kind='torque'),
            Actuator(name='hip_2', joint='hip_2', strength=350.0, kind='torque'),
            Actuator(name='ankle_2', joint='ankle_2', strength=350.0, kind='torque'),
            Actuator(name='hip_3', joint='hip_3', strength=350.0, kind='torque'),
            Actuator(name='ankle_3', joint='ankle_3', strength=350.0, kind='torque'),
            Actuator(name='hip_4', joint='hip_4', strength=350.0, kind='torque'),
            Actuator(name='ankle_4', joint='ankle_4', strength=350.0, kind='torque'),
        ],
        friction=1.0,
        gravity=(0.0, 0.0, -9.800000190734863),
        angular_damping=-0.05000000074505806,
        dt=0.05000000074505806,
        substeps=10,
        collide_include=[
            ('$ Torso', 'Ground'),
            ('$ Body 4', 'Ground'),
            ('$ Body 7', 'Ground'),
            ('$ Body 10', 'Ground'),
            ('$ Body 13', 'Ground'),
        ],
        dynamics_mode='pbd',
    )
