"""Scene config for hopper, as data.

A copy of `brax_tpu/envs/assets/hopper.py`: `hopper_config` (PBD), kept
here so that the port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def hopper_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='torso',
                colliders=[
                    Collider(capsule=Capsule(radius=0.05000000074505806, length=0.5, end=0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=3.665191411972046,
            ),
            Body(
                name='thigh',
                colliders=[
                    Collider(capsule=Capsule(radius=0.05000000074505806, length=0.550000011920929, end=0), position=(0.0, 0.0, -0.22499999403953552)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=4.05789041519165,
            ),
            Body(
                name='leg',
                colliders=[
                    Collider(capsule=Capsule(radius=0.03999999910593033, length=0.5799999833106995, end=0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=2.7813568115234375,
            ),
            Body(
                name='foot',
                colliders=[
                    Collider(capsule=Capsule(radius=0.05999999865889549, length=0.5099999904632568, end=0), position=(-0.06499999761581421, -0.12999999523162842, -0.029999999329447746), rotation=(0.0, 90.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=5.315574645996094,
            ),
            Body(
                name='floor',
                colliders=[
                    Collider(plane=Plane()),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.0,
                frozen=FrozenAxes(all=True),
            ),
        ],
        joints=[
            Joint(
                name='thigh_joint',
                parent='torso',
                child='thigh',
                parent_offset=(0.0, 0.0, -0.20000000298023224),
                rotation=(0.0, 0.0, -90.0),
                angle_limits=[(-150.0, 0.0)],
            ),
            Joint(
                name='leg_joint',
                parent='thigh',
                child='leg',
                parent_offset=(0.0, 0.0, -0.44999998807907104),
                child_offset=(0.0, 0.0, 0.25),
                rotation=(0.0, 0.0, -90.0),
                angle_limits=[(-150.0, 0.0)],
            ),
            Joint(
                name='foot_joint',
                parent='leg',
                child='foot',
                parent_offset=(0.0, 0.0, -0.25),
                child_offset=(-0.12999999523162842, -0.12999999523162842, -0.029999999329447746),
                rotation=(0.0, 0.0, -90.0),
                angle_limits=[(-45.0, 45.0)],
            ),
        ],
        actuators=[
            Actuator(name='thigh_joint', joint='thigh_joint', strength=200.0, kind='torque'),
            Actuator(name='leg_joint', joint='leg_joint', strength=200.0, kind='torque'),
            Actuator(name='foot_joint', joint='foot_joint', strength=200.0, kind='torque'),
        ],
        friction=0.9486833214759827,
        gravity=(0.0, 0.0, -9.8100004196167),
        velocity_damping=1.0,
        angular_damping=-0.05000000074505806,
        dt=0.00800000037997961,
        substeps=4,
        frozen=FrozenAxes(position=(0.0, 1.0, 0.0), rotation=(1.0, 0.0, 1.0)),
        collide_include=[
            ('floor', 'torso'),
            ('floor', 'thigh'),
            ('floor', 'leg'),
            ('floor', 'foot'),
        ],
        defaults=[
            Defaults(
                angles=[
                    DefaultAngle(name='thigh_joint', angle=(0.0, 0.0, 0.0)),
                    DefaultAngle(name='leg_joint', angle=(0.0, 0.0, 0.0)),
                ],
                qps=[
                    DefaultQP(name='torso', pos=(0.0, 0.0, 1.25)),
                ],
            ),
        ],
        dynamics_mode='pbd',
    )
