"""Scene configs for halfcheetah, as data.

A copy of `brax_tpu/envs/assets/half_cheetah.py`: `halfcheetah_config`
(PBD) and `halfcheetah_config_spring` (legacy spring), kept here so that the
port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def halfcheetah_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='torso',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=1.0920000076293945, end=0), rotation=(0.0, 90.0, 0.0)),
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.3919999897480011, end=0), position=(0.6000000238418579, 0.0, 0.10000000149011612), rotation=(0.0, 49.847328186035156, 0.0)),
                ],
                inertia=(0.9447969794273376, 0.9447969794273376, 0.9447969794273376),
                mass=9.457332611083984,
            ),
            Body(
                name='bthigh',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.38199999928474426, end=0), position=(0.10000000149011612, 0.0, -0.12999999523162842), rotation=(-180.0, 37.723960876464844, -180.0)),
                ],
                inertia=(0.029636280611157417, 0.029636280611157417, 0.029636280611157417),
                mass=2.335526943206787,
            ),
            Body(
                name='bshin',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.3919999897480011, end=0), position=(-0.14000000059604645, 0.0, -0.07000000029802322), rotation=(180.0, -63.68956756591797, 180.0)),
                ],
                inertia=(0.032029107213020325, 0.032029107213020325, 0.032029107213020325),
                mass=2.402003049850464,
            ),
            Body(
                name='bfoot',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.2800000011920929, end=0), position=(0.029999999329447746, 0.0, -0.09700000286102295), rotation=(0.0, -15.469860076904297, 0.0)),
                ],
                inertia=(0.0117056118324399, 0.0117056118324399, 0.0117056118324399),
                mass=1.6574708223342896,
            ),
            Body(
                name='fthigh',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.3580000102519989, end=0), position=(-0.07000000029802322, 0.0, -0.11999999731779099), rotation=(0.0, 29.793806076049805, 0.0)),
                ],
                inertia=(0.024391336366534233, 0.024391336366534233, 0.024391336366534233),
                mass=2.1759843826293945,
            ),
            Body(
                name='fshin',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.30399999022483826, end=0), position=(0.06499999761581421, 0.0, -0.09000000357627869), rotation=(0.0, -34.37746810913086, 0.0)),
                ],
                inertia=(0.014954624697566032, 0.014954624697566032, 0.014954624697566032),
                mass=1.8170133829116821,
            ),
            Body(
                name='ffoot',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.23199999332427979, end=0), position=(0.04500000178813934, 0.0, -0.07000000029802322), rotation=(0.0, -34.37746810913086, 0.0)),
                ],
                inertia=(0.006711110472679138, 0.006711110472679138, 0.006711110472679138),
                mass=1.3383854627609253,
            ),
            Body(
                name='floor',
                colliders=[
                    Collider(plane=Plane()),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.0,
                frozen=FrozenAxes(position=(1.0, 1.0, 1.0), rotation=(1.0, 1.0, 1.0)),
            ),
        ],
        joints=[
            Joint(
                name='bthigh',
                parent='torso',
                child='bthigh',
                parent_offset=(-0.5, 0.0, 0.0),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-29.793806076049805, 60.16056823730469)],
            ),
            Joint(
                name='bshin',
                parent='bthigh',
                child='bshin',
                parent_offset=(0.1599999964237213, 0.0, -0.25),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-44.97718811035156, 44.97718811035156)],
            ),
            Joint(
                name='bfoot',
                parent='bshin',
                child='bfoot',
                parent_offset=(-0.2800000011920929, 0.0, -0.14000000059604645),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-22.918312072753906, 44.97718811035156)],
            ),
            Joint(
                name='fthigh',
                parent='torso',
                child='fthigh',
                parent_offset=(0.5, 0.0, 0.0),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-57.295780181884766, 40.1070442199707)],
            ),
            Joint(
                name='fshin',
                parent='fthigh',
                child='fshin',
                parent_offset=(-0.14000000059604645, 0.0, -0.23999999463558197),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-68.75493621826172, 49.847328186035156)],
            ),
            Joint(
                name='ffoot',
                parent='fshin',
                child='ffoot',
                parent_offset=(0.12999999523162842, 0.0, -0.18000000715255737),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-28.647890090942383, 28.647890090942383)],
            ),
        ],
        actuators=[
            Actuator(name='bthigh', joint='bthigh', strength=120.0, kind='torque'),
            Actuator(name='bshin', joint='bshin', strength=90.0, kind='torque'),
            Actuator(name='bfoot', joint='bfoot', strength=60.0, kind='torque'),
            Actuator(name='fthigh', joint='fthigh', strength=120.0, kind='torque'),
            Actuator(name='fshin', joint='fshin', strength=60.0, kind='torque'),
            Actuator(name='ffoot', joint='ffoot', strength=30.0, kind='torque'),
        ],
        friction=0.7745966911315918,
        gravity=(0.0, 0.0, -9.8100004196167),
        angular_damping=-0.009999999776482582,
        dt=0.05000000074505806,
        substeps=16,
        frozen=FrozenAxes(position=(0.0, 1.0, 0.0), rotation=(1.0, 0.0, 1.0)),
        collide_include=[
            ('floor', 'torso'),
            ('floor', 'bfoot'),
            ('floor', 'ffoot'),
            ('floor', 'bthigh'),
            ('floor', 'fthigh'),
            ('floor', 'bshin'),
            ('floor', 'fshin'),
            ('bfoot', 'ffoot'),
        ],
        dynamics_mode='pbd',
    )

def halfcheetah_config_spring() -> Config:
    return Config(
        bodies=[
            Body(
                name='torso',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=1.0920000076293945, end=0), rotation=(0.0, 90.0, 0.0)),
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.3919999897480011, end=0), position=(0.6000000238418579, 0.0, 0.10000000149011612), rotation=(0.0, 49.847328186035156, 0.0)),
                ],
                inertia=(0.9447969794273376, 0.9447969794273376, 0.9447969794273376),
                mass=9.457332611083984,
            ),
            Body(
                name='bthigh',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.38199999928474426, end=0), position=(0.10000000149011612, 0.0, -0.12999999523162842), rotation=(-180.0, 37.723960876464844, -180.0)),
                ],
                inertia=(0.029636280611157417, 0.029636280611157417, 0.029636280611157417),
                mass=2.335526943206787,
            ),
            Body(
                name='bshin',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.3919999897480011, end=0), position=(-0.14000000059604645, 0.0, -0.07000000029802322), rotation=(180.0, -63.68956756591797, 180.0)),
                ],
                inertia=(0.032029107213020325, 0.032029107213020325, 0.032029107213020325),
                mass=2.402003049850464,
            ),
            Body(
                name='bfoot',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.2800000011920929, end=0), position=(0.029999999329447746, 0.0, -0.09700000286102295), rotation=(0.0, -15.469860076904297, 0.0)),
                ],
                inertia=(0.0117056118324399, 0.0117056118324399, 0.0117056118324399),
                mass=1.6574708223342896,
            ),
            Body(
                name='fthigh',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.3580000102519989, end=0), position=(-0.07000000029802322, 0.0, -0.11999999731779099), rotation=(0.0, 29.793806076049805, 0.0)),
                ],
                inertia=(0.024391336366534233, 0.024391336366534233, 0.024391336366534233),
                mass=2.1759843826293945,
            ),
            Body(
                name='fshin',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.30399999022483826, end=0), position=(0.06499999761581421, 0.0, -0.09000000357627869), rotation=(0.0, -34.37746810913086, 0.0)),
                ],
                inertia=(0.014954624697566032, 0.014954624697566032, 0.014954624697566032),
                mass=1.8170133829116821,
            ),
            Body(
                name='ffoot',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04600000008940697, length=0.23199999332427979, end=0), position=(0.04500000178813934, 0.0, -0.07000000029802322), rotation=(0.0, -34.37746810913086, 0.0)),
                ],
                inertia=(0.006711110472679138, 0.006711110472679138, 0.006711110472679138),
                mass=1.3383854627609253,
            ),
            Body(
                name='floor',
                colliders=[
                    Collider(plane=Plane()),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=0.0,
                frozen=FrozenAxes(position=(1.0, 1.0, 1.0), rotation=(1.0, 1.0, 1.0)),
            ),
        ],
        joints=[
            Joint(
                name='bthigh',
                parent='torso',
                child='bthigh',
                parent_offset=(-0.5, 0.0, 0.0),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-29.793806076049805, 60.16056823730469)],
                stiffness=25000.0,
                spring_damping=60.0,
                limit_strength=1000.0,
            ),
            Joint(
                name='bshin',
                parent='bthigh',
                child='bshin',
                parent_offset=(0.1599999964237213, 0.0, -0.25),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-44.97718811035156, 44.97718811035156)],
                stiffness=25000.0,
                spring_damping=60.0,
                limit_strength=1000.0,
            ),
            Joint(
                name='bfoot',
                parent='bshin',
                child='bfoot',
                parent_offset=(-0.2800000011920929, 0.0, -0.14000000059604645),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-22.918312072753906, 44.97718811035156)],
                stiffness=25000.0,
                spring_damping=60.0,
                limit_strength=1000.0,
            ),
            Joint(
                name='fthigh',
                parent='torso',
                child='fthigh',
                parent_offset=(0.5, 0.0, 0.0),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-57.295780181884766, 40.1070442199707)],
                stiffness=25000.0,
                spring_damping=60.0,
                limit_strength=1000.0,
            ),
            Joint(
                name='fshin',
                parent='fthigh',
                child='fshin',
                parent_offset=(-0.14000000059604645, 0.0, -0.23999999463558197),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-68.75493621826172, 49.847328186035156)],
                stiffness=25000.0,
                spring_damping=80.0,
                limit_strength=1000.0,
            ),
            Joint(
                name='ffoot',
                parent='fshin',
                child='ffoot',
                parent_offset=(0.12999999523162842, 0.0, -0.18000000715255737),
                rotation=(0.0, 0.0, 90.0),
                angle_limits=[(-28.647890090942383, 28.647890090942383)],
                stiffness=25000.0,
                spring_damping=50.0,
                limit_strength=1000.0,
            ),
        ],
        actuators=[
            Actuator(name='bthigh', joint='bthigh', strength=120.0, kind='torque'),
            Actuator(name='bshin', joint='bshin', strength=90.0, kind='torque'),
            Actuator(name='bfoot', joint='bfoot', strength=60.0, kind='torque'),
            Actuator(name='fthigh', joint='fthigh', strength=120.0, kind='torque'),
            Actuator(name='fshin', joint='fshin', strength=60.0, kind='torque'),
            Actuator(name='ffoot', joint='ffoot', strength=30.0, kind='torque'),
        ],
        friction=0.7745966911315918,
        gravity=(0.0, 0.0, -9.8100004196167),
        angular_damping=-0.009999999776482582,
        baumgarte_erp=0.20000000298023224,
        dt=0.05000000074505806,
        substeps=16,
        frozen=FrozenAxes(position=(0.0, 1.0, 0.0), rotation=(1.0, 0.0, 1.0)),
        collide_include=[
            ('floor', 'torso'),
            ('floor', 'bfoot'),
            ('floor', 'ffoot'),
            ('floor', 'bthigh'),
            ('floor', 'fthigh'),
            ('floor', 'bshin'),
            ('floor', 'fshin'),
            ('bfoot', 'ffoot'),
        ],
        dynamics_mode='legacy_spring',
    )
