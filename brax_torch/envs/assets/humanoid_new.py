"""Scene config for the fork's humanoid (humanoid_new), as data.

A copy of `brax_tpu/envs/assets/humanoid_new.py::humanoid_new_config` (PBD),
kept here so that the port imports nothing of `brax_tpu`.
"""

from brax_torch.sim.config import (
    Actuator, Body, Box, Capsule, ClippedPlane, Collider, Config, DefaultAngle,
    DefaultQP, Defaults, Force, FrozenAxes, HeightMap, Joint, Material,
    MeshGeometry, MeshRef, Plane, Sphere,
)


def humanoid_new_config() -> Config:
    return Config(
        bodies=[
            Body(
                name='torso',
                colliders=[
                    Collider(capsule=Capsule(radius=0.07000000029802322, length=0.2800000011920929, end=0), rotation=(-90.0, 0.0, 0.0)),
                    Collider(capsule=Capsule(radius=0.09000000357627869, length=0.18000000715255737, end=0), position=(0.0, 0.0, 0.1899999976158142)),
                    Collider(capsule=Capsule(radius=0.05999999865889549, length=0.23999999463558197, end=0), position=(-0.009999999776482582, 0.0, -0.11999999731779099), rotation=(-90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=8.907463073730469,
            ),
            Body(
                name='lwaist',
                colliders=[
                    Collider(capsule=Capsule(radius=0.05999999865889549, length=0.23999999463558197, end=0), rotation=(-90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=2.261946678161621,
            ),
            Body(
                name='pelvis',
                colliders=[
                    Collider(capsule=Capsule(radius=0.09000000357627869, length=0.3199999928474426, end=0), position=(-0.019999999552965164, 0.0, 0.0), rotation=(-90.0, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=6.616194248199463,
            ),
            Body(
                name='right_thigh',
                colliders=[
                    Collider(capsule=Capsule(radius=0.05999999865889549, length=0.46014702320098877, end=0), position=(0.0, 0.004999999888241291, -0.17000000178813934), rotation=(-178.31532287597656, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=4.751750946044922,
            ),
            Body(
                name='right_shin',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04899999871850014, length=0.39800000190734863, end=-1), position=(0.0, 0.0, -0.15000000596046448), rotation=(-180.0, 0.0, 0.0)),
                    Collider(capsule=Capsule(radius=0.07500000298023224, length=0.15000000596046448, end=1), position=(0.0, 0.0, -0.3499999940395355)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=4.522841930389404,
            ),
            Body(
                name='left_thigh',
                colliders=[
                    Collider(capsule=Capsule(radius=0.05999999865889549, length=0.46014702320098877, end=0), position=(0.0, -0.004999999888241291, -0.17000000178813934), rotation=(178.31532287597656, 0.0, 0.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=4.751750946044922,
            ),
            Body(
                name='left_shin',
                colliders=[
                    Collider(capsule=Capsule(radius=0.04899999871850014, length=0.39800000190734863, end=-1), position=(0.0, 0.0, -0.15000000596046448), rotation=(-180.0, 0.0, 0.0)),
                    Collider(capsule=Capsule(radius=0.07500000298023224, length=0.15000000596046448, end=1), position=(0.0, 0.0, -0.3499999940395355)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=4.522841930389404,
            ),
            Body(
                name='right_upper_arm',
                colliders=[
                    Collider(capsule=Capsule(radius=0.03999999910593033, length=0.3571281433105469, end=0), position=(0.07999999821186066, -0.07999999821186066, -0.07999999821186066), rotation=(135.0, 35.26438903808594, -75.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.6610804796218872,
            ),
            Body(
                name='right_lower_arm',
                colliders=[
                    Collider(capsule=Capsule(radius=0.03099999949336052, length=0.33912813663482666, end=0), position=(0.09000000357627869, 0.09000000357627869, 0.09000000357627869), rotation=(-45.0, 35.26438903808594, 15.0)),
                    Collider(capsule=Capsule(radius=0.03999999910593033, length=0.07999999821186066, end=0), position=(0.18000000715255737, 0.18000000715255737, 0.18000000715255737)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.229540228843689,
            ),
            Body(
                name='left_upper_arm',
                colliders=[
                    Collider(capsule=Capsule(radius=0.03999999910593033, length=0.3571281433105469, end=0), position=(0.07999999821186066, 0.07999999821186066, -0.07999999821186066), rotation=(-135.0, 35.26438903808594, 75.0)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.6610804796218872,
            ),
            Body(
                name='left_lower_arm',
                colliders=[
                    Collider(capsule=Capsule(radius=0.03099999949336052, length=0.33912813663482666, end=0), position=(0.09000000357627869, -0.09000000357627869, 0.09000000357627869), rotation=(45.0, 35.26438903808594, -15.0)),
                    Collider(capsule=Capsule(radius=0.03999999910593033, length=0.07999999821186066, end=0), position=(0.18000000715255737, -0.18000000715255737, 0.18000000715255737)),
                ],
                inertia=(1.0, 1.0, 1.0),
                mass=1.229540228843689,
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
                name='abdomen_yz',
                parent='torso',
                child='lwaist',
                parent_offset=(-0.009999999776482582, 0.0, -0.19499999284744263),
                child_offset=(0.0, 0.0, 0.06499999761581421),
                rotation=(0.0, -90.0, 0.0),
                angle_limits=[(-45.0, 45.0), (-65.0, 30.0)],
                angular_damping=30.0,
            ),
            Joint(
                name='abdomen_x',
                parent='lwaist',
                child='pelvis',
                parent_offset=(0.0, 0.0, -0.06499999761581421),
                child_offset=(0.0, 0.0, 0.10000000149011612),
                rotation=(90.0, 0.0, 0.0),
                angle_limits=[(-35.0, 35.0)],
                angular_damping=30.0,
            ),
            Joint(
                name='right_hip_xyz',
                parent='pelvis',
                child='right_thigh',
                parent_offset=(0.0, -0.10000000149011612, -0.03999999910593033),
                angle_limits=[(-10.0, 10.0), (-30.0, 70.0), (-10.0, 10.0)],
                angular_damping=30.0,
            ),
            Joint(
                name='right_knee',
                parent='right_thigh',
                child='right_shin',
                parent_offset=(0.0, 0.009999999776482582, -0.382999986410141),
                child_offset=(0.0, 0.0, 0.019999999552965164),
                rotation=(0.0, 0.0, -90.0),
                angle_limits=[(-160.0, -2.0)],
                angular_damping=30.0,
            ),
            Joint(
                name='left_hip_xyz',
                parent='pelvis',
                child='left_thigh',
                parent_offset=(0.0, 0.10000000149011612, -0.03999999910593033),
                angle_limits=[(-10.0, 10.0), (-30.0, 70.0), (-10.0, 10.0)],
                angular_damping=30.0,
            ),
            Joint(
                name='left_knee',
                parent='left_thigh',
                child='left_shin',
                parent_offset=(0.0, -0.009999999776482582, -0.382999986410141),
                child_offset=(0.0, 0.0, 0.019999999552965164),
                rotation=(0.0, 0.0, -90.0),
                angle_limits=[(-160.0, -2.0)],
                angular_damping=30.0,
            ),
            Joint(
                name='right_shoulder12',
                parent='torso',
                child='right_upper_arm',
                parent_offset=(0.0, -0.17000000178813934, 0.05999999865889549),
                rotation=(135.0, 35.26438903808594, 0.0),
                angle_limits=[(-85.0, 60.0), (-70.0, 50.0)],
                angular_damping=30.0,
            ),
            Joint(
                name='right_elbow',
                parent='right_upper_arm',
                child='right_lower_arm',
                parent_offset=(0.18000000715255737, -0.18000000715255737, -0.18000000715255737),
                rotation=(135.0, 0.0, 90.0),
                angle_limits=[(-90.0, 50.0)],
                angular_damping=30.0,
            ),
            Joint(
                name='left_shoulder12',
                parent='torso',
                child='left_upper_arm',
                parent_offset=(0.0, 0.17000000178813934, 0.05999999865889549),
                rotation=(45.0, -35.26438903808594, 0.0),
                angle_limits=[(-60.0, 85.0), (-50.0, 70.0)],
                angular_damping=30.0,
            ),
            Joint(
                name='left_elbow',
                parent='left_upper_arm',
                child='left_lower_arm',
                parent_offset=(0.18000000715255737, 0.18000000715255737, -0.18000000715255737),
                rotation=(45.0, 0.0, -90.0),
                angle_limits=[(-90.0, 50.0)],
                angular_damping=30.0,
            ),
        ],
        actuators=[
            Actuator(name='abdomen_yz', joint='abdomen_yz', strength=350.0, kind='torque'),
            Actuator(name='abdomen_x', joint='abdomen_x', strength=350.0, kind='torque'),
            Actuator(name='right_hip_xyz', joint='right_hip_xyz', strength=350.0, kind='torque'),
            Actuator(name='right_knee', joint='right_knee', strength=350.0, kind='torque'),
            Actuator(name='left_hip_xyz', joint='left_hip_xyz', strength=350.0, kind='torque'),
            Actuator(name='left_knee', joint='left_knee', strength=350.0, kind='torque'),
            Actuator(name='right_shoulder12', joint='right_shoulder12', strength=100.0, kind='torque'),
            Actuator(name='right_elbow', joint='right_elbow', strength=100.0, kind='torque'),
            Actuator(name='left_shoulder12', joint='left_shoulder12', strength=100.0, kind='torque'),
            Actuator(name='left_elbow', joint='left_elbow', strength=100.0, kind='torque'),
        ],
        friction=1.0,
        gravity=(0.0, 0.0, -9.8100004196167),
        angular_damping=-0.05000000074505806,
        dt=0.014999999664723873,
        substeps=8,
        collide_include=[
            ('floor', 'left_shin'),
            ('floor', 'right_shin'),
        ],
        defaults=[
            Defaults(
                angles=[
                    DefaultAngle(name='left_knee', angle=(-25.0, 0.0, 0.0)),
                    DefaultAngle(name='right_knee', angle=(-25.0, 0.0, 0.0)),
                ],
            ),
        ],
        dynamics_mode='pbd',
    )
