"""Programmatic MJCF scene builders for the v2 environment suite.

A copy of brax_tpu/v2/envs/assets.py (numpy-free, stdlib only).

Scenes are emitted as MJCF strings from compact Python descriptions instead
of shipping XML files: the geometry/joint content matches the classic MuJoCo
tasks (reference brax/v2/envs/assets/*.xml) while staying data-as-code, and
doubles as a test of the native MJCF compiler's authoring path.
"""

from __future__ import annotations

import math
from typing import List


def ant_xml() -> str:
    """Quadruped: free torso + 4 legs x (hip, ankle) hinges, foot spheres."""
    # per leg: (name suffix, xy direction sign pair, ankle range)
    legs = [
        ("1", (1, 1), "30 70"),
        ("2", (-1, 1), "-70 -30"),
        ("3", (-1, -1), "-70 -30"),
        ("4", (1, -1), "30 70"),
    ]
    body = []
    feet = []
    for i, (sfx, (sx, sy), ankle_range) in enumerate(legs):
        dx, dy = 0.2 * sx, 0.2 * sy
        ax, ay = 0.4 * sx, 0.4 * sy
        # hinge axis perpendicular to the leg direction, in-plane
        ankle_axis = f"{-sy} {sx} 0"
        feet.append(f"foot_{sfx}_geom")
        body.append(
            f"""
      <body name="leg_{sfx}" pos="0 0 0">
        <geom fromto="0 0 0 {dx} {dy} 0" name="aux_{sfx}_geom" size="0.08" type="capsule"/>
        <body name="aux_{sfx}" pos="{dx} {dy} 0">
          <joint axis="0 0 1" name="hip_{sfx}" pos="0 0 0" range="-30 30" type="hinge"/>
          <geom fromto="0 0 0 {dx} {dy} 0" name="leg_{sfx}_geom" size="0.08" type="capsule"/>
          <body pos="{dx} {dy} 0" name="lower_{sfx}">
            <joint axis="{ankle_axis}" name="ankle_{sfx}" pos="0 0 0" range="{ankle_range}" type="hinge"/>
            <geom fromto="0 0 0 {ax} {ay} 0" name="ankle_{sfx}_geom" size="0.08" type="capsule"/>
            <geom name="foot_{sfx}_geom" pos="{ax} {ay} 0" size="0.08" type="sphere" mass="0"/>
          </body>
        </body>
      </body>"""
        )

    motors = "\n".join(
        f'    <motor ctrllimited="true" ctrlrange="-1.0 1.0" joint="{j}_{s}" gear="150"/>'
        for s, _, _ in legs
        for j in ("hip", "ankle")
    )
    pairs = "\n".join(
        f'    <pair geom1="floor" geom2="{f}"/>' for f in feet
    )
    init_q = "0.0 0.0 0.55 1.0 0.0 0.0 0.0 0.0 1.0 0.0 -1.0 0.0 -1.0 0.0 1.0"
    return f"""
<mujoco model="ant">
  <compiler angle="degree" inertiafromgeom="true"/>
  <option timestep="0.01" collision="predefined" iterations="4"/>
  <custom>
    <numeric data="{init_q}" name="init_qpos"/>
  </custom>
  <default>
    <joint armature="1" damping="1" limited="true"/>
    <geom density="5.0" friction="1 0.5 0.5"/>
  </default>
  <worldbody>
    <geom name="floor" pos="0 0 0" size="40 40 40" type="plane"/>
    <body name="torso" pos="0 0 0.75">
      <geom name="torso_geom" pos="0 0 0" size="0.25" type="sphere"/>
      <joint armature="0" damping="0" limited="false" name="root" pos="0 0 0" type="free"/>
      {''.join(body)}
    </body>
  </worldbody>
  <actuator>
{motors}
  </actuator>
  <contact>
{pairs}
  </contact>
</mujoco>
"""


def inverted_pendulum_xml() -> str:
    """Cart (slide) + pole (hinge)."""
    return """
<mujoco model="inverted pendulum">
  <compiler angle="radian" inertiafromgeom="true"/>
  <option gravity="0 0 -9.81" timestep="0.02" iterations="4" collision="predefined"/>
  <default>
    <joint armature="0" damping="1" limited="true"/>
    <geom friction="1 0.1 0.1"/>
  </default>
  <worldbody>
    <body name="cart" pos="0 0 0">
      <joint axis="1 0 0" limited="true" name="slider" pos="0 0 0" range="-1 1" type="slide"/>
      <geom name="cart_geom" fromto="-0.1 0 0 0.1 0 0" size="0.1" type="capsule"/>
      <body name="pole" pos="0 0 0">
        <joint axis="0 1 0" name="hinge" pos="0 0 0" range="-0.2 0.2" type="hinge"/>
        <geom fromto="0 0 0 0.001 0 0.6" name="pole_geom" size="0.049" type="capsule"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor ctrllimited="true" ctrlrange="-3 3" gear="100" joint="slider"/>
  </actuator>
</mujoco>
"""


def inverted_double_pendulum_xml() -> str:
    """Cart + two stacked poles."""
    return """
<mujoco model="inverted double pendulum">
  <compiler angle="radian" inertiafromgeom="true"/>
  <option gravity="0 0 -9.81" timestep="0.01" iterations="4" collision="predefined"/>
  <default>
    <joint armature="0" damping="0.05" limited="false"/>
    <geom friction="1 0.1 0.1"/>
  </default>
  <worldbody>
    <body name="cart" pos="0 0 0">
      <joint axis="1 0 0" limited="true" name="slider" pos="0 0 0" range="-1 1" type="slide"/>
      <geom name="cart_geom" fromto="-0.1 0 0 0.1 0 0" size="0.1" type="capsule"/>
      <body name="pole" pos="0 0 0">
        <joint axis="0 1 0" name="hinge" pos="0 0 0" type="hinge"/>
        <geom fromto="0 0 0 0 0 0.6" name="pole_geom" size="0.049" type="capsule"/>
        <body name="pole2" pos="0 0 0.6">
          <joint axis="0 1 0" name="hinge2" pos="0 0 0" type="hinge"/>
          <geom fromto="0 0 0 0 0 0.6" name="pole2_geom" size="0.049" type="capsule"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="500" joint="slider"/>
  </actuator>
</mujoco>
"""


def humanoid_xml() -> str:
    """Classic 17-dof humanoid: free torso, 2-dof abdomen, 3-dof hips,
    knees, 2-dof shoulders, elbows."""
    return """
<mujoco model="humanoid">
  <compiler angle="degree" inertiafromgeom="true"/>
  <option timestep="0.003" iterations="6" collision="predefined"/>
  <custom>
    <numeric data="0.0 0.0 1.4 1.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0" name="init_qpos"/>
  </custom>
  <default>
    <joint armature="1" damping="1" limited="true"/>
    <geom friction="1 0.1 0.1"/>
    <motor ctrllimited="true" ctrlrange="-0.4 0.4"/>
  </default>
  <worldbody>
    <geom name="floor" pos="0 0 0" size="40 40 40" type="plane"/>
    <body name="torso" pos="0 0 1.4">
      <joint armature="0" damping="0" limited="false" name="root" pos="0 0 0" type="free"/>
      <geom fromto="0 -.07 0 0 .07 0" name="torso1" size="0.07" type="capsule"/>
      <geom name="head" pos="0 0 .19" size=".09" type="sphere"/>
      <geom fromto="-.01 -.06 -.12 -.01 .06 -.12" name="uwaist" size="0.06" type="capsule"/>
      <body name="lwaist" pos="-.01 0 -0.260">
        <geom fromto="0 -.06 0 0 .06 0" name="lwaist_geom" size="0.06" type="capsule"/>
        <joint armature="0.02" axis="0 0 1" damping="5" name="abdomen_z" pos="0 0 0.065" range="-45 45" stiffness="20" type="hinge"/>
        <joint armature="0.02" axis="0 1 0" damping="5" name="abdomen_y" pos="0 0 0.065" range="-75 30" stiffness="10" type="hinge"/>
        <body name="pelvis" pos="0 0 -0.165">
          <joint armature="0.02" axis="1 0 0" damping="5" name="abdomen_x" pos="0 0 0.1" range="-35 35" stiffness="10" type="hinge"/>
          <geom fromto="-.02 -.07 0 -.02 .07 0" name="butt" size="0.09" type="capsule"/>
          <body name="right_thigh" pos="0 -0.1 -0.04">
            <joint armature="0.01" axis="1 0 0" damping="5" name="right_hip_x" pos="0 0 0" range="-25 5" stiffness="10" type="hinge"/>
            <joint armature="0.01" axis="0 0 1" damping="5" name="right_hip_z" pos="0 0 0" range="-60 35" stiffness="10" type="hinge"/>
            <joint armature="0.0080" axis="0 1 0" damping="5" name="right_hip_y" pos="0 0 0" range="-110 20" stiffness="20" type="hinge"/>
            <geom fromto="0 0 0 0 0.01 -.34" name="right_thigh1" size="0.06" type="capsule"/>
            <body name="right_shin" pos="0 0.01 -0.403">
              <joint armature="0.0060" axis="0 -1 0" name="right_knee" pos="0 0 .02" range="-160 -2" type="hinge"/>
              <geom fromto="0 0 0 0 0 -.3" name="right_shin1" size="0.049" type="capsule"/>
              <geom name="right_foot" pos="0 0 -0.35" size="0.075" type="sphere"/>
            </body>
          </body>
          <body name="left_thigh" pos="0 0.1 -0.04">
            <joint armature="0.01" axis="-1 0 0" damping="5" name="left_hip_x" pos="0 0 0" range="-25 5" stiffness="10" type="hinge"/>
            <joint armature="0.01" axis="0 0 -1" damping="5" name="left_hip_z" pos="0 0 0" range="-60 35" stiffness="10" type="hinge"/>
            <joint armature="0.01" axis="0 1 0" damping="5" name="left_hip_y" pos="0 0 0" range="-110 20" stiffness="20" type="hinge"/>
            <geom fromto="0 0 0 0 -0.01 -.34" name="left_thigh1" size="0.06" type="capsule"/>
            <body name="left_shin" pos="0 -0.01 -0.403">
              <joint armature="0.0060" axis="0 -1 0" name="left_knee" pos="0 0 .02" range="-160 -2" type="hinge"/>
              <geom fromto="0 0 0 0 0 -.3" name="left_shin1" size="0.049" type="capsule"/>
              <geom name="left_foot" pos="0 0 -0.35" size="0.075" type="sphere"/>
            </body>
          </body>
        </body>
      </body>
      <body name="right_upper_arm" pos="0 -0.17 0.06">
        <joint armature="0.0068" axis="2 1 1" name="right_shoulder1" pos="0 0 0" range="-85 60" stiffness="1" type="hinge"/>
        <joint armature="0.0051" axis="0 -1 1" name="right_shoulder2" pos="0 0 0" range="-85 60" stiffness="1" type="hinge"/>
        <geom fromto="0 0 0 .16 -.16 -.16" name="right_uarm1" size="0.04" type="capsule"/>
        <body name="right_lower_arm" pos=".18 -.18 -.18">
          <joint armature="0.0028" axis="0 -1 1" name="right_elbow" pos="0 0 0" range="-90 50" stiffness="0" type="hinge"/>
          <geom fromto="0.01 0.01 0.01 .17 .17 .17" name="right_larm" size="0.031" type="capsule"/>
          <geom name="right_hand" pos=".18 .18 .18" size="0.04" type="sphere"/>
        </body>
      </body>
      <body name="left_upper_arm" pos="0 0.17 0.06">
        <joint armature="0.0068" axis="2 -1 1" name="left_shoulder1" pos="0 0 0" range="-60 85" stiffness="1" type="hinge"/>
        <joint armature="0.0051" axis="0 1 1" name="left_shoulder2" pos="0 0 0" range="-60 85" stiffness="1" type="hinge"/>
        <geom fromto="0 0 0 .16 .16 -.16" name="left_uarm1" size="0.04" type="capsule"/>
        <body name="left_lower_arm" pos=".18 .18 -.18">
          <joint armature="0.0028" axis="0 -1 -1" name="left_elbow" pos="0 0 0" range="-90 50" stiffness="0" type="hinge"/>
          <geom fromto="0.01 -0.01 0.01 .17 -.17 .17" name="left_larm" size="0.031" type="capsule"/>
          <geom name="left_hand" pos=".18 -.18 .18" size="0.04" type="sphere"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor gear="100" joint="abdomen_y"/>
    <motor gear="100" joint="abdomen_z"/>
    <motor gear="100" joint="abdomen_x"/>
    <motor gear="100" joint="right_hip_x"/>
    <motor gear="100" joint="right_hip_z"/>
    <motor gear="300" joint="right_hip_y"/>
    <motor gear="200" joint="right_knee"/>
    <motor gear="100" joint="left_hip_x"/>
    <motor gear="100" joint="left_hip_z"/>
    <motor gear="300" joint="left_hip_y"/>
    <motor gear="200" joint="left_knee"/>
    <motor gear="25" joint="right_shoulder1"/>
    <motor gear="25" joint="right_shoulder2"/>
    <motor gear="25" joint="right_elbow"/>
    <motor gear="25" joint="left_shoulder1"/>
    <motor gear="25" joint="left_shoulder2"/>
    <motor gear="25" joint="left_elbow"/>
  </actuator>
  <contact>
    <pair geom1="floor" geom2="right_foot"/>
    <pair geom1="floor" geom2="left_foot"/>
    <pair geom1="floor" geom2="right_shin1"/>
    <pair geom1="floor" geom2="left_shin1"/>
    <pair geom1="floor" geom2="butt"/>
    <pair geom1="floor" geom2="torso1"/>
    <pair geom1="floor" geom2="right_hand"/>
    <pair geom1="floor" geom2="left_hand"/>
  </contact>
</mujoco>
"""


def halfcheetah_xml() -> str:
    """Planar runner: torso + back/front legs (thigh, shin, foot)."""
    segs = {
        # name: (fromto, size, joint_axis, range, gear)
        "bthigh": ("0 0 0 .1 0 -.13", ".046", "0 1 0", "-30 52", 120),
        "bshin": ("0 0 0 -.14 0 -.07", ".046", "0 1 0", "-44 44", 90),
        "bfoot": ("0 0 0 .03 0 -.097", ".046", "0 1 0", "-23 45", 60),
        "fthigh": ("0 0 0 -.07 0 -.12", ".046", "0 1 0", "-57 40", 90),
        "fshin": ("0 0 0 .065 0 -.09", ".046", "0 1 0", "-68 49", 60),
        "ffoot": ("0 0 0 .045 0 -.07", ".046", "0 1 0", "-28 28", 30),
    }
    return f"""
<mujoco model="halfcheetah">
  <compiler angle="degree" inertiafromgeom="true"/>
  <option gravity="0 0 -9.81" timestep="0.01" iterations="4" collision="predefined"/>
  <default>
    <joint armature=".1" damping=".01" limited="true" stiffness="8"/>
    <geom friction=".4 .1 .1"/>
  </default>
  <worldbody>
    <geom name="floor" pos="0 0 0" size="40 40 40" type="plane"/>
    <body name="torso" pos="0 0 .7">
      <joint armature="0" axis="1 0 0" damping="0" limited="false" name="rootx" pos="0 0 0" stiffness="0" type="slide"/>
      <joint armature="0" axis="0 0 1" damping="0" limited="false" name="rootz" pos="0 0 0" stiffness="0" type="slide"/>
      <joint armature="0" axis="0 1 0" damping="0" limited="false" name="rooty" pos="0 0 0" stiffness="0" type="hinge"/>
      <geom fromto="-.5 0 0 .5 0 0" name="torso_geom" size="0.046" type="capsule"/>
      <geom name="head" fromto=".5 0 0 .6 0 .1" size="0.046" type="capsule"/>
      <body name="bthigh" pos="-.5 0 0">
        <joint axis="{segs['bthigh'][2]}" name="bthigh" pos="0 0 0" range="{segs['bthigh'][3]}" type="hinge"/>
        <geom fromto="{segs['bthigh'][0]}" name="bthigh_geom" size="{segs['bthigh'][1]}" type="capsule"/>
        <body name="bshin" pos=".1 0 -.13">
          <joint axis="{segs['bshin'][2]}" name="bshin" pos="0 0 0" range="{segs['bshin'][3]}" type="hinge"/>
          <geom fromto="{segs['bshin'][0]}" name="bshin_geom" size="{segs['bshin'][1]}" type="capsule"/>
          <body name="bfoot" pos="-.14 0 -.07">
            <joint axis="{segs['bfoot'][2]}" name="bfoot" pos="0 0 0" range="{segs['bfoot'][3]}" type="hinge"/>
            <geom fromto="{segs['bfoot'][0]}" name="bfoot_geom" size="{segs['bfoot'][1]}" type="capsule"/>
          </body>
        </body>
      </body>
      <body name="fthigh" pos=".5 0 0">
        <joint axis="{segs['fthigh'][2]}" name="fthigh" pos="0 0 0" range="{segs['fthigh'][3]}" type="hinge"/>
        <geom fromto="{segs['fthigh'][0]}" name="fthigh_geom" size="{segs['fthigh'][1]}" type="capsule"/>
        <body name="fshin" pos="-.07 0 -.12">
          <joint axis="{segs['fshin'][2]}" name="fshin" pos="0 0 0" range="{segs['fshin'][3]}" type="hinge"/>
          <geom fromto="{segs['fshin'][0]}" name="fshin_geom" size="{segs['fshin'][1]}" type="capsule"/>
          <body name="ffoot" pos=".065 0 -.09">
            <joint axis="{segs['ffoot'][2]}" name="ffoot" pos="0 0 0" range="{segs['ffoot'][3]}" type="hinge"/>
            <geom fromto="{segs['ffoot'][0]}" name="ffoot_geom" size="{segs['ffoot'][1]}" type="capsule"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="{segs['bthigh'][4]}" joint="bthigh"/>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="{segs['bshin'][4]}" joint="bshin"/>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="{segs['bfoot'][4]}" joint="bfoot"/>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="{segs['fthigh'][4]}" joint="fthigh"/>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="{segs['fshin'][4]}" joint="fshin"/>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="{segs['ffoot'][4]}" joint="ffoot"/>
  </actuator>
  <contact>
    <pair geom1="floor" geom2="bfoot_geom"/>
    <pair geom1="floor" geom2="ffoot_geom"/>
    <pair geom1="floor" geom2="torso_geom"/>
    <pair geom1="floor" geom2="head"/>
  </contact>
</mujoco>
"""


def hopper_xml() -> str:
    """Planar one-legged hopper: slide-slide-hinge root, thigh/leg/foot."""
    return """
<mujoco model="hopper">
  <compiler angle="degree" inertiafromgeom="true"/>
  <option timestep="0.008" iterations="4" collision="predefined"/>
  <default>
    <joint armature="1" damping="1" limited="true"/>
    <geom friction="0.9 0.1 0.1"/>
  </default>
  <worldbody>
    <geom name="floor" pos="0 0 0" size="40 40 40" type="plane"/>
    <body name="torso" pos="0 0 1.25">
      <joint armature="0" axis="1 0 0" damping="0" limited="false" name="rootx" pos="0 0 0" type="slide"/>
      <joint armature="0" axis="0 0 1" damping="0" limited="false" name="rootz" pos="0 0 0" type="slide"/>
      <joint armature="0" axis="0 1 0" damping="0" limited="false" name="rooty" pos="0 0 0" type="hinge"/>
      <geom fromto="0 0 0.2 0 0 -0.2" name="torso_geom" size="0.05" type="capsule"/>
      <body name="thigh" pos="0 0 -0.2">
        <joint axis="0 -1 0" name="thigh_joint" pos="0 0 0" range="-150 0" type="hinge"/>
        <geom fromto="0 0 0 0 0 -0.45" name="thigh_geom" size="0.05" type="capsule"/>
        <body name="leg" pos="0 0 -0.45">
          <joint axis="0 -1 0" name="leg_joint" pos="0 0 0" range="-150 0" type="hinge"/>
          <geom fromto="0 0 0 0 0 -0.5" name="leg_geom" size="0.04" type="capsule"/>
          <body name="foot" pos="0 0 -0.5">
            <joint axis="0 -1 0" name="foot_joint" pos="0 0 0" range="-45 45" type="hinge"/>
            <geom fromto="-0.13 0 0 0.26 0 0" name="foot_geom" size="0.06" type="capsule"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="200" joint="thigh_joint"/>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="200" joint="leg_joint"/>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="200" joint="foot_joint"/>
  </actuator>
  <contact>
    <pair geom1="floor" geom2="foot_geom"/>
    <pair geom1="floor" geom2="leg_geom"/>
    <pair geom1="floor" geom2="torso_geom"/>
  </contact>
</mujoco>
"""


def walker2d_xml() -> str:
    """Planar biped: slide-slide-hinge root, 2 x (thigh, leg, foot)."""
    legs = []
    for sfx in ("", "_left"):
        legs.append(f"""
      <body name="thigh{sfx}" pos="0 0 -0.2">
        <joint axis="0 -1 0" name="thigh{sfx}_joint" pos="0 0 0" range="-150 0" type="hinge"/>
        <geom fromto="0 0 0 0 0 -0.45" name="thigh{sfx}_geom" size="0.05" type="capsule"/>
        <body name="leg{sfx}" pos="0 0 -0.45">
          <joint axis="0 -1 0" name="leg{sfx}_joint" pos="0 0 0" range="-150 0" type="hinge"/>
          <geom fromto="0 0 0 0 0 -0.5" name="leg{sfx}_geom" size="0.04" type="capsule"/>
          <body name="foot{sfx}" pos="0.06 0 -0.5">
            <joint axis="0 -1 0" name="foot{sfx}_joint" pos="-0.06 0 0" range="-45 45" type="hinge"/>
            <geom fromto="-0.16 0 0 0.04 0 0" name="foot{sfx}_geom" size="0.06" type="capsule"/>
          </body>
        </body>
      </body>""")
    motors = "\n".join(
        f'    <motor ctrllimited="true" ctrlrange="-1 1" gear="100" joint="{part}{sfx}_joint"/>'
        for sfx in ("", "_left")
        for part in ("thigh", "leg", "foot")
    )
    return f"""
<mujoco model="walker2d">
  <compiler angle="degree" inertiafromgeom="true"/>
  <option timestep="0.008" iterations="4" collision="predefined"/>
  <default>
    <joint armature="0.01" damping="0.1" limited="true"/>
    <geom friction="0.7 0.1 0.1"/>
  </default>
  <worldbody>
    <geom name="floor" pos="0 0 0" size="40 40 40" type="plane"/>
    <body name="torso" pos="0 0 1.25">
      <joint armature="0" axis="1 0 0" damping="0" limited="false" name="rootx" pos="0 0 0" type="slide"/>
      <joint armature="0" axis="0 0 1" damping="0" limited="false" name="rootz" pos="0 0 0" type="slide"/>
      <joint armature="0" axis="0 1 0" damping="0" limited="false" name="rooty" pos="0 0 0" type="hinge"/>
      <geom fromto="0 0 0.2 0 0 -0.2" name="torso_geom" size="0.05" type="capsule"/>
      {''.join(legs)}
    </body>
  </worldbody>
  <actuator>
{motors}
  </actuator>
  <contact>
    <pair geom1="floor" geom2="foot_geom"/>
    <pair geom1="floor" geom2="foot_left_geom"/>
    <pair geom1="floor" geom2="torso_geom"/>
  </contact>
</mujoco>
"""


def reacher_xml() -> str:
    """Fixed-base 2-link planar arm + a kinematic target on x/y slides."""
    return """
<mujoco model="reacher">
  <compiler angle="radian" inertiafromgeom="true"/>
  <option gravity="0 0 0" timestep="0.01" iterations="4" collision="predefined"/>
  <default>
    <joint armature="1" damping="1" limited="true"/>
    <geom friction="1 0.1 0.1"/>
  </default>
  <worldbody>
    <body name="body0" pos="0 0 0.01">
      <joint armature="0.02" axis="0 0 1" limited="false" name="joint0" pos="0 0 0" type="hinge"/>
      <geom fromto="0 0 0 0.1 0 0" name="link0" size="0.01" type="capsule"/>
      <body name="body1" pos="0.1 0 0">
        <joint armature="0.02" axis="0 0 1" limited="true" name="joint1" pos="0 0 0" range="-3.0 3.0" type="hinge"/>
        <geom fromto="0 0 0 0.1 0 0" name="link1" size="0.01" type="capsule"/>
        <geom name="fingertip" pos="0.11 0 0" size="0.01" type="sphere"/>
      </body>
    </body>
    <body name="target" pos="0 0 0.01">
      <joint armature="0" axis="1 0 0" damping="100" limited="true" name="target_x" pos="0 0 0" range="-0.27 0.27" type="slide"/>
      <joint armature="0" axis="0 1 0" damping="100" limited="true" name="target_y" pos="0 0 0" range="-0.27 0.27" type="slide"/>
      <geom name="target_geom" pos="0 0 0" size="0.009" type="sphere"/>
    </body>
  </worldbody>
  <actuator>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="200" joint="joint0"/>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="200" joint="joint1"/>
  </actuator>
</mujoco>
"""
