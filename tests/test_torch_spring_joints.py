"""Legacy-spring joints, actuators and telemetry of brax_torch against the
JAX package, on the CPU.

The eight `*_config_spring` scenes equal the JAX copies field for field;
`joints.spring_apply` of each spring kind (humanoid_legacy's System holds
all three: revolute, universal, spherical) equals the JAX function's;
the joint angles and velocities the observations read
(`System.joint_angle_vel`, the universal joint's psi and theta among
them); the actuators on 1-, 2- and 3-dof spring joints (humanoid_legacy's
torque actuators, reacherangle's angle actuators); `System.info`'s spring
branch, which the envs' reset reads (ant); and `create("humanoid",
legacy_spring=True)`, which builds the PBD System, as the JAX package's
humanoid (the fork's humanoid_new) ignores the flag.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.sim import joints as jax_joints
from brax_tpu.sim import system as jax_system
from brax_torch import envs
from brax_torch.sim import actuators, joints
from brax_torch.sim.system import flatten
from brax_torch.sim.types import DP

from tests import spring_parity as sp
from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

# the asset module of each spring env, and its config function
ASSETS = {"ant": ("ant", "ant_config_spring"),
          "halfcheetah": ("half_cheetah", "halfcheetah_config_spring"),
          "humanoid_legacy": ("humanoid", "humanoid_config_spring"),
          "humanoidstandup": ("humanoid_standup", "humanoid_standup_config_spring"),
          "inverted_pendulum": ("inverted_pendulum", "inverted_pendulum_config_spring"),
          "inverted_double_pendulum": ("inverted_double_pendulum",
                                       "inverted_double_pendulum_config_spring"),
          "reacher": ("reacher", "reacher_config_spring"),
          "reacherangle": ("reacherangle", "reacherangle_config_spring")}
# joints.spring_apply, the actuators and info against the JAX functions, to
# this share of the largest |value|: a spring takes the difference of its
# two anchors' world positions (~1 m, rounded to ~6e-8 m, each package
# rotating its offsets in its own order) times its stiffness (4e3-3e4), so
# its forces carry rounding of ~1e-5 of their scale
SCALE_TOL = 1e-4


def _assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=SCALE_TOL * max(float(np.abs(want).max()), 1.0))


def test_spring_configs_equal_the_jax_ones():
    for name, (module, fn) in ASSETS.items():
        port = getattr(importlib.import_module(f"brax_torch.envs.assets.{module}"), fn)()
        jax_cfg = getattr(importlib.import_module(f"brax_tpu.envs.assets.{module}"), fn)()
        assert port.dynamics_mode == "legacy_spring"
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg), name


@functools.lru_cache(maxsize=None)
def _humanoid_state():
    """humanoid_legacy's jiggled reset state (16 envs), both packages' QP."""
    qp = sp.states("humanoid_legacy")["jiggled"]
    return qp, tp.to_jax_qp(qp)


@pytest.mark.parametrize("kind", ["spring_revolute", "spring_universal", "spring_spherical"])
def test_spring_apply_matches_jax(kind):
    sys, jsys = sp.port_env("humanoid_legacy").sys, sp.jax_env("humanoid_legacy").sys
    gi = [g.kind for g in sys.joint_groups].index(kind)
    qp, jqp = _humanoid_state()
    got = joints.spring_apply(sys.joint_groups[gi], qp, sys.nb)
    want = jax.jit(jax.vmap(lambda q: jax_joints.spring_apply(jsys.joint_groups[gi], q,
                                                              jsys.nb)))(jqp)
    _assert_close(got.vel, want.vel)
    _assert_close(got.ang, want.ang)
    assert float(got.ang.abs().max()) > 1.0  # the springs act


def test_joint_angles_and_velocities_match_jax():
    """The observations' joint angles and velocities, psi and theta of the
    universal joints (unpadded: 17 dofs), and its axes."""
    sys, jsys = sp.port_env("humanoid_legacy").sys, sp.jax_env("humanoid_legacy").sys
    qp, jqp = _humanoid_state()
    angle, vel = sys.joint_angle_vel(qp)
    jangle, jvel = jax.jit(jax.vmap(jsys.joint_angle_vel))(jqp)
    assert angle.shape == (sp.N, 17)
    _assert_close(angle, jangle)
    _assert_close(vel, jvel)
    g = sys.joint_groups[1]
    assert g.kind == "spring_universal" and g.dof == 2
    qp_p, qp_c = qp.take(g.parent), qp.take(g.child)
    axes, angles = joints.axis_angle(g, qp_p, qp_c)
    jg = jsys.joint_groups[1]
    jaxes, jangles = jax.jit(jax.vmap(lambda q: jax_joints.axis_angle(
        jg, q.take(jg.parent), q.take(jg.child))))(jqp)
    assert axes.shape == (sp.N, 3, 2, 3)
    _assert_close(axes, jaxes)
    _assert_close(angles, jangles)


def test_actuators_on_spring_joints_match_jax():
    """humanoid_legacy's torque actuators on 1-, 2- and 3-dof spring joints,
    reacherangle's angle actuators (targets past the limits): their summed
    accelerations, as the spring step adds them (no joint damping)."""
    for name in ("humanoid_legacy", "reacherangle"):
        sys, jsys = sp.port_env(name).sys, sp.jax_env(name).sys
        qp = sp.states(name)["jiggled"]
        act = sp.actions(name, 3)
        got = sum((actuators.apply(a, sys.joint_groups[a.group_index], qp, act, sys.nb)
                   for a in sys.actuator_groups),
                  DP(torch.zeros_like(qp.pos), torch.zeros_like(qp.pos)))
        want = jax.jit(jax.vmap(lambda q, a: jax_system._actuator_dp(jsys, q, a)))(
            tp.to_jax_qp(qp), jnp.asarray(act.numpy()))
        assert ([sys.joint_groups[a.group_index].dof for a in sys.actuator_groups]
                == [g.dof for g in sys.joint_groups])
        _assert_close(got.ang, want.ang)
        assert float(got.ang.abs().max()) > 0.1


def test_info_matches_jax():
    """System.info's spring branch (the contacts' and the spring joints'
    accelerations), which ant's reset observation reads, 10 twin steps
    after a reset (away from its contacts exactly on the floor)."""
    sys, jsys = sp.port_env("ant").sys, sp.jax_env("ant").sys
    qp, _ = sp.settled("ant")
    got = sys.info(qp)
    want = jax.jit(jax.vmap(jsys.info))(tp.to_jax_qp(qp))
    for field in ("contact", "joint"):
        _assert_close(getattr(got, field).vel, getattr(want, field).vel)
        _assert_close(getattr(got, field).ang, getattr(want, field).ang)
    assert float(got.contact.vel.abs().max()) > 0 and float(got.joint.ang.abs().max()) > 1.0
    _assert_close(got.contact_penetration, want.contact_penetration)


def test_humanoid_ignores_legacy_spring():
    """The registry's humanoid is the fork's humanoid_new, a PBD scene: with
    legacy_spring set it builds the same System, as the JAX env does."""
    from brax_tpu.envs import humanoid as jax_humanoid

    spring = envs.create("humanoid", batch_size=2, device="cpu", legacy_spring=True)
    plain = envs.create("humanoid", batch_size=2, device="cpu")
    assert spring.sys.dynamics_mode == "pbd" == jax_humanoid.Humanoid(
        legacy_spring=True).sys.dynamics_mode
    a, b = flatten(spring.sys), flatten(plain.sys)
    assert sorted(a) == sorted(b)
    for key, value in b.items():
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(value), err_msg=key)
