"""The thruster/twister and angle-actuator groups of brax_torch against the
JAX package, on the CPU: the scenes' build and the groups' functions.

Covers `builder.build` of v1 inverted_pendulum, inverted_double_pendulum
and swimmer (thrusters, their action columns after the actuators'),
reacherangle (angle actuators) and reacher leaf for leaf,
`actuators.force_apply` (the columns clipped to the action's width) and the
angle branch of `actuators.apply` (targets past the joint limits) against
JAX's, and the clip of a narrower action: inverted_pendulum's 1-wide
action and the same action repeated to the width the Pallas kernel body
reads step alike.  The steps are held by tests/test_torch_forces_step.py
and tests/test_torch_forces_pallas.py, the envs by
tests/test_torch_forces_envs.py, the kernel's lane logic by
tests/test_torch_forces_emulation.py and tests/test_torch_forces_faults.py.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from brax_tpu.envs.assets.inverted_double_pendulum import (
    inverted_double_pendulum_config as jax_idp_config)
from brax_tpu.envs.assets.inverted_pendulum import inverted_pendulum_config as jax_ip_config
from brax_tpu.envs.assets.reacher import reacher_config as jax_reacher_config
from brax_tpu.envs.assets.reacherangle import reacherangle_config as jax_reacherangle_config
from brax_tpu.envs.assets.swimmer import swimmer_config as jax_swimmer_config
from brax_tpu.sim import actuators as jax_actuators
from brax_tpu.sim import builder as jax_builder
from brax_torch.envs.assets.inverted_double_pendulum import (
    inverted_double_pendulum_config, inverted_double_pendulum_config_spring)
from brax_torch.envs.assets.inverted_pendulum import (inverted_pendulum_config,
                                                      inverted_pendulum_config_spring)
from brax_torch.envs.assets.reacher import reacher_config, reacher_config_spring
from brax_torch.envs.assets.reacherangle import reacherangle_config, reacherangle_config_spring
from brax_torch.envs.assets.swimmer import swimmer_config
from brax_torch.sim import actuators, builder, kernels
from brax_torch.sim.system import System, flatten

from tests import forces_parity as fp
from tests import torch_parity as tp
from tests.test_torch_sim import _assert_tables_equal
from tests.torch_parity import one_torch_thread  # noqa: F401

CONFIGS = {"inverted_pendulum": (inverted_pendulum_config, jax_ip_config),
           "inverted_double_pendulum": (inverted_double_pendulum_config, jax_idp_config),
           "swimmer": (swimmer_config, jax_swimmer_config),
           "reacherangle": (reacherangle_config, jax_reacherangle_config),
           "reacher": (reacher_config, jax_reacher_config)}
# (bodies, joints, actuator kinds, force bodies, force action columns, substeps)
SCENES = {
    "inverted_pendulum": (2, 1, [], [0], [[0, 1, 2]], 8),
    "inverted_double_pendulum": (3, 2, [], [0], [[0, 1, 2]], 12),
    "swimmer": (4, 2, ["torque"], [0, 1, 2], [[2, 3, 4], [5, 6, 7], [8, 9, 10]], 12),
    "reacherangle": (4, 2, ["angle"], [], [], 4),
    "reacher": (4, 2, ["torque"], [], [], 4),
}


@pytest.mark.parametrize("name", fp.NAMES)
def test_build_matches_jax(name):
    """The port's System equals the JAX build leaf by leaf (the force group
    too), has no contacts, and the kernel covers it."""
    sys, art = builder.build(CONFIGS[name][0](), device="cpu")
    jax_sys, jax_art = jax_builder.build(CONFIGS[name][1]())
    _assert_tables_equal(flatten(sys), flatten(jax_sys))
    nb, nj, kinds, force_body, force_cols, substeps = SCENES[name]
    assert (sys.num_bodies, sys.num_joints, sys.substeps) == (nb, nj, substeps)
    assert [a.kind for a in sys.actuator_groups] == kinds
    assert [int(b) for f in sys.force_groups for b in f.body] == force_body
    assert [row.tolist() for f in sys.force_groups for row in f.act_index] == force_cols
    assert sys.num_forces_dof == 3 * len(force_body) and sys.num_contacts == 0
    assert art.action_size == jax_art.action_size == nj + sys.num_forces_dof
    assert kernels.unsupported_features(sys) == []
    # a System loaded from the JAX tables carries its force groups
    loaded = System.from_numpy(flatten(jax_sys), device="cpu")
    _assert_tables_equal(flatten(loaded), flatten(jax_sys))


@functools.lru_cache(maxsize=None)
def _jax_groups(name, width):
    sys = fp.jax_env(name).sys
    return jax.jit(jax.vmap(lambda qp, act: (
        [jax_actuators.force_apply(f, qp, act, sys.num_bodies) for f in sys.force_groups],
        [jax_actuators.apply(a, sys.joint_groups[a.group_index], qp, act, sys.num_bodies)
         for a in sys.actuator_groups])))


def test_force_apply_and_angle_actuators_match_jax():
    """force_apply and apply against JAX's on 16 reset states: the thruster
    of inverted_pendulum on its 1-wide action (every column clipped to
    column 0) and swimmer's three on 11 columns; reacherangle's angle
    actuators toward targets of +-300 degrees, past the joints' +-180
    degree limits, so that the target's clip acts.  To float32 rounding
    (1e-6 of each output's largest value)."""
    for name, width in (("inverted_pendulum", 1), ("swimmer", 11), ("reacherangle", 2)):
        sys = fp.port_env(name).sys
        qp = fp.reset_qp(name)
        act = fp.physics_actions(name, seed=2, width=width)
        forces = [actuators.force_apply(f, qp, torch.from_numpy(act), sys.nb)
                  for f in sys.force_groups]
        acts = [actuators.apply(a, sys.joint_groups[a.group_index], qp, torch.from_numpy(act),
                                sys.nb) for a in sys.actuator_groups]
        jforces, jacts = _jax_groups(name, width)(tp.to_jax_qp(qp), act)
        assert len(forces) == len(jforces) and len(acts) == len(jacts)
        for got, want in zip(forces + acts, jforces + jacts):
            for g, w in ((got.vel, want.vel), (got.ang, want.ang)):
                w = np.asarray(w)
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=1e-6 * max(np.abs(w).max(), 1), err_msg=name)
        if name == "inverted_pendulum":
            cart = forces[0].vel[:, 0]
            np.testing.assert_array_equal(cart[:, 0].numpy(), cart[:, 1].numpy())
            np.testing.assert_array_equal(cart[:, 0].numpy(), cart[:, 2].numpy())
            assert cart.abs().amin() > 0
        if name == "reacherangle":
            limits = sys.joint_groups[0].limit[:, 0] * 180 / np.pi
            assert (np.abs(act) > limits.abs().amax().item()).mean() > 0.25
            assert acts[0].ang.abs().amax() > 0


def test_padded_action_steps_as_the_clip():
    """inverted_pendulum and inverted_double_pendulum from a reset: the
    physics step on the 1-wide action and on that action repeated to the
    width the Pallas kernel body reads (num_joint_dof + num_forces_dof: its
    clip) are the same bits, in the port's twin and in the JAX jnp path.
    So the Pallas body, run on the repeated action, reads what the jnp path
    reads from the 1-wide one (tests/test_torch_forces_pallas.py)."""
    for name in ("inverted_pendulum", "inverted_double_pendulum"):
        sys = fp.port_env(name).sys
        qp = fp.reset_qp(name)
        act = fp.physics_actions(name, seed=3)
        padded = np.repeat(act, fp.PALLAS_ACT[name], axis=1)
        assert fp.PALLAS_ACT[name] == sys.num_joint_dof + sys.num_forces_dof
        out1, _ = kernels.pbd_step_plain(sys, qp, torch.from_numpy(act))
        out4, _ = kernels.pbd_step_plain(sys, qp, torch.from_numpy(padded))
        j1, _ = fp.jax_raw_step(name)(tp.to_jax_qp(qp), act)
        j4, _ = fp.jax_raw_step(name)(tp.to_jax_qp(qp), padded)
        for a, b, c, d in zip(out1.numpy(), out4.numpy(), tp.qp_numpy(j1), tp.qp_numpy(j4)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, d)


def test_unported_groups_still_raise():
    """The legacy-spring variants of these scenes are ported: the builder
    makes the JAX package's System leaf for leaf (spring revolute joints,
    the thruster and the angle actuators on them), the CUDA kernel covers
    it, and the envs switch to it; what still raises is a spring System
    with two actuators on one joint."""
    from brax_tpu.envs.assets import inverted_double_pendulum as jax_idp_assets
    from brax_tpu.envs.assets import inverted_pendulum as jax_ip_assets
    from brax_tpu.envs.assets import reacher as jax_reacher_assets
    from brax_tpu.envs.assets import reacherangle as jax_reacherangle_assets
    from brax_torch import envs

    for config, jax_config in (
            (inverted_pendulum_config_spring, jax_ip_assets.inverted_pendulum_config_spring),
            (inverted_double_pendulum_config_spring,
             jax_idp_assets.inverted_double_pendulum_config_spring),
            (reacherangle_config_spring, jax_reacherangle_assets.reacherangle_config_spring),
            (reacher_config_spring, jax_reacher_assets.reacher_config_spring)):
        sys = builder.build(config(), device="cpu")[0]
        want = flatten(jax_builder.build(jax_config())[0])
        got = flatten(sys)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(w), err_msg=key)
        assert {g.kind for g in sys.joint_groups} == {"spring_revolute"}
        assert kernels.unsupported_features(sys) == []
    for name in ("inverted_pendulum", "inverted_double_pendulum", "reacherangle", "reacher"):
        env = envs.create(name, batch_size=2, device="cpu", legacy_spring=True)
        assert env.sys.dynamics_mode == "legacy_spring"
    sys = builder.build(reacher_config_spring(), device="cpu")[0]
    twice = dataclasses.replace(sys, actuator_groups=sys.actuator_groups * 2)
    assert kernels.unsupported_features(twice) == ["two actuators on one spring joint"]
