"""brax_torch.sim build + initial state against brax_tpu.sim, for ant.

The port's System must equal the JAX build leaf by leaf, and its reset
(default_qp from shared numpy noise, System.info, the ant observation) must
match the JAX reset path on 16 envs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from brax_tpu.envs.assets.ant import ant_config as jax_ant_config
from brax_tpu.sim import builder as jax_builder
from brax_torch.envs.ant import Ant
from brax_torch.envs.assets.ant import ant_config
from brax_torch.sim import builder, initial
from brax_torch.sim.system import System, flatten
from brax_torch.sim.types import QP

from tests import torch_parity as tp


def _assert_tables_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


@pytest.fixture(scope="module")
def jax_tables():
    return flatten(jax_builder.build(jax_ant_config())[0])


def test_build_matches_jax(jax_tables):
    """builder.build(ant_config()) equals brax_tpu's build, leaf by leaf."""
    sys, art = builder.build(ant_config(), device="cpu")
    _assert_tables_equal(flatten(sys), jax_tables)
    assert art.action_size == 8 and sys.num_bodies == 10 and sys.substeps == 10


def test_from_numpy_round_trips(jax_tables):
    sys = System.from_numpy(jax_tables, device="cpu")
    _assert_tables_equal(flatten(sys), jax_tables)
    assert isinstance(sys.mass, torch.Tensor) and sys.mass.dtype == torch.float32
    assert sys.joint_groups[0].parent.dtype == np.int32


def test_build_raises_on_features_not_ported():
    cfg = ant_config()
    cfg.joints[0].angle_limits.append((-10.0, 10.0))
    with pytest.raises(NotImplementedError, match="spherical"):
        builder.build(cfg, device="cpu")
    cfg = ant_config()
    cfg.actuators[0] = dataclasses.replace(cfg.actuators[0], kind="angle")
    with pytest.raises(NotImplementedError, match="angle actuators"):
        builder.build(cfg, device="cpu")
    cfg = ant_config()
    cfg.dynamics_mode = "legacy_spring"
    for j in cfg.joints:
        j.stiffness = 5000.0
    with pytest.raises(NotImplementedError, match="legacy_spring"):
        builder.build(cfg, device="cpu")


def test_default_angle_matches_jax():
    env = tp.jax_ant()
    _, art = builder.build(ant_config(), device="cpu")
    np.testing.assert_allclose(
        initial.default_angle(art, device="cpu").numpy(),
        np.asarray(env.default_angle()), atol=1e-7,
    )


@pytest.fixture(scope="module")
def resets():
    qpos, qvel = tp.noise(seed=0)
    env = Ant(use_contact_forces=True, batch_size=tp.N_ENVS, device="cpu")
    state = env.reset_from_noise(torch.from_numpy(qpos), torch.from_numpy(qvel))
    jqp, jobs, jinfo = tp.jax_reset()(qpos, qvel)
    return env, state, jqp, jobs, jinfo


def test_default_qp_matches_jax(resets):
    """default_qp(default_angle + noise, noise) on 16 envs, as the reset builds it."""
    env, state, jqp, _, _ = resets
    for got, want in zip(state.qp.numpy(), tp.qp_numpy(jqp)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert state.qp.pos.shape == (tp.N_ENVS, 10, 3)


def test_reset_obs_matches_jax(resets):
    """The reset observation matches to 1e-5.

    Every reset lowers its ant until the lowest capsule touches z=0, so one
    contact per env sits at penetration ~0, where `penetration > 0` decides
    whether its impulse applies and float rounding makes that decision.  The
    contact-force entries of such contacts are left out of the comparison.
    """
    env, state, _, jobs, jinfo = resets
    obs, jobs = state.obs.numpy(), np.asarray(jobs)
    assert obs.shape == (tp.N_ENVS, 87)

    pen = np.asarray(jinfo.contact_penetration)  # (N, 5): one contact per foot/torso
    body_a = env.sys.contact_groups[0].com.body_a
    keep = np.ones_like(obs, dtype=bool)
    for i, k in zip(*np.nonzero(np.abs(pen) < 1e-6)):
        b = int(body_a[k])
        keep[i, 27 + 3 * b:30 + 3 * b] = False  # contact vel of body b
        keep[i, 57 + 3 * b:60 + 3 * b] = False  # contact ang of body b
    assert keep.mean() > 0.9
    np.testing.assert_allclose(obs[keep], jobs[keep], atol=1e-5)


def test_reset_info_matches_jax(resets):
    env, state, _, _, jinfo = resets
    info = env.sys.info(state.qp)
    np.testing.assert_allclose(info.contact_pos.numpy(), np.asarray(jinfo.contact_pos), atol=1e-6)
    np.testing.assert_allclose(
        info.contact_penetration.numpy(), np.asarray(jinfo.contact_penetration), atol=1e-6
    )
    np.testing.assert_allclose(info.joint.pos.numpy(), np.asarray(jinfo.joint.pos), atol=1e-5)
    np.testing.assert_allclose(info.joint.rot.numpy(), np.asarray(jinfo.joint.rot), atol=1e-5)


def test_qp_from_numpy():
    qp = QP.from_numpy(*[np.zeros((2, 10, c), np.float64) for c in (3, 4, 3, 3)], device="cpu")
    assert qp.rot.dtype == torch.float32 and qp.rot.shape == (2, 10, 4)
