"""v1 acrobot and ur5e of brax_torch against the JAX package, on the CPU.

Both scenes need no new kernel section: revolute joints and torque
actuators, no contacts (acrobot: 3 bodies, 2 hinges, one actuator on the
second; ur5e: 8 bodies, 6 hinges each with an actuator, 8 substeps).
Held here: the build leaf for leaf; one whole step of `pbd_step_plain`
from each env's reset against `jax.vmap(system._raw_step)` traced in the
JAX package's kernel mode (tests/forces_parity.py::jax_raw_step says why)
at tests/test_torch_step.py's ONE_STEP; each env's reset and
tests/test_env_suite_parity.py::PAIRS' horizon (acrobot 10 steps at
1e-4, ur5e 5 at 1e-3, with its rtol 3e-2) on the same actions, each on its
own physics, ur5e's new targets handed across; and the registry.
"""

import jax
import numpy as np
import pytest
import torch

from brax_tpu.envs.assets.acrobot import acrobot_config as jax_acrobot_config
from brax_tpu.envs.assets.ur5e import ur5e_config as jax_ur5e_config
from brax_tpu.sim import builder as jax_builder
from brax_torch import envs
from brax_torch.envs.assets.acrobot import acrobot_config
from brax_torch.envs.assets.ur5e import ur5e_config
from brax_torch.sim import builder, kernels
from brax_torch.sim.system import flatten
from brax_torch.tools.pbd_parity import fields

from tests import forces_parity as fp
from tests import grasp_parity as gp
from tests.test_torch_sim import _assert_tables_equal
from tests.torch_parity import one_torch_thread  # noqa: F401

NAMES = ("acrobot", "ur5e")
CONFIGS = {"acrobot": (acrobot_config, jax_acrobot_config), "ur5e": (ur5e_config, jax_ur5e_config)}


@pytest.mark.parametrize("name", NAMES)
def test_build_matches_jax_leaf_for_leaf(name):
    port, ref = CONFIGS[name]
    sys, _ = builder.build(port(), device="cpu")
    jax_sys, _ = jax_builder.build(ref())
    _assert_tables_equal(flatten(sys), flatten(jax_sys))
    assert [g.kind for g in sys.joint_groups] == ["revolute"] and not sys.contact_groups
    assert kernels.unsupported_features(sys, gp.ACTION[name]) == []


@pytest.mark.parametrize("name", NAMES)
def test_twin_step_matches_jnp_path(name):
    """One whole step from the env's reset states (JAX's reset draws) on
    uniform actions in [-1, 1], every field of every env within ONE_STEP;
    the actuators move the arm."""
    env = gp.port_env(name)
    draws, _ = gp.jax_reset(name)(jax.random.split(jax.random.PRNGKey(3), gp.N))
    qp = gp.port_reset(name, draws).qp
    act = np.random.RandomState(1).uniform(-1, 1, (gp.N, gp.ACTION[name])).astype(np.float32)
    out, info = kernels.pbd_step_plain(env.sys, qp, torch.from_numpy(act))
    want = gp.jax_step(name, gp.jax_env(name).sys, qp, act)
    got = fields(out, info)
    for k, tol in fp.ONE_STEP.items():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol, err_msg=k)
    idle, _ = kernels.pbd_step_plain(env.sys, qp, torch.zeros(gp.N, gp.ACTION[name]))
    assert float((out.ang - idle.ang).abs().max()) > 1e-2


@pytest.mark.parametrize("name", NAMES)
def test_env_matches_jax(name):
    env = gp.port_env(name)
    keys = jax.random.split(jax.random.PRNGKey(11), gp.N)
    draws, jstate = gp.jax_reset(name)(keys)
    state = gp.port_reset(name, draws)
    assert state.obs.shape == (gp.N, gp.OBS[name]) and env.action_size == gp.ACTION[name]
    assert sorted(state.metrics) == sorted(gp.METRICS[name])
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=1e-5)
    _, target_draws, after = gp.jax_env_parts(name)
    acts = 0.3 * np.random.RandomState(5).uniform(-1, 1, (gp.ENV_STEPS[name], gp.N,
                                                         gp.ACTION[name]))
    for a in acts.astype(np.float32):
        jnext, jinfo = gp.jax_raw(name, gp.jax_env(name).sys, fp.from_jax_qp(jstate.qp), a)
        state = gp.port_step(name, state, a, target_draws(jstate))
        jstate = after(jstate, a, jnext, jinfo)
    atol = gp.ENV_ATOL[name]
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=atol, rtol=3e-2)
    np.testing.assert_allclose(state.reward.numpy(), np.asarray(jstate.reward),
                               atol=max(atol, 1e-3))
    for k in gp.METRICS[name]:
        np.testing.assert_allclose(state.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                   atol=max(atol, 1e-3), rtol=3e-2, err_msg=k)


def test_create_registers_the_envs():
    """envs.create builds grasp, acrobot and ur5e on the CPU at their batch
    and their widths; the CPU step runs the twin and launches nothing; with
    legacy_spring set each builds the same System and steps the same bits,
    as the JAX envs ignore the flag (none has a spring config)."""
    for name in gp.NAMES:
        env = envs.create(name, batch_size=2, episode_length=4, device="cpu")
        assert env.observation_size == gp.OBS[name] and env.action_size == gp.ACTION[name]
        state = env.reset(torch.Generator().manual_seed(0))
        before = kernels.pbd_step_launch.launches
        state = env.step(state, torch.zeros((2, gp.ACTION[name])))
        assert kernels.pbd_step_launch.launches == before
        assert state.obs.shape == (2, gp.OBS[name]) and bool(torch.isfinite(state.obs).all())
        spring = envs.create(name, batch_size=2, episode_length=4, device="cpu",
                             legacy_spring=True)
        _assert_tables_equal(flatten(spring.sys), flatten(env.sys))
        again = spring.step(spring.reset(torch.Generator().manual_seed(0)),
                            torch.zeros((2, gp.ACTION[name])))
        assert torch.equal(again.obs, state.obs) and torch.equal(again.reward, state.reward)
