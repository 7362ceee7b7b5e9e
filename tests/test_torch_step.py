"""The port's PBD step and ant env step against the JAX jnp path.

One twin step (`brax_torch.sim.kernels.pbd_step_plain`) is held against
`jax.vmap(brax_tpu.sim.system._raw_step)` from a reset state and from a
settled, contact-rich state, and a 20-step ant rollout from shared numpy
actions against the JAX ant env.  Tolerances are those that
tests/test_pallas_kernel.py holds the Pallas kernel's math to.
"""

import numpy as np
import pytest
import torch

from brax_torch.envs.ant import Ant
from brax_torch.sim import kernels
from brax_torch.sim.types import QP

from tests import torch_parity as tp


def _fields(qp):
    return qp.pos, qp.rot, qp.vel, qp.ang


@pytest.fixture(scope="module")
def start():
    """A reset state of the port's ant (its parity is test_torch_sim's job)."""
    env = Ant(use_contact_forces=True, batch_size=tp.N_ENVS, device="cpu")
    qpos, qvel = tp.noise(seed=0)
    state = env.reset_from_noise(torch.from_numpy(qpos), torch.from_numpy(qvel))
    return env, state


def _step_both(env, qp_numpy, act):
    qp, info = kernels.pbd_step_plain(env.sys, QP.from_numpy(*qp_numpy, device="cpu"),
                                      torch.from_numpy(act))
    jqp, jinfo = tp.jax_raw_step()(tp.to_jax_qp(QP.from_numpy(*qp_numpy, device="cpu")), act)
    return qp, info, jqp, jinfo


def test_twin_step_matches_jnp_path_from_reset(start):
    env, state = start
    act = tp.actions(seed=1)[0]
    qp, info, jqp, jinfo = _step_both(env, state.qp.numpy(), act)
    jpos, jrot, jvel, jang = tp.qp_numpy(jqp)
    np.testing.assert_allclose(qp.pos.numpy(), jpos, atol=2e-5)
    np.testing.assert_allclose(qp.rot.numpy(), jrot, atol=2e-5)
    np.testing.assert_allclose(qp.vel.numpy(), jvel, atol=5e-4)
    np.testing.assert_allclose(qp.ang.numpy(), jang, atol=5e-4)
    np.testing.assert_allclose(info.contact.vel.numpy(), np.asarray(jinfo.contact.vel), atol=5e-4)
    np.testing.assert_allclose(info.contact.ang.numpy(), np.asarray(jinfo.contact.ang), atol=5e-4)


def test_twin_step_matches_jnp_path_in_contact(start):
    env, state = start
    acts = tp.actions(seed=2, steps=11)
    jqp = tp.to_jax_qp(state.qp)
    for a in acts[:10]:  # settle so that contacts activate
        jqp, _ = tp.jax_raw_step()(jqp, a)
    qp, info, jqp2, jinfo = _step_both(env, tp.qp_numpy(jqp), acts[10])
    assert (np.abs(np.asarray(jinfo.contact.vel)) > 0).any(axis=(1, 2)).mean() > 0.5
    jpos, _, jvel, _ = tp.qp_numpy(jqp2)
    np.testing.assert_allclose(qp.pos.numpy(), jpos, atol=1e-4)
    np.testing.assert_allclose(qp.vel.numpy(), jvel, atol=3e-3)
    np.testing.assert_allclose(info.contact.vel.numpy(), np.asarray(jinfo.contact.vel), atol=3e-3)
    np.testing.assert_allclose(info.contact.ang.numpy(), np.asarray(jinfo.contact.ang), atol=3e-3)


def test_rollout_matches_jax_env(start):
    """20 ant steps from shared actions.

    Each step's obs/reward/done are compared from a shared state (the JAX
    env's, loaded into the port), at the one-step in-contact tolerances.
    The port also runs free from its own state.  A contact switch (static
    friction on or off, an angle limit) decided by float rounding sends an
    env's free trajectory its own way, as tests/test_bitexact_bounds.py
    shows between two JAX arrangements of the same step, so the free run
    is held statistically: at least 3/4 of the envs stay within the
    in-contact position tolerance for all 20 steps.
    """
    env, state = start
    acts = tp.actions(seed=3, steps=20)
    n = tp.N_ENVS
    free = state.qp
    jstate = tp.to_jax_state(state)
    free_err = np.zeros(n)
    for a in acts:
        # one port step over 2n envs: first the shared states, then the free ones
        shared = QP.from_numpy(*tp.qp_numpy(jstate.qp), device="cpu")
        both = QP(*[torch.cat([x, y]) for x, y in zip(_fields(shared), _fields(free))])
        out = env.step(state.replace(qp=both), torch.from_numpy(np.concatenate([a, a])))
        free = QP(*[x[n:] for x in _fields(out.qp)])
        jstate = tp.jax_env_step(jstate, a)
        np.testing.assert_allclose(out.qp.pos[:n].numpy(), np.asarray(jstate.qp.pos), atol=1e-4)
        np.testing.assert_allclose(out.obs[:n].numpy(), np.asarray(jstate.obs), atol=3e-3)
        np.testing.assert_allclose(out.reward[:n].numpy(), np.asarray(jstate.reward), atol=3e-3)
        np.testing.assert_array_equal(out.done[:n].numpy(), np.asarray(jstate.done))
        err = np.abs(free.pos.numpy() - np.asarray(jstate.qp.pos)).max(axis=(1, 2))
        free_err = np.maximum(free_err, err)
    assert (free_err < 1e-4).mean() >= 0.75, free_err


@pytest.mark.slow
def test_long_rollout_statistics_match_jax(start):
    """1000 steps on 16 envs: trajectories decorrelate (contact chaos), so
    per-step reward and torso-height statistics are compared instead."""
    env, state = start
    rs = np.random.RandomState(4)
    free, jstate = state, tp.to_jax_state(state)
    rew, jrew, z, jz = [], [], [], []
    for _ in range(1000):
        a = rs.uniform(-1, 1, (tp.N_ENVS, 8)).astype(np.float32)
        free = env.step(free, torch.from_numpy(a))
        jstate = tp.jax_env_step(jstate, a)
        rew.append(free.reward.numpy().mean())
        jrew.append(np.asarray(jstate.reward).mean())
        z.append(free.qp.pos[:, 0, 2].numpy().mean())
        jz.append(np.asarray(jstate.qp.pos)[:, 0, 2].mean())
    np.testing.assert_allclose(np.mean(rew), np.mean(jrew), rtol=0.05)
    np.testing.assert_allclose(np.std(rew), np.std(jrew), rtol=0.1)
    np.testing.assert_allclose(np.mean(z), np.mean(jz), rtol=0.05)
