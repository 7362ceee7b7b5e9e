"""The v1 fetch, hopper and walker2d envs of brax_torch against the JAX
envs, on the CPU, and `legacy_spring`, which these envs and grasp take
and ignore, as the JAX envs do.

Each env's reset and tests/test_env_suite_parity.py::PAIRS' horizon (fetch
3 steps at 2e-3, hopper and walker2d 5 at 1e-3, with its rtol 3e-2) on the
same actions (0.3 x uniform in [-1, 1]), each on its own physics: the port
on `pbd_step_plain`, the JAX env on its jnp step traced in kernel mode
(tests/forces_parity.py::jax_raw_step says why); the reset's draws and
fetch's new targets handed across.  fetch's last 13 observation entries
are contact flags, `|Info.contact.vel|^2 > 1e-5` per body: an impulse
within rounding of that threshold could flip a flag between the two
physics, so the flags are compared where the port's own magnitude lies
outside 1% of the threshold (at these seeds every flag is compared).
"""

import jax
import numpy as np
import pytest
import torch

from brax_torch import envs
from brax_torch.sim import kernels
from brax_torch.sim.system import flatten

from tests import fetch_parity as fpar
from tests import forces_parity as fp
from tests import grasp_parity as gp
from tests.test_torch_sim import _assert_tables_equal
from tests.torch_parity import one_torch_thread  # noqa: F401

# fetch's contact flags: the last NB entries of its observation
FETCH_NB = 13
FLAG_MARGIN = 0.01


def _flag_mask(name, info, n):
    """(n, obs) True where an observation entry is compared: fetch's flags
    only where the port's contact magnitude lies off the threshold."""
    mask = np.ones((n, fpar.OBS[name]), dtype=bool)
    if name == "fetch":
        mag = torch.square(info.contact.vel).sum(dim=-1).numpy()
        mask[:, -FETCH_NB:] = np.abs(mag - 1e-5) > FLAG_MARGIN * 1e-5
    return mask


@pytest.mark.parametrize("name", fpar.NAMES)
def test_env_matches_jax(name):
    env = fpar.port_env(name)
    keys = jax.random.split(jax.random.PRNGKey(11), fpar.N)
    draws, jstate = fpar.jax_reset(name)(keys)
    state = fpar.port_reset(name, draws)
    assert state.obs.shape == (fpar.N, fpar.OBS[name]) and env.action_size == fpar.ACTION[name]
    assert sorted(state.metrics) == sorted(fpar.METRICS[name])
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=1e-5)
    target_draws, after = fpar.jax_env_parts(name)
    acts = 0.3 * np.random.RandomState(5).uniform(-1, 1, (fpar.ENV_STEPS[name], fpar.N,
                                                         fpar.ACTION[name]))
    jax_sys = fpar.jax_env(name).sys
    for a in acts.astype(np.float32):
        jnext, jinfo = gp.jax_raw(name, jax_sys, fp.from_jax_qp(jstate.qp), a)
        _, info = kernels.pbd_step_plain(env.sys, state.qp, torch.from_numpy(a))
        state = fpar.port_step(name, state, a, target_draws(jstate))
        jstate = after(jstate, a, jnext, jinfo)
    mask = _flag_mask(name, info, fpar.N)
    assert mask.all()
    atol = fpar.ENV_ATOL[name]
    np.testing.assert_allclose(state.obs.numpy()[mask], np.asarray(jstate.obs)[mask], atol=atol,
                               rtol=3e-2)
    np.testing.assert_allclose(state.reward.numpy(), np.asarray(jstate.reward),
                               atol=max(atol, 1e-3))
    np.testing.assert_allclose(state.done.numpy(), np.asarray(jstate.done))
    for k in fpar.METRICS[name]:
        np.testing.assert_allclose(state.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                   atol=max(atol, 1e-3), rtol=3e-2, err_msg=k)
    if name == "fetch":
        flags = state.obs[:, -FETCH_NB:]
        # the lower legs touch the ground, nothing else does
        assert float(flags[:, [4, 6, 8, 10]].mean()) > 0.9
        assert not bool(flags[:, [0, 1, 2, 3, 5, 7, 9, 11, 12]].any())


@pytest.mark.parametrize("name", ("grasp", "fetch", "hopper", "walker2d"))
def test_legacy_spring_is_ignored(name):
    """create(name, legacy_spring=True) builds the System it builds without
    the flag, leaf for leaf, and steps the same bits from the same reset,
    as the JAX env ignores the flag (it has no spring config)."""
    made = {flag: envs.create(name, batch_size=2, episode_length=4, device="cpu",
                              legacy_spring=flag) for flag in (False, True)}
    _assert_tables_equal(flatten(made[True].sys), flatten(made[False].sys))
    action = torch.rand((2, made[False].action_size), generator=torch.Generator().manual_seed(1))
    states = {}
    for flag, env in made.items():
        state = env.reset(torch.Generator().manual_seed(0))
        states[flag] = env.step(state, action)
    for k in ("obs", "reward", "done"):
        assert torch.equal(getattr(states[True], k), getattr(states[False], k)), k
