"""brax_torch.v2.envs: the create stack, the ant reset and step on both
routes against the JAX v2 ant, episode bookkeeping, and the backends and
envs that are not ported yet.

The JAX side's physics is `jax.jit(jax.vmap(pipeline.step))` run n_frames
times (`torch_parity.jax_v2_step`), its reward and observation the JAX
Ant.step given that physics.  The port's pipeline route runs the same
steps and is held at tests/test_v2_generalized_kernel.py's 2-frame
tolerances (q 2e-5, velocities 2e-4); the kernel route refreshes M^-1 at
the start of each frame instead, as the JAX kernel does, and is held to
that file's multi-frame per-env bounds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from brax_torch.v2 import envs
from brax_torch.v2.envs import ant as ant_mod
from brax_torch.v2.envs import env as env_mod
from brax_torch.v2.envs import wrappers

from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

N_FRAMES = 5


def _bare(use_kernel):
    return envs.create("ant", batch_size=tp.N_ENVS, device="cpu", use_kernel=use_kernel,
                       episode_length=None, auto_reset=False)


def test_create_builds_the_wrapper_stack():
    env = envs.create("ant", batch_size=4, device="cpu")
    layers = []
    while isinstance(env, env_mod.Wrapper):
        layers.append(type(env).__name__)
        env = env.env
    assert layers == ["AutoResetWrapper", "VmapWrapper", "EpisodeWrapper"]
    assert isinstance(env, ant_mod.Ant) and env.backend == "generalized"
    wrapped = envs.create("ant", batch_size=4, device="cpu")
    assert wrapped.action_size == 8 and wrapped.observation_size == 27
    assert float(wrapped.dt) == pytest.approx(0.05)


@pytest.fixture(scope="module")
def reset_state():
    """The port's reset state from shared noise, and the JAX reset's state."""
    q_noise, qd = tp.v2_reset_noise(seed=3)
    env = _bare(False)
    state = env.unwrapped.reset_from_noise(torch.from_numpy(q_noise), torch.from_numpy(qd))
    q = np.asarray(tp.jax_v2_ant().sys.init_q) + q_noise
    return state, tp.jax_v2_init()(q, qd)


def test_reset_matches_jax(reset_state):
    """Ant.reset is pipeline_init(init_q + noise, qd) and obs = q[2:] || qd."""
    state, jax_ps = reset_state
    np.testing.assert_allclose(state.pipeline_state.q.numpy(), np.asarray(jax_ps.q), atol=1e-7)
    np.testing.assert_allclose(state.pipeline_state.x.pos.numpy(), np.asarray(jax_ps.x.pos),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.pipeline_state.mass_mx_inv.numpy(),
                               np.asarray(jax_ps.mass_mx_inv), rtol=1e-4, atol=1e-4)
    obs = np.concatenate([np.asarray(jax_ps.q)[:, 2:], np.asarray(jax_ps.qd)], axis=1)
    np.testing.assert_allclose(state.obs.numpy(), obs, rtol=1e-5, atol=1e-6)
    assert state.obs.shape == (tp.N_ENVS, 27) and not state.done.any()
    assert sorted(state.metrics) == sorted(tp.METRICS)


def test_reset_draws_its_noise_from_the_generator():
    env = envs.create("ant", batch_size=4, device="cpu")
    a = env.reset(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    q_noise = torch.rand((4, 15), generator=gen) * 0.2 - 0.1
    qd = 0.1 * torch.randn((4, 14), generator=gen)
    b = env.unwrapped.reset_from_noise(q_noise, qd)
    torch.testing.assert_close(a.obs, b.obs, rtol=0, atol=0)
    assert a.info["steps"].shape == (4,)


@pytest.fixture(scope="module")
def jax_stepped(reset_state):
    """The JAX Ant.step from the reset state, physics from N_FRAMES steps."""
    import jax.numpy as jnp
    from brax_tpu.v2.envs import env as jax_env

    _, jax_ps = reset_state
    act = tp.actions(seed=4)[0]
    nxt = jax_ps
    for _ in range(N_FRAMES):
        nxt = tp.jax_v2_step()(nxt, act)
    zero = jnp.zeros(tp.N_ENVS)
    obs = jnp.concatenate([jax_ps.q[:, 2:], jax_ps.qd], axis=1)
    state = jax_env.State(jax_ps, obs, zero, zero, {k: zero for k in tp.METRICS})
    return act, tp.jax_v2_env_step_given()(state, act, nxt)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_env_step_matches_jax(reset_state, jax_stepped, use_kernel):
    state, _ = reset_state
    act, want = jax_stepped
    got = _bare(use_kernel).step(state, torch.from_numpy(act))
    err = lambda a, b: np.abs(np.asarray(a).reshape(tp.N_ENVS, -1)
                              - np.asarray(b).reshape(tp.N_ENVS, -1)).max(axis=1)
    dq = err(got.pipeline_state.q, want.pipeline_state.q)
    dqd = err(got.pipeline_state.qd, want.pipeline_state.qd)
    dobs, drew = err(got.obs, want.obs), err(got.reward, want.reward)
    if use_kernel is False:
        # the same steps: q within 2e-5 and velocities within 2e-4 in 9
        # envs of 10 (contact growth over 5 frames takes the rest further)
        assert np.percentile(dq, 90) < 2e-5 and np.percentile(dqd, 90) < 2e-4
        assert np.percentile(dobs, 90) < 2e-4 and np.percentile(drew, 90) < 2e-4
    else:
        assert np.median(dq) < 5e-4 and np.median(dqd) < 5e-3, (np.median(dq), np.median(dqd))
        assert np.percentile(dq, 90) < 1e-3 and np.percentile(dqd, 90) < 1e-2
        assert np.percentile(drew, 90) < 1e-2
    for k in tp.METRICS:
        assert np.median(err(got.metrics[k], want.metrics[k])) < 2e-4, k
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    assert np.isfinite(got.obs.numpy()).all()


def test_episode_truncation_and_auto_reset():
    """episode_length=3: steps count 1..3, done and truncation rise at 3,
    and the next step restarts from the first observation."""
    env = envs.create("ant", batch_size=4, device="cpu", episode_length=3, use_kernel=False)
    state = env.reset(torch.Generator().manual_seed(0))
    first_obs = state.info["first_obs"]
    seen = []
    for i in range(7):
        state = env.step(state, torch.zeros((4, 8)))
        seen.append(int(state.info["steps"][0]))
        truncated = (i + 1) % 3 == 0
        assert bool(state.done.all()) == truncated
        assert bool((state.info["truncation"] == 1).all()) == truncated
        if truncated:
            torch.testing.assert_close(state.obs, first_obs, rtol=0, atol=0)
            torch.testing.assert_close(state.pipeline_state.mass_mx_inv,
                                       state.info["first_pipeline_state"].mass_mx_inv)
    assert seen == [1, 2, 3, 1, 2, 3, 1]


@pytest.mark.parametrize("backend", ["spring", "positional"])
def test_other_backends_raise(backend):
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        envs.create("ant", batch_size=2, device="cpu", backend=backend)


def test_unported_env_and_unsupported_system_raise():
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        envs.create("humanoid", device="cpu")
    sys = _bare(False).sys
    other = dataclasses.replace(sys, actuator_types="p" * 8)

    class Bare(env_mod.PipelineEnv):
        reset = step = None

    with pytest.raises(NotImplementedError, match="actuator types"):
        Bare(other, device="cpu")
    assert Bare(other, device="cpu", use_kernel=False).sys.actuator_types == "p" * 8
    with pytest.raises(ValueError, match="batch_size"):
        wrappers.VmapWrapper(_bare(False), batch_size=3)
