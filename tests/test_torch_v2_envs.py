"""The six v2 envs beside ant, the v2 EvalWrapper, the trainer's v1/v2
dispatch and PPO on a v2 env, against the JAX package on the CPU.

Per env (inverted_pendulum, inverted_double_pendulum, reacher, halfcheetah,
hopper, walker2d):

- the kernel's plain version against the Pallas kernel body
  `brax_tpu.v2.generalized.kernels._build_tile_frames`, run eagerly on a
  (1, 16) tile at one frame from the JAX System carried over by
  `System.from_numpy` (tests/test_torch_v2_kernel.py does this for ant),
  at tests/test_v2_generalized_kernel.py's tolerances;
- the reset from shared numpy noise against the JAX pipeline.init and
  observation, and one `env.step` on both routes against the JAX env's
  `jax.jit(jax.vmap(env.step))` (the jnp pipeline, lax.scan over
  n_frames), with tests/test_torch_v2_env.py's tolerances: the pipeline
  route at 2e-5 (q) / 2e-4 (velocities), the kernel route, which refreshes
  M^-1 at the start of each frame as the JAX kernel does, at the
  multi-frame per-env bounds.

The JAX side of each env is built and jitted once (`_jax`).
"""

import copy
import functools
import inspect

import numpy as np
import pytest
import torch

from brax_torch.envs import wrappers as v1_wrappers
from brax_torch.training.agents.ppo import train as ppo
from brax_torch.v2 import envs, mjcf
from brax_torch.v2.base import System
from brax_torch.v2.envs import env as env_mod
from brax_torch.v2.envs import wrappers
from brax_torch.v2.generalized import kernels

from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

ENVS = ("inverted_pendulum", "inverted_double_pendulum", "reacher", "halfcheetah", "hopper",
        "walker2d")
# n_frames, obs width, action width and contact points of each env
SHAPES = {
    "inverted_pendulum": (2, 4, 1, 0),
    "inverted_double_pendulum": (2, 8, 1, 0),
    "reacher": (2, 11, 2, 0),
    "halfcheetah": (5, 17, 6, 8),
    "hopper": (4, 11, 3, 6),
    "walker2d": (4, 17, 6, 6),
}
# reset noise as each JAX env draws it: q uniform in +-q_scale; qd uniform in
# +-qd_scale, or normal times qd_scale
NOISE = {
    "inverted_pendulum": (0.01, "uniform", 0.01),
    "inverted_double_pendulum": (0.1, "normal", 0.1),
    "reacher": (0.1, "uniform", 0.005),
    "halfcheetah": (0.1, "normal", 0.1),
    "hopper": (5e-3, "uniform", 5e-3),
    "walker2d": (5e-3, "uniform", 5e-3),
}
N = tp.N_ENVS
TIGHT = ("q", "x_pos", "x_rot", "c_pos", "c_pen", "minv")


@functools.lru_cache(maxsize=None)
def _jax(name):
    """(JAX env, (q, qd) -> reset State, one pipeline.step, env.step with its
    physics given), each jitted over the env batch.  The physics compiles
    once, as in `torch_parity.jax_v2_env_step_given`."""
    import jax
    import jax.numpy as jnp
    from brax_tpu.v2 import envs as jax_envs
    from brax_tpu.v2.envs import env as jax_env
    from brax_tpu.v2.generalized import pipeline

    env = jax_envs.get_environment(name)
    metrics = sorted(jax.eval_shape(env.reset, jax.random.PRNGKey(0)).metrics)

    def reset(q, qd):
        ps = pipeline.init(env.sys, q, qd)
        zero = jnp.zeros(())
        return jax_env.State(ps, env._get_obs(ps), zero, zero, {k: zero for k in metrics})

    def step_given(state, act, nxt):
        given = copy.copy(env)
        given.pipeline_step = lambda ps, a: nxt
        return given.step(state, act)

    physics = jax.jit(jax.vmap(lambda s, a: pipeline.step(env.sys, s, a)))
    return env, jax.jit(jax.vmap(reset)), physics, jax.jit(jax.vmap(step_given))


def _noise(name, seed=0):
    """(q_noise, qd, reacher's target or None), float32, for N envs."""
    env = _jax(name)[0]
    rs = np.random.RandomState(seed)
    nq, nd = env.sys.q_size(), env.sys.qd_size()
    q_scale, qd_kind, qd_scale = NOISE[name]
    q_noise = rs.uniform(-q_scale, q_scale, (N, nq)).astype(np.float32)
    qd = (qd_scale * rs.randn(N, nd) if qd_kind == "normal"
          else rs.uniform(-qd_scale, qd_scale, (N, nd))).astype(np.float32)
    target = None
    if name == "reacher":  # uniform in the disk of radius 0.2
        r, ang = 0.2 * np.sqrt(rs.uniform(size=N)), 2 * np.pi * rs.uniform(size=N)
        target = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1).astype(np.float32)
    return q_noise, qd, target


def _start(name):
    """(q, qd) numpy of the shared reset, as both envs compute them."""
    env = _jax(name)[0]
    q_noise, qd, target = _noise(name)
    q = np.asarray(env.sys.init_q) + q_noise
    if target is not None:
        q[:, 2:4], qd = target, qd.copy()
        qd[:, 2:4] = 0.0
    return q, qd


def _port(name, use_kernel=True):
    env = envs.get_environment(name, batch_size=N, device="cpu", use_kernel=use_kernel)
    q_noise, qd, target = _noise(name)
    args = (torch.from_numpy(q_noise), torch.from_numpy(qd))
    if target is not None:
        args += (torch.from_numpy(target),)
    return env, env.reset_from_noise(*args)


def _err(a, b):
    a, b = np.asarray(a).reshape(N, -1), np.asarray(b).reshape(N, -1)
    return np.abs(a - b).max(axis=1)


@pytest.mark.parametrize("name", ENVS)
def test_plain_matches_pallas_kernel_math(name):
    import jax.numpy as jnp
    from brax_tpu.v2.generalized import kernels as jax_kernels

    jax_sys = _jax(name)[0].sys
    sys = System.from_numpy(tp.tree(jax_sys), device="cpu")
    assert kernels.supported(sys)
    _, state = _port(name)
    act = np.random.RandomState(7).uniform(-1, 1, (N, sys.act_size())).astype(np.float32)
    ins = [state.pipeline_state.q.numpy(), state.pipeline_state.qd.numpy(),
           state.pipeline_state.mass_mx_inv.numpy(), act]
    fn, _ = jax_kernels._build_tile_frames(jax_sys, 1, (1, N))
    tile = lambda x: jnp.asarray(np.moveaxis(x, 0, -1)[..., None, :])
    want = {k: np.moveaxis(np.asarray(v)[..., 0, :], -1, 0)
            for k, v in fn(*(tile(x) for x in ins)).items()}
    got = kernels.gen_step_plain(sys, *(torch.from_numpy(x) for x in ins), 1)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        tol = 2e-5 if k in TIGHT else 2e-4
        np.testing.assert_allclose(got[k].numpy(), v, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", ENVS)
def test_reset_matches_jax(name):
    jax_env, jax_reset, _, _ = _jax(name)
    env, state = _port(name)
    n_frames, obs_size, act_size, nc = SHAPES[name]
    assert (env._n_frames, env.action_size, kernels.plan(env.sys).nc) == (n_frames, act_size, nc)
    want = jax_reset(*_start(name))
    ps = state.pipeline_state
    np.testing.assert_allclose(ps.q.numpy(), np.asarray(want.pipeline_state.q), atol=1e-7)
    np.testing.assert_allclose(ps.x.pos.numpy(), np.asarray(want.pipeline_state.x.pos),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(want.obs), rtol=1e-5, atol=1e-5)
    assert state.obs.shape == (N, obs_size) and not state.done.any()
    assert sorted(state.metrics) == sorted(want.metrics)
    assert float(env.dt) == pytest.approx(float(jax_env.dt))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ENVS)
def test_env_step_matches_jax(name, use_kernel):
    """Both routes' physics against n_frames JAX pipeline steps: the
    pipeline route at 2e-5 / 2e-4 in 9 envs of 10, the kernel route, which
    refreshes M^-1 at the start of each frame, at the multi-frame per-env
    bounds.  Reward, obs, done and metrics are held against the JAX env's
    given the route's own physics."""
    import jax.numpy as jnp

    _, jax_reset, jax_physics, jax_step_given = _jax(name)
    env, state = _port(name, use_kernel)
    act = np.random.RandomState(4).uniform(-1, 1, (N, env.action_size)).astype(np.float32)
    start = jax_reset(*_start(name))
    nxt = start.pipeline_state
    for _ in range(env._n_frames):
        nxt = jax_physics(nxt, act)
    got = env.step(state, torch.from_numpy(act))
    ps = got.pipeline_state
    dq, dqd = _err(ps.q, nxt.q), _err(ps.qd, nxt.qd)
    if use_kernel:
        assert np.median(dq) < 5e-4 and np.median(dqd) < 5e-3, (np.median(dq), np.median(dqd))
        assert np.percentile(dq, 90) < 1e-3 and np.percentile(dqd, 90) < 1e-2, (dq, dqd)
    else:
        assert np.percentile(dq, 90) < 2e-5 and np.percentile(dqd, 90) < 2e-4, (dq, dqd)
    num = lambda t: jnp.asarray(t.numpy())
    nxt = nxt.replace(q=num(ps.q), qd=num(ps.qd),
                      x=nxt.x.replace(pos=num(ps.x.pos), rot=num(ps.x.rot)),
                      xd=nxt.xd.replace(ang=num(ps.xd.ang), vel=num(ps.xd.vel)))
    tol = dict(rtol=1e-5, atol=1e-5)
    want = jax_step_given(start, act, nxt)
    for k in ("obs", "reward"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   err_msg=k, **tol)
    assert sorted(got.metrics) == sorted(want.metrics)
    for k in want.metrics:
        np.testing.assert_allclose(got.metrics[k].numpy(), np.asarray(want.metrics[k]),
                                   err_msg=k, **tol)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    assert np.isfinite(got.obs.numpy()).all()


def test_eval_wrapper_matches_jax():
    """The v2 EvalWrapper over the training stack (episode_length 8), on the
    same noise and actions as the JAX one: pushed hard, some pendula fall
    before step 8, the rest end there; an ended episode adds nothing more,
    though its env auto-resets and runs on (12 steps)."""
    import jax
    from brax_tpu.v2.envs import wrappers as jax_wrappers

    name, length, steps = "inverted_pendulum", 8, 12
    jax_env, jax_reset, _, _ = _jax(name)
    q, qd = _start(name)

    # each env's "key" is its (q, qd), from which it resets
    noise_reset = copy.copy(jax_env)
    noise_reset.reset = lambda qqd: jax.tree_util.tree_map(
        lambda x: x[0], jax_reset(qqd[None, :2], qqd[None, 2:]))
    jax_eval = jax_wrappers.EvalWrapper(jax_wrappers.wrap_for_training(
        noise_reset, episode_length=length))
    env, start = _port(name, use_kernel=False)  # the JAX env's physics
    env.reset = lambda rng: start
    port_eval = wrappers.EvalWrapper(wrappers.wrap_for_training(env, episode_length=length))
    jstate = jax.jit(jax_eval.reset)(np.concatenate([q, qd], axis=1))
    state = port_eval.reset(None)
    jstep = jax.jit(jax_eval.step)
    acts = np.random.RandomState(2).uniform(-1, 1, (steps, N, 1)).astype(np.float32)
    acts[:, : N // 2] = 1.0
    for t in range(steps):
        jstate, state = jstep(jstate, acts[t]), port_eval.step(state, torch.from_numpy(acts[t]))
        want, got = jstate.info["eval_metrics"], state.info["eval_metrics"]
        np.testing.assert_array_equal(got.active_episodes.numpy(), np.asarray(want.active_episodes))
        np.testing.assert_array_equal(got.episode_steps.numpy(), np.asarray(want.episode_steps))
        np.testing.assert_allclose(got.episode_metrics["reward"].numpy(),
                                   np.asarray(want.episode_metrics["reward"]), atol=1e-6)
    lengths = got.episode_steps.numpy()
    assert not got.active_episodes.any() and 0 < lengths.min() < length == lengths.max()
    np.testing.assert_array_equal(got.episode_metrics["reward"].numpy(), lengths)


def test_wrap_for_training_any_dispatches_v1_and_v2():
    from brax_torch.envs import ant as v1_ant

    def layers(env):
        out = []
        while hasattr(env, "env"):
            out.append(type(env))
            env = env.env
        return out, env

    v2, v2_bare = layers(v1_wrappers.wrap_for_training_any(
        envs.get_environment("reacher", batch_size=2, device="cpu"), episode_length=5))
    assert v2 == [wrappers.AutoResetWrapper, wrappers.VmapWrapper, wrappers.EpisodeWrapper]
    assert isinstance(v2_bare, env_mod.Env)
    v1, v1_bare = layers(v1_wrappers.wrap_for_training_any(
        v1_ant.Ant(batch_size=2, device="cpu"), episode_length=5))
    assert v1 == [v1_wrappers.AutoResetWrapper, v1_wrappers.VmapWrapper,
                  v1_wrappers.EpisodeWrapper]
    assert not isinstance(v1_bare, env_mod.Env)


def test_ppo_trains_v2_inverted_pendulum():
    """The port's PPO trainer on a bare v2 env from a factory, as
    tests/test_v2_training.py runs the JAX trainer (8 envs, episode 64),
    with fewer timesteps."""
    env = envs.get_environment("inverted_pendulum", device="cpu")
    make_policy, params, metrics = ppo.train(
        lambda batch_size, device: envs.get_environment(
            "inverted_pendulum", batch_size=batch_size, device=device),
        num_timesteps=512, episode_length=64, num_envs=8, learning_rate=3e-4,
        entropy_cost=1e-2, discounting=0.97, unroll_length=4, batch_size=8, num_minibatches=4,
        num_updates_per_batch=1, num_evals=2, num_eval_envs=8, normalize_observations=True,
        seed=0, device="cpu")
    assert np.isfinite(metrics["eval/episode_reward"])
    assert 1 <= metrics["eval/avg_episode_length"] <= 64
    policy = make_policy(params, deterministic=True)
    act, _ = policy(torch.zeros((1, env.observation_size)), torch.Generator().manual_seed(0))
    assert act.shape == (1, env.action_size)


def test_registry():
    assert sorted(envs._envs) == sorted(ENVS + ("ant",))
    with pytest.raises(NotImplementedError, match="redesign"):
        envs.get_environment("humanoid", device="cpu")

    class Slow(envs.InvertedPendulum):
        pass

    envs.register_environment("slow_pendulum", Slow)
    try:
        env = envs.create("slow_pendulum", batch_size=2, device="cpu", episode_length=3)
        assert isinstance(env.unwrapped, Slow) and env.observation_size == 4
    finally:
        del envs._envs["slow_pendulum"]


def test_entry_points_default_to_the_card():
    """Checked by signature: this box has no card."""
    default = lambda fn: inspect.signature(fn).parameters["device"].default
    assert default(mjcf.loads) == "cuda"
    assert default(System.from_numpy) == "cuda"
    assert default(envs.create) == "cuda" and default(ppo.train) == "cuda"
    for cls in envs._envs.values():
        assert default(cls.__init__) == "cuda", cls


@pytest.mark.slow  # the Pallas kernel body runs eagerly over 5 frames: ~50 s on this CPU
def test_kernel_route_keeps_to_the_pipeline_where_the_jax_kernel_drifts():
    """A fault of the JAX kernel that the port does not follow (ROADMAP.md,
    queue C).  Its Newton-Schulz refresh, 2X - X M X, doubles the
    antisymmetric part of the carried M^-1 at every iteration, and the
    inverse from pipeline.init is symmetric only to rounding; over
    halfcheetah's 5 frames from its reset that part grows to ~1e-1 and qd
    drifts off the jnp pipeline (per-env median ~7e-2).  The port mirrors
    the warm start's upper triangle, and its kernel route stays within the
    multi-frame bounds of the pipeline."""
    import jax.numpy as jnp
    from brax_tpu.v2.generalized import kernels as jax_kernels

    name = "halfcheetah"
    jax_env, jax_reset, jax_physics, _ = _jax(name)
    env, state = _port(name)
    act = np.random.RandomState(4).uniform(-1, 1, (N, env.action_size)).astype(np.float32)
    ps = state.pipeline_state
    ins = [ps.q.numpy(), ps.qd.numpy(), ps.mass_mx_inv.numpy(), act]
    fn, _ = jax_kernels._build_tile_frames(jax_env.sys, env._n_frames, (1, N))
    tile = lambda x: jnp.asarray(np.moveaxis(x, 0, -1)[..., None, :])
    pallas = {k: np.moveaxis(np.asarray(v)[..., 0, :], -1, 0)
              for k, v in fn(*(tile(x) for x in ins)).items()}
    got = kernels.gen_step_plain(env.sys, *(torch.from_numpy(x) for x in ins), env._n_frames)
    nxt = jax_reset(*_start(name)).pipeline_state
    for _ in range(env._n_frames):
        nxt = jax_physics(nxt, act)
    assert np.median(_err(pallas["qd"], nxt.qd)) > 1e-2
    dq, dqd = _err(got["q"], nxt.q), _err(got["qd"], nxt.qd)
    assert np.median(dq) < 5e-4 and np.median(dqd) < 5e-3, (np.median(dq), np.median(dqd))
