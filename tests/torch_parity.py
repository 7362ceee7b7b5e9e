"""Shared JAX references for the brax_torch parity tests.

Everything here works at 16 envs on the CPU.  Inputs are numpy arrays made
from fixed seeds and handed to both packages.  The JAX functions are jitted
once per process (eager vmapped JAX over 16 envs takes tens of seconds; each
jit compile here takes 1-10 s on CPU) and shared by every test file through
the lru_caches below.

JAX is imported inside the functions that use it, so that
tests/test_torch_cuda.py, which runs where only PyTorch is installed, can
share `one_torch_thread`.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

N_ENVS = 16
METRICS = (
    "reward_forward", "reward_survive", "reward_ctrl", "reward_contact",
    "x_position", "y_position", "distance_from_origin", "x_velocity",
    "y_velocity", "forward_reward",
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Pins torch to one intra-op thread for a test module.

    The tensors in these tests are tiny; beside the suite's other worker
    processes, torch's intra-op threads only contend for the cores (the PPO
    learning gate took minutes instead of seconds).  Import it into a test
    module to use it there."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def jax_ant():
    from brax_tpu.envs import ant as jax_ant_mod

    return jax_ant_mod.Ant(use_contact_forces=True)


def noise(seed=0, scale=0.1):
    """Reset noise (qpos, qvel), each (N_ENVS, 8) float32, as Ant.reset draws it."""
    rs = np.random.RandomState(seed)
    return tuple(rs.uniform(-scale, scale, (N_ENVS, 8)).astype(np.float32) for _ in range(2))


def actions(seed=1, steps=1):
    """(steps, N_ENVS, 8) float32 actions in [-1, 1]."""
    return np.random.RandomState(seed).uniform(-1, 1, (steps, N_ENVS, 8)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_reset():
    """(qpos_noise, qvel_noise) -> (qp, obs, info): the JAX Ant.reset path."""
    import jax

    env = jax_ant()

    def reset(qpos_noise, qvel_noise):
        qp = env.default_qp(joint_angle=env.default_angle() + qpos_noise,
                            joint_velocity=qvel_noise)
        info = env.sys.info(qp)
        return qp, env._get_obs(qp, info), info

    return jax.jit(jax.vmap(reset))


@functools.lru_cache(maxsize=None)
def jax_raw_step():
    """(qp, act) -> (qp, info): the JAX jnp physics step, vmapped."""
    import jax
    from brax_tpu.sim import system as jax_system

    sys = jax_ant().sys
    return jax.jit(jax.vmap(lambda qp, act: jax_system._raw_step(sys, qp, act)))


class _GivenPhysics:
    """Stands in for a JAX System whose step result is already known."""

    def __init__(self, sys, qp, info):
        self._sys, self._out = sys, (qp, info)

    def step(self, qp, act):
        return self._out

    def __getattr__(self, name):
        return getattr(self._sys, name)


@functools.lru_cache(maxsize=None)
def jax_env_step_given():
    """(state, act, qp_next, info) -> state: the JAX Ant.step, with its
    physics taken from `jax_raw_step` so that the JAX physics compiles once."""
    import jax

    def step(state, act, qp, info):
        env = copy.copy(jax_ant())
        env.sys = _GivenPhysics(env.sys, qp, info)
        return env.step(state, act)

    return jax.jit(jax.vmap(step))


def jax_env_step(state, act):
    qp, info = jax_raw_step()(state.qp, act)
    return jax_env_step_given()(state, act, qp, info)


def to_jax_qp(qp):
    import jax.numpy as jnp
    from brax_tpu.sim.types import QP as JaxQP

    return JaxQP(*[jnp.asarray(x) for x in qp.numpy()])


def to_jax_state(state):
    """A JAX env State holding a port env State's numbers."""
    import jax.numpy as jnp
    from brax_tpu.envs import base as jax_base

    num = lambda t: jnp.asarray(t.detach().cpu().numpy())
    return jax_base.State(
        qp=to_jax_qp(state.qp), obs=num(state.obs), reward=num(state.reward),
        done=num(state.done), metrics={k: num(state.metrics[k]) for k in METRICS},
    )


def qp_numpy(jqp):
    return tuple(np.asarray(getattr(jqp, f)) for f in ("pos", "rot", "vel", "ang"))


# ---------------------------------------------------------------------------
# v2: the generalized ant
# ---------------------------------------------------------------------------

V2_NQ, V2_ND, V2_NA = 15, 14, 8


def tree(obj):
    """A dataclass tree (either package's System or State) as nested dicts
    of numpy arrays, each dataclass with its class name under "__type__":
    the form `brax_torch.v2.base.System.from_numpy` takes."""
    if dataclasses.is_dataclass(obj):
        out = {f.name: tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        out["__type__"] = type(obj).__name__
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree(x) for x in obj)
    if obj is None or isinstance(obj, (str, int)):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def leaves(t, path=""):
    """(path, leaf) pairs of a `tree`, depth first."""
    if isinstance(t, dict):
        for k, v in t.items():
            if k != "__type__":
                yield from leaves(v, f"{path}.{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, t


@functools.lru_cache(maxsize=None)
def jax_v2_ant():
    from brax_tpu.v2.envs import ant as v2_ant

    return v2_ant.Ant(backend="generalized")


def v2_reset_noise(seed=0):
    """(q_noise, qd) float32 for N_ENVS ants, as Ant.reset draws them
    (q = init_q + q_noise, q_noise uniform in +-0.1, qd of scale 0.1), with
    the torso lowered by up to 0.35 so that some feet touch the floor."""
    rs = np.random.RandomState(seed)
    q_noise = rs.uniform(-0.1, 0.1, (N_ENVS, V2_NQ))
    q_noise[:, 2] -= rs.uniform(0.0, 0.35, N_ENVS)
    return q_noise.astype(np.float32), (0.1 * rs.randn(N_ENVS, V2_ND)).astype(np.float32)


def v2_inputs(seed=0):
    """(q, qd, act) float32: the states of `v2_reset_noise` and actions in
    [-1, 1]."""
    q_noise, qd = v2_reset_noise(seed)
    act = np.random.RandomState(seed + 100).uniform(-1, 1, (N_ENVS, V2_NA)).astype(np.float32)
    return np.asarray(jax_v2_ant().sys.init_q) + q_noise, qd, act


@functools.lru_cache(maxsize=None)
def jax_v2_init():
    """(q, qd) -> pipeline State: the JAX generalized pipeline.init, vmapped."""
    import jax
    from brax_tpu.v2.generalized import pipeline

    sys = jax_v2_ant().sys
    return jax.jit(jax.vmap(lambda q, qd: pipeline.init(sys, q, qd)))


@functools.lru_cache(maxsize=None)
def jax_v2_step():
    """(State, act) -> State: one JAX generalized pipeline.step, vmapped."""
    import jax
    from brax_tpu.v2.generalized import pipeline

    sys = jax_v2_ant().sys
    return jax.jit(jax.vmap(lambda s, a: pipeline.step(sys, s, a)))


@functools.lru_cache(maxsize=None)
def jax_v2_states(seed=0):
    """The JAX pipeline State of `v2_inputs(seed)` and the State one step on."""
    q, qd, act = v2_inputs(seed)
    s0 = jax_v2_init()(q, qd)
    return s0, jax_v2_step()(s0, act)


@functools.lru_cache(maxsize=None)
def jax_v2_env_step_given():
    """(env State, act, next pipeline State) -> env State: the JAX v2
    Ant.step with its physics given, so that the physics compiles once (as
    `jax_v2_step`)."""
    import jax

    def step(state, act, nxt):
        env = copy.copy(jax_v2_ant())
        env.pipeline_step = lambda ps, a: nxt
        return env.step(state, act)

    return jax.jit(jax.vmap(step))
