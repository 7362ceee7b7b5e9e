"""Shared JAX references for the brax_torch parity tests.

Everything here works at 16 ant envs on the CPU.  Inputs are numpy arrays
made from fixed seeds and handed to both packages.  The JAX functions are
jitted once per process (eager vmapped JAX over 16 envs takes tens of
seconds; each jit compile here takes 1-10 s on CPU) and shared by every test
file through the lru_caches below.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np

from brax_tpu.envs import ant as jax_ant_mod
from brax_tpu.envs import base as jax_base
from brax_tpu.sim import system as jax_system
from brax_tpu.sim.types import QP as JaxQP

N_ENVS = 16
METRICS = (
    "reward_forward", "reward_survive", "reward_ctrl", "reward_contact",
    "x_position", "y_position", "distance_from_origin", "x_velocity",
    "y_velocity", "forward_reward",
)


@functools.lru_cache(maxsize=None)
def jax_ant():
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

    def step(state, act, qp, info):
        env = copy.copy(jax_ant())
        env.sys = _GivenPhysics(env.sys, qp, info)
        return env.step(state, act)

    return jax.jit(jax.vmap(step))


def jax_env_step(state, act):
    qp, info = jax_raw_step()(state.qp, act)
    return jax_env_step_given()(state, act, qp, info)


def to_jax_qp(qp) -> JaxQP:
    return JaxQP(*[jnp.asarray(x) for x in qp.numpy()])


def to_jax_state(state):
    """A JAX env State holding a port env State's numbers."""
    num = lambda t: jnp.asarray(t.detach().cpu().numpy())
    return jax_base.State(
        qp=to_jax_qp(state.qp), obs=num(state.obs), reward=num(state.reward),
        done=num(state.done), metrics={k: num(state.metrics[k]) for k in METRICS},
    )


def qp_numpy(jqp):
    return tuple(np.asarray(getattr(jqp, f)) for f in ("pos", "rot", "vel", "ang"))
