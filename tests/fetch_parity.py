"""Shared JAX references for the tests of v1 fetch (one-way box-plane
contacts), hopper and walker2d, on the CPU.

Each JAX function is jitted once per process (the lru_caches below, and
tests/grasp_parity.py's one-pass jnp step, keyed by scene) and shared by
tests/test_torch_fetch*.py.  Inputs are numpy arrays or port tensors made
from fixed seeds and handed to both packages.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from brax_tpu.envs import fetch as jax_fetch
from brax_tpu.envs import hopper as jax_hopper
from brax_tpu.envs import walker2d as jax_walker2d
from brax_torch.envs.fetch import Fetch
from brax_torch.envs.hopper import Hopper
from brax_torch.envs.walker2d import Walker2d
from brax_torch.tools import pbd_parity as pp

from tests import torch_parity as tp

NAMES = ("fetch", "hopper", "walker2d")
ENVS = {"fetch": (Fetch, jax_fetch.Fetch), "hopper": (Hopper, jax_hopper.Hopper),
        "walker2d": (Walker2d, jax_walker2d.Walker2d)}
N = 16
OBS = {"fetch": 101, "hopper": 11, "walker2d": 17}
ACTION = {"fetch": 10, "hopper": 3, "walker2d": 6}
METRICS = {"fetch": ("hits", "weightedHits", "movingToTarget", "torsoIsUp", "torsoHeight"),
           "hopper": ("reward_forward", "reward_ctrl", "reward_healthy", "x_position",
                      "x_velocity")}
METRICS["walker2d"] = METRICS["hopper"]
# tests/test_env_suite_parity.py::PAIRS' horizon and atol of each env
ENV_STEPS = {"fetch": 3, "hopper": 5, "walker2d": 5}
ENV_ATOL = {"fetch": 2e-3, "hopper": 1e-3, "walker2d": 1e-3}


@functools.lru_cache(maxsize=None)
def jax_env(name):
    return ENVS[name][1]()


@functools.lru_cache(maxsize=None)
def port_env(name, n=N):
    return ENVS[name][0](batch_size=n, device="cpu")


@functools.lru_cache(maxsize=None)
def fetch_states():
    """pbd_parity.fetch_states of the port's fetch at N envs, seed 0."""
    return pp.fetch_states(port_env("fetch"), N, 0, "cpu")


@functools.lru_cache(maxsize=None)
def jax_reset(name):
    """keys -> (draws, State): the JAX env's reset and the draws it made
    (fetch: the target's two uniforms; hopper and walker2d: the joint angle
    and velocity noise)."""
    env = jax_env(name)
    nd = env.sys.num_joint_dof

    def reset_draws(key):
        _, rng1, rng2 = jax.random.split(key, 3)
        if name == "fetch":
            return (jnp.stack([jax.random.uniform(rng1), jax.random.uniform(rng2)]),)
        noise = lambda k: jax.random.uniform(k, (nd,), minval=-5e-3, maxval=5e-3)
        return noise(rng1), noise(rng2)

    return jax.jit(jax.vmap(lambda k: (reset_draws(k), env.reset(k))))


@functools.lru_cache(maxsize=None)
def jax_env_parts(name):
    """(draws, after) of the JAX env's step, vmapped and jitted: the two
    uniform draws of the target fetch's step places on a hit, from the
    state's rng (none for hopper and walker2d), and the env's step (state,
    action, qp, info) -> state with that physics result given."""
    env = jax_env(name)

    def draws(state):
        if name != "fetch":
            return jnp.zeros((0,))
        keys = jax.random.split(state.info["rng"], 3)[1:]
        return jnp.stack([jax.random.uniform(k) for k in keys])

    def given(state, act, qp, info):
        e = copy.copy(env)
        e.sys = tp._GivenPhysics(env.sys, qp, info)
        return e.step(state, act)

    return jax.jit(jax.vmap(draws)), jax.jit(jax.vmap(given))


def port_reset(name, draws):
    """The port env's reset state from the JAX reset's draws."""
    env = port_env(name)
    t = [torch.from_numpy(np.array(d)) for d in draws]
    if name == "fetch":
        return env.reset_from_draws(t[0])
    return env.reset_from_noise(*t)


def port_step(name, state, action, draws):
    """The port env's step, fetch's with the target's draws given."""
    env, a = port_env(name), torch.from_numpy(action)
    if name == "fetch":
        return env.step_from_draws(state, a, torch.from_numpy(np.array(draws)))
    return env.step(state, a)
