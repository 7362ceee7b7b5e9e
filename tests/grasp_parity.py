"""Shared JAX references for the tests of v1 grasp (angle actuators on
spherical joints, one-way capsule-capsule contacts), acrobot and ur5e, on
the CPU.

Each JAX function is jitted once per process (the lru_caches below) and
shared by tests/test_torch_grasp*.py and tests/test_torch_acrobot_ur5e.py.
Inputs are numpy arrays or port tensors made from fixed seeds and handed
to both packages.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from brax_tpu.envs import acrobot as jax_acrobot
from brax_tpu.envs import grasp as jax_grasp
from brax_tpu.envs import ur5e as jax_ur5e
from brax_tpu.sim import kernels as jax_kernels
from brax_tpu.sim import lowering
from brax_tpu.sim import system as jax_system
from brax_torch.envs.acrobot import Acrobot
from brax_torch.envs.grasp import Grasp
from brax_torch.envs.ur5e import Ur5e
from brax_torch.tools import pbd_parity as pp

from tests import forces_parity as fp
from tests import torch_parity as tp

NAMES = ("grasp", "acrobot", "ur5e")
ENVS = {"grasp": (Grasp, jax_grasp.Grasp), "acrobot": (Acrobot, jax_acrobot.Acrobot),
        "ur5e": (Ur5e, jax_ur5e.Ur5e)}
N = 16
OBS = {"grasp": 132, "acrobot": 4, "ur5e": 66}
ACTION = {"grasp": 39, "acrobot": 1, "ur5e": 6}
METRICS = {"grasp": ("hits", "touchingObject", "movingToObject", "movingObjectToTarget",
                     "closeToObject"),
           "acrobot": ("dist_penalty", "vel_penalty", "alive_bonus", "r_tot"),
           "ur5e": ("hits", "weightedHits", "movingToTarget")}
# tests/test_env_suite_parity.py::PAIRS' horizon and atol of each env
ENV_STEPS = {"grasp": 3, "acrobot": 10, "ur5e": 5}
ENV_ATOL = {"grasp": 2e-3, "acrobot": 1e-4, "ur5e": 1e-3}


@functools.lru_cache(maxsize=None)
def jax_env(name):
    return ENVS[name][1]()


@functools.lru_cache(maxsize=None)
def port_env(name, n=N):
    return ENVS[name][0](batch_size=n, device="cpu")


_ONE_PASS = {}


def jax_one_pass(key, sys):
    """(qp, act) -> (qp, info): one PBD pass (2 substeps) of the JAX jnp
    step of `sys`, vmapped and jitted once per `key`."""
    if key not in _ONE_PASS:
        _ONE_PASS[key] = jax.jit(jax.vmap(
            lambda qp, act: jax_system._raw_step(sys.replace(substeps=2), qp, act)))
    return _ONE_PASS[key]


def jax_raw(key, sys, qp, act, passes=None):
    """(qp, info) of the JAX jnp physics step of `sys` (jitted once per
    `key`) over `passes` passes (default: the whole step, substeps / 2),
    traced in the JAX package's kernel mode (tests/forces_parity.py::
    jax_raw_step says why), on a port QP and an action; the contact
    impulses summed from the left, as _pbd_step's scan sums them."""
    one_pass = jax_one_pass(key, sys)
    jqp, act = tp.to_jax_qp(qp), jnp.asarray(np.asarray(act))
    contact = None
    with lowering.kernel_mode():  # read while the first call traces
        for _ in range(passes or sys.substeps // 2):
            jqp, info = one_pass(jqp, act)
            contact = info.contact if contact is None else contact + info.contact
    return jqp, info.replace(contact=contact)


def jax_step(key, sys, qp, act, passes=None):
    """`jax_raw` as `pbd_parity.fields`-like torch tensors."""
    return fp.jax_fields(*jax_raw(key, sys, qp, act, passes))


@functools.lru_cache(maxsize=None)
def grasp_states():
    """pbd_parity.grasp_states of the port's grasp at N envs, seed 0."""
    return pp.grasp_states(port_env("grasp"), N, 0, "cpu")


def pallas_one_pass(sys, qp, act):
    """The Pallas kernel body (`_build_tile_step`, run eagerly) of the JAX
    System `sys` over one pass, on batch-first port inputs; its six
    outputs batch-first."""
    tile_step = jax_kernels._build_tile_step(sys.replace(substeps=2))
    t = lambda x: jnp.asarray(np.transpose(x.numpy(), (1, 2, 0)))
    outs = tile_step(t(qp.pos), t(qp.rot), t(qp.vel), t(qp.ang), jnp.asarray(act.numpy().T))
    return {k: torch.from_numpy(np.transpose(np.asarray(o), (2, 0, 1)).copy())
            for k, o in zip(fp.OUTPUTS, outs)}


class Capture(tp._GivenPhysics):
    """A JAX System whose step returns its input state with the reset-time
    info: stepping a JAX env through it records what the env hands its
    physics (grasp's moved palm and rescaled action)."""

    def step(self, qp, act):
        self.given = (qp, act)
        return qp, self._sys.info(qp)


@functools.lru_cache(maxsize=None)
def jax_env_parts(name):
    """(before, draws, after) of the JAX env's step, vmapped and jitted:
    the physics input of (state, action) (grasp moves its palm and rescales
    its action first), the uniform draws of the target the step would place
    on a hit (grasp 3, ur5e 2, acrobot none) from the state's rng, and the
    env's step (state, action, qp, info) -> state with that physics result
    given."""
    env = jax_env(name)

    def before(state, a):
        e = copy.copy(env)
        e.sys = Capture(env.sys, None, None)
        e.step(state, a)
        return e.sys.given

    def draws(state):
        if name == "acrobot":
            return jnp.zeros((0,))
        keys = jax.random.split(state.info["rng"], 4 if name == "grasp" else 3)[1:]
        return jnp.stack([jax.random.uniform(k) for k in keys])

    def given(state, act, qp, info):
        e = copy.copy(env)
        e.sys = tp._GivenPhysics(env.sys, qp, info)
        return e.step(state, act)

    return (jax.jit(jax.vmap(before)), jax.jit(jax.vmap(draws)), jax.jit(jax.vmap(given)))


@functools.lru_cache(maxsize=None)
def jax_reset(name):
    """keys -> (draws, State): the JAX env's reset and the draws it made
    (acrobot: joint angle and velocity noise; ur5e: the target's two
    uniforms; grasp: none)."""
    env = jax_env(name)
    nd = env.sys.num_joint_dof

    def reset_draws(key):
        rng, rng1, rng2 = jax.random.split(key, 3)
        if name == "acrobot":
            noise = lambda k: jax.random.uniform(k, (nd,), minval=-0.01, maxval=0.01)
            return noise(rng1), noise(rng2)
        if name == "ur5e":
            return (jnp.stack([jax.random.uniform(rng1), jax.random.uniform(rng2)]),)
        return ()

    return jax.jit(jax.vmap(lambda k: (reset_draws(k), env.reset(k))))


def port_reset(name, draws):
    """The port env's reset state from the JAX reset's draws."""
    env = port_env(name)
    t = [torch.from_numpy(np.array(d)) for d in draws]
    if name == "acrobot":
        return env.reset_from_noise(*t)
    if name == "ur5e":
        return env.reset_from_draws(t[0])
    return env.reset(torch.Generator().manual_seed(0))


def port_step(name, state, action, draws):
    """The port env's step with the target's draws given."""
    env, a = port_env(name), torch.from_numpy(action)
    if name == "acrobot":
        return env.step(state, a)
    return env.step_from_draws(state, a, torch.from_numpy(np.array(draws)))


def to_jax_state(state, metrics, info=None):
    num = lambda t: jnp.asarray(t.detach().cpu().numpy())
    from brax_tpu.envs import base as jax_base

    return jax_base.State(qp=tp.to_jax_qp(state.qp), obs=num(state.obs), reward=num(state.reward),
                          done=num(state.done), metrics={k: num(state.metrics[k]) for k in metrics},
                          info=info or {})


def pusher_oneway_jax(jax_sys):
    """The JAX System of pusher with its capsule-capsule pairs made one-way,
    as `pbd_parity.oneway_pusher` makes the port's."""
    groups = tuple(dataclasses.replace(c, com=dataclasses.replace(c.com, one_way=True))
                   if type(c).__name__ == "CapsuleCapsule" else c
                   for c in jax_sys.contact_groups)
    return jax_sys.replace(contact_groups=groups)
