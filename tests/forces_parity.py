"""Shared JAX references for the tests of the thruster/twister and
angle-actuator groups: v1 inverted_pendulum, inverted_double_pendulum,
swimmer, reacherangle and reacher, on the CPU.

Each JAX function is jitted once per process (the lru_caches below) and
shared by tests/test_torch_forces*.py.  Inputs are numpy arrays made from
fixed seeds and handed to both packages.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from brax_tpu.envs import inverted_double_pendulum as jax_idp
from brax_tpu.envs import inverted_pendulum as jax_ip
from brax_tpu.envs import reacher as jax_reacher
from brax_tpu.envs import reacherangle as jax_reacherangle
from brax_tpu.envs import swimmer as jax_swimmer
from brax_tpu.sim import kernels as jax_kernels
from brax_tpu.sim import lowering
from brax_tpu.sim import system as jax_system
from brax_torch.envs.inverted_double_pendulum import InvertedDoublePendulum
from brax_torch.envs.inverted_pendulum import InvertedPendulum
from brax_torch.envs.reacher import Reacher
from brax_torch.envs.reacherangle import ReacherAngle
from brax_torch.envs.swimmer import Swimmer
from brax_torch.sim.types import QP

from tests import torch_parity as tp

NAMES = ("inverted_pendulum", "inverted_double_pendulum", "swimmer", "reacherangle", "reacher")
ENVS = {"inverted_pendulum": (InvertedPendulum, jax_ip.InvertedPendulum),
        "inverted_double_pendulum": (InvertedDoublePendulum, jax_idp.InvertedDoublePendulum),
        "swimmer": (Swimmer, jax_swimmer.Swimmer),
        "reacherangle": (ReacherAngle, jax_reacherangle.ReacherAngle),
        "reacher": (Reacher, jax_reacher.Reacher)}
N = 16
# the width of the action the physics step reads: the env's action, and
# for swimmer the 9 viscosity columns it appends
PHYSICS_ACT = {"inverted_pendulum": 1, "inverted_double_pendulum": 1, "swimmer": 11,
               "reacherangle": 2, "reacher": 2}
# the width the Pallas kernel body reads: num_joint_dof + num_forces_dof
PALLAS_ACT = {"inverted_pendulum": 4, "inverted_double_pendulum": 5, "swimmer": 11,
              "reacherangle": 2, "reacher": 2}
OUTPUTS = ("pos", "rot", "vel", "ang", "contact_vel", "contact_ang")
# tests/test_torch_step.py's one-step tolerances (from a reset)
ONE_STEP = {"pos": 2e-5, "rot": 2e-5, "vel": 5e-4, "ang": 5e-4, "contact_vel": 5e-4,
            "contact_ang": 5e-4}
# tests/test_env_suite_parity.py::PAIRS' horizon and atol for these envs
ENV_STEPS, ENV_ATOL = 10, 1e-4


@functools.lru_cache(maxsize=None)
def jax_env(name):
    return ENVS[name][1]()


@functools.lru_cache(maxsize=None)
def port_env(name, n=N):
    return ENVS[name][0](batch_size=n, device="cpu")


def reset_qp(name, seed=0):
    """The port's reset states of `name` (N envs)."""
    return port_env(name).reset(torch.Generator().manual_seed(seed)).qp


def physics_actions(name, seed, width=None):
    """(N, width) float32 physics actions: uniform in [-1, 1]; reacherangle's
    in degrees past its joints' limits (+-300), so that the target's clip to
    the limits acts; swimmer's viscosity columns of the drag's size (+-5)."""
    width = width or PHYSICS_ACT[name]
    act = np.random.RandomState(seed).uniform(-1, 1, (N, width)).astype(np.float32)
    if name == "reacherangle":
        act *= 300.0
    if name == "swimmer":
        act[:, 2:] *= 5.0
    return act


@functools.lru_cache(maxsize=None)
def jax_raw_step(name):
    """(qp, act) -> (qp, info): the JAX jnp physics step, vmapped, traced in
    the JAX package's kernel mode (`lowering.kernel_mode`), whose arctan2 is
    the minimax polynomial that the Pallas body, the CUDA kernel and the
    port's twin take.  Outside it the jnp path takes jnp.arctan2; the joint
    angles then differ by the polynomial's error (~1e-7 rad), which the
    joint-limit rows turn into position corrections and the velocity
    projection divides by the substep (swimmer: 5.6e-4 rad/s in one step,
    past ONE_STEP's 5e-4; 8.7e-5 in kernel mode).  One pass (the System
    with 2 substeps) is jitted and run substeps / 2 times, its contact
    impulses summed from the left as _pbd_step's scan sums them."""
    sys = jax_env(name).sys
    one_pass = jax.jit(jax.vmap(
        lambda qp, act: jax_system._raw_step(sys.replace(substeps=2), qp, act)))

    def step(qp, act):
        contact = None
        with lowering.kernel_mode():  # read while the first call traces
            for _ in range(sys.substeps // 2):
                qp, info = one_pass(qp, act)
                contact = info.contact if contact is None else contact + info.contact
        return qp, info.replace(contact=contact)

    return step


def jax_fields(jqp, jinfo):
    pos, rot, vel, ang = (torch.from_numpy(x.copy()) for x in tp.qp_numpy(jqp))
    return {"pos": pos, "rot": rot, "vel": vel, "ang": ang,
            "contact_vel": torch.from_numpy(np.array(jinfo.contact.vel)),
            "contact_ang": torch.from_numpy(np.array(jinfo.contact.ang))}


def pallas_one_pass(name, qp, act):
    """The Pallas kernel body (`_build_tile_step`, run eagerly) over one
    pass, on batch-first inputs; its six outputs batch-first."""
    tile_step = jax_kernels._build_tile_step(jax_env(name).sys.replace(substeps=2))
    t = lambda x: jnp.asarray(np.transpose(x.numpy(), (1, 2, 0)))
    outs = tile_step(t(qp.pos), t(qp.rot), t(qp.vel), t(qp.ang), jnp.asarray(act.T))
    return {k: torch.from_numpy(np.transpose(np.asarray(o), (2, 0, 1)).copy())
            for k, o in zip(OUTPUTS, outs)}


@functools.lru_cache(maxsize=None)
def jax_reset(name):
    """keys -> (draws, State): the JAX env's reset and the draws it made, in
    the form the port's reset_from_noise takes."""
    env = jax_env(name)
    nd = env.sys.num_joint_dof

    def draws(key):
        rng, rng1, rng2 = jax.random.split(key, 3)
        if name in ("reacher", "reacherangle"):
            qpos = jax.random.uniform(rng1, (nd,), minval=-0.1, maxval=0.1)
            qvel = jax.random.uniform(rng2, (nd,), minval=-0.005, maxval=0.005)
            _, t1, t2 = jax.random.split(rng, 3)
            return qpos, qvel, jnp.stack([jax.random.uniform(t1), jax.random.uniform(t2)])
        scale = 0.1 if name == "swimmer" else 0.01
        noise = lambda k: jax.random.uniform(k, (nd,), minval=-scale, maxval=scale)
        return noise(rng1), noise(rng2)

    return jax.jit(jax.vmap(lambda k: (draws(k), env.reset(k))))


@functools.lru_cache(maxsize=None)
def jax_env_parts(name):
    """(before, physics, after) of the JAX env's step, vmapped: the physics
    action of (qp, action) (swimmer appends its viscous forces, reacherangle
    maps the action onto the joint limits), the jnp physics step of
    `jax_raw_step`, and the env's step (state, action, qp, info) -> state
    with that physics result given."""
    env = jax_env(name)
    if name == "swimmer":
        before = jax.jit(jax.vmap(lambda qp, a: jnp.concatenate(
            [a, env._get_viscous_force(qp).reshape(-1)])))
    elif name == "reacherangle":
        before = jax.jit(jax.vmap(lambda qp, a: env._min_act + env._range_act * ((a + 1) / 2.0)))
    else:
        before = lambda qp, a: a

    def given(state, act, qp, info):
        e = copy.copy(env)
        e.sys = tp._GivenPhysics(env.sys, qp, info)
        return e.step(state, act)

    return before, jax_raw_step(name), jax.jit(jax.vmap(given))


def jax_env_step(name, state, act):
    """The JAX env's step of the vmapped batch, on `jax_env_parts`."""
    before, physics, after = jax_env_parts(name)
    qp, info = physics(state.qp, before(state.qp, act))
    return after(state, act, qp, info)


def to_jax_state(state, metrics):
    from brax_tpu.envs import base as jax_base

    num = lambda t: jnp.asarray(t.detach().cpu().numpy())
    return jax_base.State(qp=tp.to_jax_qp(state.qp), obs=num(state.obs), reward=num(state.reward),
                          done=num(state.done), metrics={k: num(state.metrics[k]) for k in metrics})


def one_pass(sys):
    return dataclasses.replace(sys, substeps=2)


def from_jax_qp(jqp):
    return QP.from_numpy(*tp.qp_numpy(jqp), device="cpu")
