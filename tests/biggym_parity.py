"""Shared JAX references for the tests of the port's biggym on the CPU.

The JAX package's biggym registry is module state that its own
tests/test_biggym.py fills (and asserts on) in whatever worker process
runs it, so these tests leave it alone: the JAX registry's names, tracks
and pools come from a subprocess that fills it (`register_all()` then
`register_matches()`, `jax_registry`), and each JAX scene is built from
the JAX `biggym.tasks` factories the registry calls, over the registry's
components (`jax_env`).  The port's registry is filled once per process
(`pbd_parity.biggym_registry`).

A scene's env is held to the JAX package's from a shared state: the port
steps its own physics (the PBD twin, `kernels.pbd_step_plain`) and the JAX
env is handed that physics result (tests/torch_parity.py's
_GivenPhysics), so that only the JAX env's observation and reward code
compiles (a jit per scene), not the JAX physics of each new System; the
Systems themselves are held leaf for leaf (tests/test_torch_biggym.py)
and the twin to the JAX physics by the composer's and the PBD scenes'
tests.  The JAX resets (which draw nothing for a composed scene) are
jitted once per scene, 5-14 s each here.
"""

import copy
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from brax_torch.sim import kernels
from brax_torch.sim import types as port_types
from brax_torch.tools import pbd_parity as pp

from tests import composer_parity as cp
from tests import torch_parity as tp

N = 8
# tests/test_torch_composer_envs.py's tolerances: obs, reward and metrics
# after a step from a shared state; the reset's qp 1e-6 and obs 1e-5
ENV_TOL = cp.ENV_TOL
# the 12 scenes of the registry, in its order
SCENES = (
    "race_ant_ant", "sumo_ant_ant", "jump_cheetah", "race_proant_ant", "chase_proant_ant",
    "sumo_proant_ant", "match_race_ma__ant_ant__proant_ant", "match_sumo__ant_ant__proant_ant",
    "match_onigokko_prey__ant_ant__proant_ant", "match_onigokko_prey__proant_ant__ant_ant",
    "match_onigokko_predator__ant_ant__proant_ant",
    "match_onigokko_predator__proant_ant__ant_ant",
)


_JAX_REGISTRY = """
import json
from brax_tpu import biggym
from brax_tpu.biggym import tasks
biggym.register_all()
biggym.register_matches()
print(json.dumps({
    "envs": list(biggym.ENVS), "tracks": biggym.ENVS_BY_TRACKS,
    "pools": biggym.COMPONENTS_BY_TRACKS, "components": biggym.COMPONENTS,
    "registries": {k: {**{f: r[f] for f in ("envs", "components", "task_envs")},
                       "metadata": sorted(r["metadata"])}
                   for k, r in biggym.REGISTRIES.items()},
    "list_env": biggym.list_env(),
    "tasks": [list(tasks.TASKS), list(tasks.MATCH_TASKS), tasks.SYMMETRIC_MA_TASKS,
              tasks.ASYMMETRIC_MA_TASKS]}))
"""


@functools.lru_cache(maxsize=None)
def jax_registry():
    """The JAX biggym registry after register_all() and register_matches(),
    filled in a subprocess: {"envs", "tracks", "pools", "components",
    "registries", "list_env", "tasks"} (tuples as lists)."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(root),
                                                        os.environ.get("PYTHONPATH")]))}
    out = subprocess.run([sys.executable, "-c", _JAX_REGISTRY], cwd=root, env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def registry():
    """The port's biggym, its registry filled once."""
    return pp.biggym_registry()


def bare(env):
    return env.unwrapped if hasattr(env, "unwrapped") else env


@functools.lru_cache(maxsize=None)
def _jax_components():
    """The JAX composer registry with the two submissions' components under
    the registry's names (what the JAX register_all registers)."""
    from brax_tpu.biggym.registry.ant.components import ant as jax_ant
    from brax_tpu.biggym.registry.proant.components import ant as jax_proant
    from brax_tpu.composer import components as jax_components

    jax_components.register_component("ant_ant", jax_ant.get_specs)
    jax_components.register_component("proant_ant", jax_proant.get_specs)


def new_jax_env(scene):
    """The bare JAX env of `scene`, built as the JAX registry builds it: a
    task env by `tasks.TASKS[task](component)`, a match by
    `tasks.MATCH_TASKS[task](c1, opponent=c2)`, jump_cheetah its class.
    A cached env's System read after a traced step of it held a tracer
    (jump_cheetah's), so a test that reads a System takes a new env."""
    from brax_tpu.biggym import tasks as jax_tasks

    if scene == "jump_cheetah":
        from brax_tpu.biggym.registry.jump.envs.cheetah import JumpCheetah

        return JumpCheetah()
    _jax_components()
    if scene.startswith("match_"):
        task, comp1, comp2 = scene[len("match_"):].split("__")
        make = jax_tasks.MATCH_TASKS[task](comp1, opponent=comp2)
    else:
        task, comp = scene.split("_", 1)
        make = jax_tasks.TASKS[task](comp)
    return bare(make(episode_length=None, auto_reset=False))


jax_env = functools.lru_cache(maxsize=None)(new_jax_env)


@functools.lru_cache(maxsize=None)
def port_env(scene, n=N):
    """The bare port env of `scene` on the CPU, n envs."""
    return pp.biggym_env(scene, n, "cpu")


@functools.lru_cache(maxsize=None)
def jax_reset(scene):
    return jax.jit(jax_env(scene).reset)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def jax_env_step_given(scene):
    """(state, act, qp, info) -> state: the JAX env's step, vmapped and
    jitted, with its physics result given."""
    def step(state, act, qp, info):
        env = copy.copy(jax_env(scene))
        env.sys = tp._GivenPhysics(env.sys, qp, info)
        return env.step(state, act)

    return jax.jit(jax.vmap(step))


def to_jax_info(info):
    """A JAX Info holding a port Info's numbers (batch-first)."""
    from brax_tpu.sim import types as jax_types

    def conv(x):
        if isinstance(x, torch.Tensor):
            return jnp.asarray(x.detach().cpu().numpy())
        if isinstance(x, port_types.DP):
            return jax_types.DP(vel=conv(x.vel), ang=conv(x.ang))
        if isinstance(x, port_types.DQ):
            return jax_types.DQ(pos=conv(x.pos), rot=conv(x.rot))
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x

    return jax_types.Info(contact=conv(info.contact), joint=conv(info.joint),
                          actuator=conv(info.actuator), contact_pos=conv(info.contact_pos),
                          contact_normal=conv(info.contact_normal),
                          contact_penetration=conv(info.contact_penetration))


def reset_matches(scene):
    """The port's reset of a composed scene against the JAX reset's (which
    draws nothing: one State for every env)."""
    state = port_env(scene).reset(torch.Generator().manual_seed(0))
    jstate = jax_reset(scene)
    for got, want in zip(state.qp.numpy(), tp.qp_numpy(jstate.qp)):
        np.testing.assert_allclose(got, cp.broadcast(want, N), atol=1e-6)
    np.testing.assert_allclose(state.obs.numpy(), cp.broadcast(jstate.obs, N), atol=1e-5)
    np.testing.assert_array_equal(state.reward.numpy(), cp.broadcast(jstate.reward, N))
    np.testing.assert_array_equal(state.done.numpy(), cp.broadcast(jstate.done, N))
    assert sorted(state.metrics) == sorted(jstate.metrics)
    return state


def step_matches(scene, state, seed):
    """One step of both envs from `state` (a port State) on uniform actions
    made from `seed`, the port's physics handed to the JAX env; obs, reward
    and metrics at ENV_TOL, done exactly.  Returns the port's State."""
    env = port_env(scene)
    act = np.random.RandomState(seed).uniform(-1, 1, (N, env.action_size)).astype(np.float32)
    qp, info = kernels.pbd_step_plain(env.sys, state.qp, torch.from_numpy(act))
    got = env.step(state, torch.from_numpy(act))
    want = jax_env_step_given(scene)(cp.to_jax_state(state), act, tp.to_jax_qp(qp),
                                     to_jax_info(info))
    for a, b in zip(got.qp.numpy(), tp.qp_numpy(want.qp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), atol=ENV_TOL)
    assert got.reward.shape == np.asarray(want.reward).shape
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(want.reward), atol=ENV_TOL,
                               rtol=ENV_TOL)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    assert sorted(got.metrics) == sorted(want.metrics)
    for k, v in want.metrics.items():
        np.testing.assert_allclose(got.metrics[k].numpy(), np.asarray(v), atol=ENV_TOL,
                                   rtol=ENV_TOL, err_msg=k)
    return got


def scene_matches(scene, seed):
    """A composed scene's reset and one step against the JAX env's."""
    return step_matches(scene, reset_matches(scene), seed)
