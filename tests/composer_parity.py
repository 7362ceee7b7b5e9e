"""Shared JAX references for the tests of the port's composer on the CPU.

Each JAX function is jitted once per process (the lru_caches below; the
physics is tests/grasp_parity.py's one-pass jnp step, jitted once per
scene and looped) and shared by tests/test_torch_composer*.py.  Inputs are
numpy arrays or port tensors made from fixed seeds and handed to both
packages.  Scenes are named as the composer's registry names its tasks;
"chase4" is the 4-agent chase of brax_torch/tools/bench_composer.py.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np

from brax_tpu.composer import envs as jax_composer_envs
from brax_tpu.envs import base as jax_base
from brax_torch.sim.types import QP
from brax_torch.tools import pbd_parity as pp

from tests import grasp_parity as gp
from tests import torch_parity as tp

N = 16
# scene: (task, desc kwargs), the port's list
SCENES = pp.COMPOSER_SCENES
# tests/test_torch_halfcheetah.py's env tolerance: obs, reward and metrics
# after a step from a shared state; positions 1e-4
ENV_TOL = 1e-3


@functools.lru_cache(maxsize=None)
def jax_env(scene):
    """The bare JAX ComponentEnv of `scene`."""
    task, kw = SCENES[scene]
    return jax_composer_envs.create_env(task, episode_length=None, auto_reset=False,
                                        **kw).unwrapped


@functools.lru_cache(maxsize=None)
def port_env(scene, n=N):
    """The bare port ComponentEnv of `scene` on the CPU, n envs."""
    return pp.composer_env(scene, n, "cpu")


@functools.lru_cache(maxsize=None)
def jax_reset(scene):
    """The JAX env's reset State (it draws nothing: one State for every env)."""
    return jax.jit(jax_env(scene).reset)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def jax_env_step_given(scene):
    """(state, act, qp, info) -> state: the JAX env's step, vmapped and
    jitted, with its physics result given (tests/torch_parity.py's
    _GivenPhysics), so that the physics compiles once (`jax_physics`)."""
    def step(state, act, qp, info):
        env = copy.copy(jax_env(scene))
        env.sys = tp._GivenPhysics(env.sys, qp, info)
        return env.step(state, act)

    return jax.jit(jax.vmap(step))


# scenes whose Systems are another's, table for table (the agents' places
# are in the reset, not in the System): their physics shares its jit
SAME_SYSTEM = {"ant_chase": "chase", "follow": "chase"}


def jax_physics(scene, qp, act, passes=None):
    """(qp, info) of the JAX jnp physics step of the scene (one pass jitted
    once per System and looped, traced in the JAX package's kernel mode)
    on a port QP and a numpy action."""
    scene = SAME_SYSTEM.get(scene, scene)
    return gp.jax_raw(("composer", scene), jax_env(scene).sys, qp, act, passes)


def to_jax_state(state):
    """A JAX env State holding a port env State's numbers."""
    num = lambda t: jnp.asarray(t.detach().cpu().numpy())
    return jax_base.State(qp=tp.to_jax_qp(state.qp), obs=num(state.obs),
                          reward=num(state.reward), done=num(state.done),
                          metrics={k: num(v) for k, v in state.metrics.items()})


def port_qp(jqp):
    return QP.from_numpy(*tp.qp_numpy(jqp), device="cpu")


def actions(scene, seed, steps, n=N):
    """(steps, n, action_size) float32 actions uniform in [-1, 1]."""
    size = port_env(scene).action_size
    return np.random.RandomState(seed).uniform(-1, 1, (steps, n, size)).astype(np.float32)


def broadcast(x, n=N):
    """A JAX reset's per-env array repeated over n envs."""
    x = np.asarray(x)
    return np.broadcast_to(x, (n,) + x.shape)
