"""octopus_run against the JAX package, on the CPU.

The octopus component (a copy of `brax_tpu/composer/assets/octopus.py`:
27 bodies in a tentacle tree under a frozen root, every joint a spring
hinge) composed with the ground: the System leaf for leaf, its widths and
component indices; the twin's whole legacy-spring step against the JAX
jnp spring step (one jitted substep looped, traced in the JAX package's
kernel mode; tests/spring_parity.py) from pbd_parity.octopus_states' reset
and jiggled state at tests/test_pallas_kernel.py's spring bounds
(STEP_BOUNDS), the reset, whose tentacle tips sit on the floor to the last
bit, by the chaos rule (no env of the 16 may stray); and the env against
the JAX env over a few steps from a shared state (tests/
test_torch_composer_envs.py's check: positions 1e-4, obs, reward and
metrics 1e-3, done exactly).  And the kernel's source for it, preprocessed,
compiles the spring substep and the wide exchange and no warp-only code.
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.sim import lowering
from brax_tpu.sim import system as jax_system
from brax_torch.composer import components
from brax_torch.sim import kernels
from brax_torch.sim.system import flatten
from brax_torch.tools import pbd_parity as pp

from tests import composer_parity as cp
from tests import spring_parity as sp
from tests import torch_parity as tp
from tests.test_torch_composer import _assert_tables_equal
from tests.test_torch_composer_envs import _steps_match
from tests.torch_parity import one_torch_thread  # noqa: F401

SCENE = pp.OCTOPUS


def test_octopus_system_matches_jax():
    """The composed System table for table, the widths (63 observations,
    26 actions), the component's indices; legacy spring, 28 bodies, 26
    spring hinges, one one-way capsule-plane group of 50 points; the
    component alone as the JAX one."""
    env, jenv = cp.port_env(SCENE, 2), cp.jax_env(SCENE)
    _assert_tables_equal(flatten(env.sys), flatten(jenv.sys))
    assert (env.sys.dynamics_mode, env.sys.num_bodies) == ("legacy_spring", 28)
    assert [(g.kind, g.n) for g in env.sys.joint_groups] == [("spring_revolute", 26)]
    assert [(type(c).__name__, bool(c.com.one_way)) for c in env.sys.contact_groups] == [
        ("CapsulePlane", True)]
    assert (env.observation_size, env.action_size) == (jenv.observation_size, jenv.action_size)
    assert (env.observation_size, env.action_size) == (63, 26)
    assert env.agent_names == jenv.agent_names
    for name, meta in env.component_meta.items():
        jmeta = jenv.component_meta[name]
        for key in ("body_idx", "root_idx", "joint_dof_idx", "act_idx", "observers"):
            assert meta[key] == jmeta[key], (name, key)
    from brax_tpu.composer import components as jax_components

    spec, jspec = components.load_component("octopus"), jax_components.load_component("octopus")
    assert (spec.root, spec.collides, spec.observers) == (jspec.root, jspec.collides,
                                                          jspec.observers)
    assert len(spec.config.bodies) == len(jspec.config.bodies) == 27


@functools.lru_cache(maxsize=None)
def _jax_substep():
    sys = cp.jax_env(SCENE).sys.replace(substeps=1)
    return jax.jit(jax.vmap(lambda qp, act: jax_system._raw_step(sys, qp, act)))


def _jax_step(qp, act):
    """The JAX jnp spring step of octopus_run: `substeps` jitted substeps,
    the contact impulses summed from the left."""
    jqp, act, contact = tp.to_jax_qp(qp), jnp.asarray(act.numpy()), None
    with lowering.kernel_mode():  # read while the first call traces
        for _ in range(cp.jax_env(SCENE).sys.substeps):
            jqp, info = _jax_substep()(jqp, act)
            contact = info.contact if contact is None else contact + info.contact
    return sp.jax_fields(jqp, info.replace(contact=contact))


def test_twin_matches_jax_spring_step():
    env = cp.port_env(SCENE)
    states = pp.octopus_states(env, cp.N, 0, "cpu")
    for label in (pp.OCTOPUS_STATES[0], pp.OCTOPUS_STATES[2]):
        qp, act = states[label]
        twin = pp.fields(*kernels.pbd_step_plain(env.sys, qp, act))
        want = _jax_step(qp, act)
        if pp.RULES[SCENE][label][1] == "chaos_rule":
            report, strays, _ = pp.chaos_rule(env.sys, qp, act, want, twin, tol=sp.STEP_BOUNDS)
            assert len(strays) == 0, (label, report)
            continue
        for k in sp.OUTPUTS:
            err = float((twin[k] - want[k]).abs().max())
            assert err <= sp.STEP_BOUNDS[k], (label, k, err)


def test_env_steps_match_jax():
    state = _steps_match(SCENE, seed=7)
    assert state.reward.shape == (cp.N,)
    assert bool(torch.isfinite(state.obs).all())
    np.testing.assert_array_equal(state.done.numpy(), np.zeros(cp.N, np.float32))


def test_octopus_source_holds_no_warp_code():
    """octopus_run's source, preprocessed, compiles the spring substep and
    the wide exchange, and no shuffle or warp barrier: every exchange is
    the block's shared-memory one."""
    from tests.test_torch_octopus_kernel import _tokens

    if shutil.which("cpp") is None:
        pytest.skip("needs the host C preprocessor")
    text = _tokens(cp.port_env(SCENE, 1).sys)
    assert "spring_substep" in text and "pbd_xchg" in text and "__syncthreads" in text
    for word in ("__shfl_sync", "__syncwarp", "FULL_MASK", "0xffffffff"):
        assert word not in text, word
