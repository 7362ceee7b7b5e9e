"""v1 legacy-spring inverted_pendulum and inverted_double_pendulum of
brax_torch against the JAX package, on the CPU (tests/spring_parity.py).

For each: the System `legacy_spring=True` builds, leaf for leaf (spring
revolute joints with (0, 0) limits, the cart's thruster, no actuators);
the twin's whole step against the JAX jnp `_spring_step` from a reset (the
double pendulum's: default_qp, both angles 0) and a jiggled state; the
generated kernel in the CPU's warp emulation against the twin, 10 twin
steps after that state.  inverted_pendulum's env resets and steps PAIRS'
10 steps as the JAX env's; inverted_double_pendulum's cannot reset in
either package: its hinges' (0, 0) limits give no default angles
(`initial.default_angle` counts only dofs with limits) for its two joint
noise draws, a broadcast error in both, which the port follows.
"""

import jax
import numpy as np
import pytest
import torch

from brax_torch import envs

from tests import pbd_emulation
from tests import spring_parity as sp
from tests.torch_parity import one_torch_thread  # noqa: F401

SCENES = ("inverted_pendulum", "inverted_double_pendulum")


@pytest.mark.parametrize("name", SCENES)
def test_builds_the_jax_system(name):
    sp.assert_same_system(name)


@pytest.mark.parametrize("name", SCENES)
def test_twin_matches_jax_spring_step(name):
    sp.assert_twin_matches_jax_step(name)


@pytest.mark.parametrize("name", SCENES)
def test_kernel_lane_logic_in_emulation(name):
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    sp.assert_emulation_matches_twin(name)


def test_inverted_pendulum_env_matches_jax():
    sp.assert_env_matches_jax("inverted_pendulum")


def test_inverted_double_pendulum_cannot_reset_in_either_package():
    """The JAX env's reset raises (default_angle (0,) against a (2,) noise
    draw), and so does the port's; the port's env still steps its spring
    System from default_qp, as the JAX System does."""
    jax_env = sp.jax_env("inverted_double_pendulum")
    assert jax_env.default_angle().shape == (0,) and jax_env.sys.num_joint_dof == 2
    with pytest.raises((TypeError, ValueError)):
        jax_env.reset(jax.random.PRNGKey(0))
    env = envs.create("inverted_double_pendulum", batch_size=2, device="cpu",
                      legacy_spring=True)
    assert env.unwrapped.default_angle().shape == (0,)
    with pytest.raises(RuntimeError, match="must match the size"):
        env.reset(torch.Generator().manual_seed(0))
    qp = sp.states("inverted_double_pendulum")["reset"]
    out, _ = env.sys.step(qp, torch.zeros((sp.N, 1)))
    assert np.isfinite(out.pos.numpy()).all()
