"""v1 legacy-spring humanoid_legacy and humanoidstandup of brax_torch against the JAX
package, on the CPU (tests/spring_parity.py).

For each: the System `legacy_spring=True` builds, leaf for leaf (5 spring
revolute, 3 universal and 2 spherical joints, unpadded, with torque
actuators on 1, 2 and 3 dofs; the floor's capsule-plane contacts); the
twin's whole step against the JAX jnp `_spring_step` from a reset and a
jiggled state; the generated kernel (PBD_SPRING_EULER: the three kinds
branch on the joint lanes) in the CPU's warp emulation against the twin,
10 twin steps after a reset; the env's reset and PAIRS' horizon of steps
against the JAX env (obs 227: the spring System's 17 unpadded dofs).
"""

import pytest

from tests import pbd_emulation
from tests import spring_parity as sp
from tests.torch_parity import one_torch_thread  # noqa: F401

SCENES = ("humanoid_legacy", "humanoidstandup")


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


@pytest.mark.parametrize("name", SCENES)
def test_env_matches_jax(name):
    sp.assert_env_matches_jax(name)
