"""v1 legacy-spring reacher and reacherangle of brax_torch against the JAX
package, on the CPU (tests/spring_parity.py).

For each: the System `legacy_spring=True` builds, leaf for leaf (two
spring revolute joints, torque or angle actuators, no contacts); the
twin's whole step against the JAX jnp `_spring_step` from a reset and a
jiggled state (reacherangle's targets in degrees, +-300, past its joints'
limits); the generated kernel in the CPU's warp emulation against the
twin, 10 twin steps after a reset; the env's reset and PAIRS' 10 steps
against the JAX env.
"""

import pytest

from tests import pbd_emulation
from tests import spring_parity as sp
from tests.torch_parity import one_torch_thread  # noqa: F401

SCENES = ("reacher", "reacherangle")


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
