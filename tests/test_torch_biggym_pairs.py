"""biggym's two-agent track scenes against the JAX package's, on the CPU:
the reset and one step from it (tests/biggym_parity.py: the port's physics
handed to the JAX env; obs, the (N, 2) reward and metrics at 1e-3).
chase_proant_ant (two 4-legged pro ants, the chase edge's reward) and
sumo_proant_ant (the distance reward; 117 contact points, the most of any
scene) are held; sumo_ant_ant (the composer chase's System under the sumo
task, the same task code as sumo_proant_ant) is slow."""

import pytest

from tests import biggym_parity as bp
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_chase_proant_ant_matches_jax():
    state = bp.scene_matches("chase_proant_ant", seed=5)
    assert state.reward.shape == (bp.N, 2)


def test_sumo_proant_ant_matches_jax():
    state = bp.scene_matches("sumo_proant_ant", seed=6)
    assert state.reward.shape == (bp.N, 2)


@pytest.mark.slow  # another JAX reset jit and step jit
def test_sumo_ant_ant_matches_jax():
    state = bp.scene_matches("sumo_ant_ant", seed=7)
    assert state.reward.shape == (bp.N, 2)
