"""biggym's match scenes (register_matches) against the JAX package's, on
the CPU: the reset and one step from it (tests/biggym_parity.py: the port's
physics handed to the JAX env; obs, the (N, 2) per-agent reward and
metrics at 1e-3): the race match (each agent's own forward speed) and the
sumo match (ma_descs' sumo: the ring's 20 frozen segments, 39 bodies)."""

from tests import biggym_parity as bp
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_race_match_matches_jax():
    state = bp.scene_matches("match_race_ma__ant_ant__proant_ant", seed=8)
    assert state.reward.shape == (bp.N, 2)


def test_sumo_match_matches_jax():
    state = bp.scene_matches("match_sumo__ant_ant__proant_ant", seed=9)
    assert state.reward.shape == (bp.N, 2)
