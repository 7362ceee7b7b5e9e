"""biggym's onigokko matches against the JAX package's, on the CPU.  A
predator match of (c1, c2) is the prey match of (c2, c1) (the contributed
component second in ma_descs' chase): both packages build the two as one
desc, so the four scenes are two envs, each held by its reset and one step
from it (tests/biggym_parity.py: the port's physics handed to the JAX env;
obs, the (N, 2) reward and metrics at 1e-3)."""

from brax_torch.sim.system import flatten

from tests import biggym_parity as bp
from tests.test_torch_sim import _assert_tables_equal
from tests.torch_parity import one_torch_thread  # noqa: F401

PAIRS = ("ant_ant__proant_ant", "proant_ant__ant_ant")


def test_prey_ant_against_proant_matches_jax():
    state = bp.scene_matches(f"match_onigokko_prey__{PAIRS[0]}", seed=10)
    assert state.reward.shape == (bp.N, 2)


def test_prey_proant_against_ant_matches_jax():
    """And each predator match is its mirrored prey match, in both packages."""
    state = bp.scene_matches(f"match_onigokko_prey__{PAIRS[1]}", seed=11)
    assert state.reward.shape == (bp.N, 2)
    for prey, predator in zip(PAIRS, reversed(PAIRS)):
        a = bp.port_env(f"match_onigokko_prey__{prey}", 2)
        b = bp.port_env(f"match_onigokko_predator__{predator}", 2)
        _assert_tables_equal(flatten(a.sys), flatten(b.sys))
        assert a.component_meta.keys() == b.component_meta.keys()
        for name, meta in a.component_meta.items():
            for key in ("body_idx", "root_idx", "act_idx", "observers"):
                assert meta[key] == b.component_meta[name][key]
        assert [r[:2] for r in a.composer.reward_descs] == [
            r[:2] for r in b.composer.reward_descs]
        ja = bp.new_jax_env(f"match_onigokko_prey__{prey}")
        jb = bp.new_jax_env(f"match_onigokko_predator__{predator}")
        _assert_tables_equal(flatten(ja.sys), flatten(jb.sys))
