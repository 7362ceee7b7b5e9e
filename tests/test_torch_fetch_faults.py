"""Faults planted in the PBD kernel's box-corner lanes (tests/pbd_faults.py)
fail the rounding rule in the CPU's warp emulation, on fetch.

fetch's one-way box-plane group runs on the capsule-plane lanes, each
corner a record of radius 0, a lower leg's eight corners averaged by its
body lane.  Planted: `corner_radius` (a corner read with a capsule's
radius), `average_by_kg` (a lower leg's position update divided by all 8
corners it gathers, not by those that moved it), `first_corner_only`
(each body gathers only the first corner of its list) and
`box_two_way_sinking` (a corner restitutes by the two-way branch's test,
v_n_old <= 0).  Each planted source is emulated over one pass
(`pbd_parity.one_pass`) from both fetch states (`pbd_parity.fetch_states`)
and its output read by `pbd_parity.rounding_rule` against the twin: the
rule the card holds the kernel to fails each from some state, and the
correct kernel passes it from both.  On the card,
`python -m tests.pbd_faults fetch` reads the same faults at 4096 envs.
"""

import pytest
import torch

from brax_torch.envs.fetch import Fetch
from brax_torch.tools.pbd_parity import (FETCH_STATES, TOLERANCE, fetch_states, one_pass,
                                         rounding_rule)

from tests import pbd_emulation, pbd_faults
from tests.torch_parity import one_torch_thread  # noqa: F401

N = 9
FAULTS = ("corner_radius", "average_by_kg", "first_corner_only", "box_two_way_sinking")


def _read(source):
    """{state: rounding_rule's verdict} of the emulated `source` over one
    pass from each fetch state."""
    env = Fetch(batch_size=N, device="cpu")
    sys = one_pass(env.sys)
    verdicts = {}
    for state, (qp, act) in fetch_states(env, N, 0, "cpu").items():
        got = dict(zip(TOLERANCE, pbd_emulation.emulate(sys, qp, act, source)))
        r = rounding_rule(sys, qp, act, got, torch.Generator().manual_seed(7))
        verdicts[state] = (r["passes"], len(r["outliers"]), r["errs"])
    return verdicts


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_box_fault_fails_the_rounding_rule(fault):
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    assert pbd_faults.FAULT_SCENES[fault] == ("fetch",)
    verdicts = _read(pbd_faults.planted_text(fault))
    assert not all(v[0] for v in verdicts.values()), verdicts


def test_correct_kernel_passes_the_rounding_rule():
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    verdicts = _read(None)
    assert sorted(verdicts) == sorted(FETCH_STATES)
    assert all(v[0] and v[1] == 0 for v in verdicts.values()), verdicts
