"""Faults planted in the PBD kernel's legacy-spring section
(tests/pbd_faults.py) fail the rounding rule in the CPU's warp emulation.

Planted: `spring_hinge_sign` (a spring revolute joint turns its child's
hinge axis away from the parent's; ant), `universal_torque_sign` (a
universal joint's axis-holding torque takes the other sign;
humanoid_legacy), `spring_count_all_groups` (a contact impulse averaged
over its body's non-zero impulses of the groups before its own too;
halfcheetah from its feet together, where a foot's floor and feet-pair
groups both act) and `spring_forces_twice` (a body adds its thrusters
twice; inverted_pendulum).  Each planted source is emulated over the whole
step from its scene's two states (`tests.pbd_faults.spring_states`) and
its output read by `pbd_parity.rounding_rule` against the twin: the rule
fails each fault from some state, and the correct kernel passes it from
both.  On the
card, `python -m tests.pbd_faults ant_spring humanoid_legacy_spring
halfcheetah_spring inverted_pendulum_spring` reads the same faults at 4096
envs.
"""

import pytest
import torch

from brax_torch.tools.pbd_parity import TOLERANCE, rounding_rule

from tests import pbd_emulation, pbd_faults
from tests.torch_parity import one_torch_thread  # noqa: F401

N = 9
FAULTS = ("spring_hinge_sign", "universal_torque_sign", "spring_count_all_groups",
          "spring_forces_twice")


def _read(name, source):
    """{state: rounding_rule's verdict} of the emulated `source` over the
    whole step from each state of spring scene `name`."""
    env = pbd_faults.scene_env(name, N, "cpu")
    verdicts = {}
    for state, (qp, act) in pbd_faults.spring_states(name, env, N, "cpu").items():
        got = dict(zip(TOLERANCE, pbd_emulation.emulate(env.sys, qp, act, source)))
        r = rounding_rule(env.sys, qp, act, got, torch.Generator().manual_seed(7))
        verdicts[state] = (r["passes"], len(r["outliers"]), r["errs"])
    return verdicts


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_spring_fault_fails_the_rounding_rule(fault):
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    (name,) = pbd_faults.FAULT_SCENES[fault]
    verdicts = _read(name, pbd_faults.planted_text(fault))
    assert not all(v[0] for v in verdicts.values()), verdicts


@pytest.mark.parametrize("name", sorted({pbd_faults.FAULT_SCENES[f][0] for f in FAULTS}))
def test_correct_kernel_passes_the_rounding_rule(name):
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    verdicts = _read(name, None)
    assert all(v[0] and v[1] == 0 for v in verdicts.values()), verdicts
