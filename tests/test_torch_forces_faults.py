"""Faults planted in the PBD kernel's thruster/twister and angle-actuator
sections (tests/pbd_faults.py: a thruster's sign, the body a force lands
on, the Pallas body's clip of the force columns, an angle actuator's
degrees and sign) fail the rounding rule in the CPU's warp emulation.

Each planted source is emulated over one pass (`pbd_parity.one_pass`)
from the state tests/test_torch_forces_emulation.py holds the kernel in
(10 twin steps, `pbd_parity.physics_actions`), and its output read by
`pbd_parity.rounding_rule` against the twin: the rule the card holds the
kernel to can fail a wrong kernel.  On the card, `python -m
tests.pbd_faults inverted_pendulum inverted_double_pendulum swimmer
reacherangle` reads the same faults at 4096 envs.
"""

import pytest
import torch

from brax_torch.tools.pbd_parity import TOLERANCE, one_pass, physics_actions, rounding_rule

from tests import pbd_emulation, pbd_faults
from tests.test_torch_pbd_launch import Scene, _config, scene_state
from tests.torch_parity import one_torch_thread  # noqa: F401

# one scene per fault, where it changes the step
PLANTED = {"thruster_sign": "swimmer", "force_body": "swimmer",
           "reference_clip": "inverted_pendulum", "angle_degrees": "reacherangle",
           "angle_sign": "reacherangle"}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_force_fault_fails_the_one_pass_rule(fault):
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    name = PLANTED[fault]
    assert name in pbd_faults.FAULT_SCENES[fault]
    n = pbd_emulation.FORCE_SCENES[name]
    env = Scene(_config(name), batch_size=n, device="cpu")
    qp, act = scene_state(env, n, steps=10, seed=0, device="cpu",
                          draw=lambda gen: physics_actions(name, n, gen, "cpu"))
    sys = one_pass(env.sys)
    got = dict(zip(TOLERANCE, pbd_emulation.emulate(sys, qp, act,
                                                    pbd_faults.planted_text(fault))))
    r = rounding_rule(sys, qp, act, got, torch.Generator().manual_seed(7))
    assert not r["passes"], (len(r["outliers"]), r["errs"])
