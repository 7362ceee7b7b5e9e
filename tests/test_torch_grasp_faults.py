"""Faults planted in the PBD kernel's grasp sections and its twister branch
(tests/pbd_faults.py) fail the rounding rule in the CPU's warp emulation.

`oneway_pushes_b` (a one-way capsule-capsule lane taking the two-way
branch) and `spherical_angle_sign` (a spherical angle actuator pushing
with a torque actuator's sign) are planted in grasp, from its claw closed
on the ball; `padded_reads_column_0` (a padded dof reading action column
0) in grasp_padded, from the same state; `oneway_static_friction` (the
two-way static-friction test on a one-way lane) in pusher_oneway, from
states whose pairs overlap (grasp's frictions are all 1, where both tests
agree); `twister_sign` in swimmer_twister after 10 twin steps.  Each
planted source is emulated over one pass (`pbd_parity.one_pass`) and its
output read by `pbd_parity.rounding_rule` against the twin: the rule the
card holds the kernel to fails each.  `oneway_static_friction` is read
over pusher's whole step (25 passes): over one pass, from joint
velocities of +-0.1, the slip it holds moves the step by at most 1.6e-3
m/s, inside TOLERANCE; over the whole step by 0.6 m/s.  On the card, `python -m
tests.pbd_faults grasp grasp_padded pusher_oneway swimmer_twister` reads
the same faults at 4096 envs.
"""

import pytest
import torch

from brax_torch.envs.grasp import Grasp
from brax_torch.tools.pbd_parity import (GRASP_STATES, TOLERANCE, capcap_state, grasp_states,
                                         one_pass, physics_actions, rounding_rule)

from tests import pbd_emulation, pbd_faults
from tests.test_torch_pbd_launch import Scene, _config, scene_state
from tests.torch_parity import one_torch_thread  # noqa: F401

PLANTED = {"oneway_pushes_b": "grasp", "spherical_angle_sign": "grasp",
           "padded_reads_column_0": "grasp_padded", "oneway_static_friction": "pusher_oneway",
           "twister_sign": "swimmer_twister"}
# faults read over the whole step; the others over one pass
WHOLE_STEP = ("oneway_static_friction",)


def _scene(name, n):
    """(System, qp, act) of a planted scene, made as tests/pbd_faults.py
    makes it (MADE_SCENES), from its state here."""
    base = pbd_faults.MADE_SCENES.get(name, (name,))[0]
    if base == "grasp":
        env = Grasp(batch_size=n, device="cpu")
        qp, act = grasp_states(env, n, 0, "cpu")[GRASP_STATES[1]]
    else:
        env = Scene(_config(base), batch_size=n, device="cpu")
        if base == "pusher":
            qp, act = capcap_state(base, env, n, seed=0, device="cpu")
    sys = pbd_faults.scene_system(name, env)
    if base == "swimmer":
        qp, act = scene_state(env, n, steps=10, seed=0, device="cpu",
                              draw=lambda gen: physics_actions(base, n, gen, "cpu"))
    return sys, qp, act


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_fault_fails_the_rounding_rule(fault):
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    name = PLANTED[fault]
    assert name in pbd_faults.FAULT_SCENES[fault]
    sys, qp, act = _scene(name, 9)
    sys = sys if fault in WHOLE_STEP else one_pass(sys)
    got = dict(zip(TOLERANCE, pbd_emulation.emulate(sys, qp, act,
                                                    pbd_faults.planted_text(fault))))
    r = rounding_rule(sys, qp, act, got, torch.Generator().manual_seed(7))
    assert not r["passes"], (len(r["outliers"]), r["errs"])
