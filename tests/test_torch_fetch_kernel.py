"""The generated PBD kernel of v1 fetch: its header and plan, and its lane
logic in the CPU's warp emulation (tests/pbd_emulation.py), against the
twin; hopper's and walker2d's lane logic; the earlier Systems' headers.

fetch's one-way box-plane group needs no section of its own: `pack_tables`
writes each of a box's eight corners as a capsule-plane record with radius
0, as the Pallas body packs it (brax_tpu/sim/kernels.py:347-357), and its
header defines none of the PBD_* sections, as ant's does.  What is new on
the card is eight contacts of one group per body: PBD_KG is 8 (1-2 before),
and a lower leg's average divides by the count of its corners whose update
is non-zero.  Held here, every env within `pbd_parity.TOLERANCE` of the
twin: fetch from a reset and with its feet on the ground
(`pbd_parity.fetch_states`), over the whole step and over one pass; hopper
and walker2d 10 twin steps after a reset.  Every earlier System's header
(tests/test_torch_pbd_launch.py's eleven scenes, grasp, acrobot, ur5e, the
made scenes of `pbd_parity` and the one-pass Systems the card builds) is
the one the parent commit wrote, byte for byte: its SHA-256 prefix is
recorded here.  No JAX, no card.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from brax_torch.envs.acrobot import Acrobot
from brax_torch.envs.fetch import Fetch
from brax_torch.envs.grasp import Grasp
from brax_torch.envs.hopper import Hopper
from brax_torch.envs.ur5e import Ur5e
from brax_torch.envs.walker2d import Walker2d
from brax_torch.sim import colliders, kernels
from brax_torch.tools import pbd_parity as pp

from tests import pbd_emulation
from tests.test_torch_pbd_launch import SCENES, _array, _system, scene_state
from tests.torch_parity import one_torch_thread  # noqa: F401

N = 17
SECTIONS = ("PBD_SPHERICAL", "PBD_CAPCAP", "PBD_CAPCAP_ONEWAY", "PBD_FORCES", "PBD_ANGLE")
# sha256(kernels.scene_header(sys))[:16] of each earlier System, written by
# the parent commit's kernels.py
PARENT_HEADERS = {
    "ant": "02609bd5fc02eb6b",
    "two_legged_ant": "47f3dedae23ce89e",
    "humanoid": "13b13ff4a271cb11",
    "humanoidstandup": "2e10648babe5c017",
    "halfcheetah": "f3e76ac12e1e8e80",
    "pusher": "39e2b8cc85abfd7a",
    "inverted_pendulum": "cd756abb8e6b1368",
    "inverted_double_pendulum": "58965db90740601a",
    "swimmer": "829cdea173452cdc",
    "reacherangle": "adb58a8c99da9e74",
    "reacher": "4a5261cc8efb42f0",
    "grasp": "f39474cce9e23b0f",
    "acrobot": "d6be7dead95e3007",
    "ur5e": "191177a5648ec45d",
    "grasp_padded": "2a4d4ea2148e77b8",
    "pusher_oneway": "64d3b1a4ca9ffc6b",
    "swimmer_twister": "86af361a2ecbdce5",
    "halfcheetah_one_pass": "320ebf1f3a0db5f4",
    "pusher_one_pass": "d1c70956a0e04e45",
    "grasp_one_pass": "c32601969765a84e",
}


def _within_tolerance(sys, qp, act):
    errs = pbd_emulation.max_errors(sys, qp, act)
    assert all(errs[k] <= pp.TOLERANCE[k] for k in pp.TOLERANCE), errs


def test_fetch_header_and_plan():
    """13 bodies, 10 joints and actuators, 32 contacts (a warp's lanes,
    MAX_CONTACTS): 32 lanes, one env a warp; no section defined; each
    contact lane's record is a capsule-plane one whose end is a box corner
    and whose radius is 0; each lower leg gathers its eight corners in
    order (PBD_KG 8), no other body any."""
    env = Fetch(batch_size=1, device="cpu")
    sys = env.sys
    p = kernels.plan(sys)
    header = kernels.scene_header(sys)
    assert (p.nb, p.nj, p.na, p.nc, p.ng, p.lanes, p.envs_per_block, p.passes) == (
        13, 10, 10, 32, 1, 32, 1, 2)
    assert p.widths == (1, 2, 3, 8) and "#define PBD_KG 8\n" in header
    assert not any(f"#define {s} " in header for s in SECTIONS)
    assert not any(p.capcap_record) and kernels.unsupported_features(sys, 10) == []
    (g,) = sys.contact_groups
    records = _array(header, "CONTACT_F")  # [field][lane]
    np.testing.assert_array_equal(records[:3].T, g.corner.reshape(32, 3).numpy())
    assert not records[3].any()
    np.testing.assert_array_equal(records[4], np.repeat(g.com.friction.numpy(), 8))
    np.testing.assert_array_equal(_array(header, "CONTACT_A"), np.repeat(g.com.body_a, 8))
    np.testing.assert_array_equal(_array(header, "CONTACT_B"), [11] * 32)
    con = _array(header, "BODY_CON")[0]  # [k][body lane]
    for b in range(p.lanes):
        listed = [c for c in con[:, b] if c >= 0]
        want = list(range(8 * int(np.flatnonzero(g.com.body_a == b)[0]), 8 * int(
            np.flatnonzero(g.com.body_a == b)[0]) + 8)) if b in g.com.body_a else []
        assert listed == want, b


def test_corner_is_a_capsule_end_of_radius_zero():
    """The twin's box-plane group and a capsule-plane group whose ends are
    the box corners and whose radius is 0, the layout the kernel runs,
    give the same position and velocity passes bit for bit from fetch's
    feet on the ground."""
    env = Fetch(batch_size=N, device="cpu")
    (g,) = env.sys.contact_groups
    caps = colliders.CapsulePlane(com=g.com, end=g.corner, radius=torch.zeros(4))
    qp, act = pp.fetch_states(env, N, 0, "cpu")[pp.FETCH_STATES[1]]
    prev = dataclasses.replace(qp, pos=qp.pos + 1e-3)
    outs = []
    for group in (g, caps):
        dq, dlambda, contact = colliders.position_apply(group, qp, prev, env.sys.solver, 13)
        dp = colliders.velocity_apply(group, qp, dlambda, prev, contact, env.sys.solver, 13)
        outs.append((dq.pos, dq.rot, dlambda, contact.penetration, dp.vel, dp.ang))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert bool((outs[0][2] != 0).any())


@pytest.mark.parametrize("state", pp.FETCH_STATES)
def test_fetch_lane_logic_matches_twin_in_emulation(state):
    """fetch's kernel in emulation, over the whole step and over one pass,
    every env within TOLERANCE of the twin: from a reset (every box corner
    that touches the ground exactly on it) and with 2-4 corners of each
    lower leg's box below the ground."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env = Fetch(batch_size=N, device="cpu")
    qp, act = pp.fetch_states(env, N, 0, "cpu")[state]
    assert act.shape == (N, 10)
    if state == pp.FETCH_STATES[1]:
        assert bool((pp.corners_down(env, qp) >= 1).all())
    _within_tolerance(env.sys, qp, act)
    _within_tolerance(pp.one_pass(env.sys), qp, act)


@pytest.mark.parametrize("cls", [Hopper, Walker2d], ids=["hopper", "walker2d"])
def test_hopper_walker2d_lane_logic_in_emulation(cls):
    """hopper and walker2d (one-way capsule-plane contacts, revolute joints,
    torque actuators: no section) in emulation 10 twin steps after a reset,
    in contact, every env within TOLERANCE of the twin."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env = cls(batch_size=N, device="cpu")
    assert not any(f"#define {s} " in kernels.scene_header(env.sys) for s in SECTIONS)
    qp, act = scene_state(env, N, steps=10, seed=0, device="cpu")
    _within_tolerance(env.sys, qp, act)


def test_earlier_headers_are_the_parents():
    """Each earlier System's header is the parent commit's, byte for byte."""
    systems = {name: _system(name) for name in SCENES}
    systems["grasp"] = Grasp(batch_size=1, device="cpu").sys
    systems["acrobot"] = Acrobot(batch_size=1, device="cpu").sys
    systems["ur5e"] = Ur5e(batch_size=1, device="cpu").sys
    systems["grasp_padded"] = pp.padded_grasp(systems["grasp"])
    systems["pusher_oneway"] = pp.oneway_pusher(systems["pusher"])
    systems["swimmer_twister"] = pp.twister_swimmer("cpu")
    for name in ("halfcheetah", "pusher", "grasp"):
        systems[f"{name}_one_pass"] = pp.one_pass(systems[name])
    got = {name: hashlib.sha256(kernels.scene_header(s).encode()).hexdigest()[:16]
           for name, s in systems.items()}
    assert got == PARENT_HEADERS
