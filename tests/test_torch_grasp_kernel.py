"""The generated PBD kernel of v1 grasp: its header and plan, and its lane
logic in the CPU's warp emulation (tests/pbd_emulation.py), against the
twin.

grasp is the first scene to compile PBD_SPHERICAL, PBD_CAPCAP and
PBD_ANGLE together, and adds two sections: PBD_CAPCAP_ONEWAY (a one-way
capsule-capsule lane, the ball against the frozen palm: the capsule-capsule
contact point, then the one-way update of body a alone) and, from
PBD_SPHERICAL with PBD_ANGLE, PBD_SPHERICAL_ANGLE (each dof of a spherical
joint's angle actuator PDs toward its action's angle).  Held here, every
env within `pbd_parity.TOLERANCE` of the twin: grasp from a reset and with
its claw closed on the ball (`pbd_parity.grasp_states`), over the whole
step and over one pass; `grasp_padded` (padded dofs, which PD toward
clip(0, lo, hi)) and `pusher_oneway` (a one-way pair whose body b moves:
it must not move it), Systems made for what no default scene has
(`pbd_parity.padded_grasp`, `oneway_pusher`); the frozen palm, a joint
parent that the env moves between steps, kept in place by its body masks.
The earlier scenes' sources (tests/test_torch_pbd_launch.py's eleven)
hold none of the new sections:
preprocessed, each is its source with every PBD_CAPCAP_ONEWAY and
PBD_SPHERICAL_ANGLE block cut out, token for token (their headers are the
parent's; on the card `python -m brax_torch.tools.pbd_turns` compares the
builds' SASS).  No JAX, no card.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from brax_torch.envs.grasp import Grasp
from brax_torch.sim import colliders, kernels
from brax_torch.tools.pbd_parity import (GRASP_STATES, TOLERANCE, capcap_state,
                                         fingertips_on_ball, grasp_states, one_pass,
                                         oneway_pusher, padded_grasp)

from tests import pbd_emulation
from tests.test_torch_cuda import _without_blocks
from tests.test_torch_pbd_launch import SCENES, Scene, _array, _config, _system
from tests.torch_parity import one_torch_thread  # noqa: F401

N = 17
NEW_SECTIONS = ("PBD_CAPCAP_ONEWAY", "PBD_SPHERICAL_ANGLE")


def _grasp(n=N):
    env = Grasp(batch_size=n, device="cpu")
    return env, grasp_states(env, n, 0, "cpu")


def _within_tolerance(sys, qp, act):
    errs = pbd_emulation.max_errors(sys, qp, act)
    assert all(errs[k] <= TOLERANCE[k] for k in TOLERANCE), errs


def test_grasp_header_and_plan():
    """16 bodies (a lane each, half a warp), 12 spherical joints and angle
    actuators, 7 contacts: 16 lanes, 2 envs a warp; the one-way pair's lane
    flagged in CONTACT_ONEWAY, its capsule-capsule record in CAPCAP_F, its
    body a (the ball) gathering it and its body b (the palm) not; all 39
    action columns taken."""
    env = Grasp(batch_size=1, device="cpu")
    sys = env.sys
    p = kernels.plan(sys)
    header = kernels.scene_header(sys)
    assert (p.nb, p.nj, p.na, p.nc, p.lanes, p.envs_per_block, p.passes) == (
        16, 12, 12, 7, 16, 2, 2)
    for define in ("PBD_SPHERICAL", "PBD_CAPCAP", "PBD_ANGLE", "PBD_CAPCAP_ONEWAY"):
        assert f"#define {define} 1\n" in header
    assert kernels.unsupported_features(sys, env.action_size) == [] and env.action_size == 39
    kinds = [(type(c).__name__, bool(c.com.one_way)) for c in sys.contact_groups]
    assert kinds == [("CapsulePlane", True), ("CapsuleCapsule", True), ("CapsuleCapsule", False)]
    oneway = [False, False, True, False, False, False, False]
    assert list(p.contact_oneway) == oneway
    assert list(p.contact_capcap) == [False, False, False, True, True, True, True]
    np.testing.assert_array_equal(_array(header, "CONTACT_ONEWAY")[:p.nc], oneway)
    g = sys.contact_groups[1]
    a, b = int(g.com.body_a[0]), int(g.com.body_b[0])
    assert (a, b) == (env.art.body_index["Object"], env.art.body_index["HandPalm"])
    record = _array(header, "CAPCAP_F")[:, 2]
    np.testing.assert_array_equal(record[kernels.CC_END_A:kernels.CC_END_A + 3], g.end_a[0])
    np.testing.assert_array_equal(record[kernels.CC_OFF_B:kernels.CC_OFF_B + 3], g.off_b[0])
    assert record[kernels.CC_RADIUS_B] == g.radius_b[0] and record[kernels.CC_FRICTION] == 1.0
    assert not _array(header, "CONTACT_F")[:, 2].any()
    assert 2 in p.body_contacts[1][a] and not any(2 in x for g_ in p.body_contacts_b for x in g_)
    assert [c for c in _array(header, "BODY_CON_B").reshape(-1) if c >= 0] == [3, 4, 5, 6]
    assert list(p.act_angle) == [True] * 12 and p.last_act_col == 35


@pytest.mark.parametrize("state", GRASP_STATES)
def test_grasp_lane_logic_matches_twin_in_emulation(state):
    """grasp's kernel in emulation, over the whole step and over one pass,
    every env within TOLERANCE of the twin: from a reset (the palm moved to
    random targets, targets across the joints' limits) and with all four
    fingertips on the ball (the two-way pairs, the one-way palm pair and
    the floor all in contact)."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env, states = _grasp()
    qp, act = states[state]
    assert act.shape == (N, 39)
    if state == GRASP_STATES[1]:
        assert fingertips_on_ball(env, qp) == 1.0
    _within_tolerance(env.sys, qp, act)
    _within_tolerance(one_pass(env.sys), qp, act)


def test_padded_spherical_angle_dofs_in_emulation():
    """grasp_padded: 11 actuators' dof 0 has no action column.  Each PDs
    toward clip(0, lo, hi), which the twin shows is not what its action
    would give (the step moves by radians a second), and the emulated
    kernel holds every env within TOLERANCE."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env, states = _grasp()
    sys = padded_grasp(env.sys)
    assert [c[0] for c in kernels.plan(sys).act_col] == [0] + [-1] * 11
    qp, act = states[GRASP_STATES[1]]
    padded, _ = kernels.pbd_step_plain(sys, qp, act)
    full, _ = kernels.pbd_step_plain(env.sys, qp, act)
    assert float((padded.ang - full.ang).abs().max()) > 1.0
    _within_tolerance(sys, qp, act)


def test_oneway_pair_with_a_moving_body_b_in_emulation():
    """pusher_oneway: pusher's arm-object pairs made one-way, the object (body
    b) free to move, from states whose pairs overlap.  The twin moves body
    a alone (no contact impulse on the object), and the emulated kernel
    holds every env within TOLERANCE over one pass and the whole step."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env = Scene(_config("pusher"), batch_size=9, device="cpu")
    sys = oneway_pusher(env.sys)
    p = kernels.plan(sys)
    assert p.oneway and not any(p.contact_capcap) and p.width_b == 1
    qp, act = capcap_state("pusher", env, 9, seed=0, device="cpu")
    g = next(c for c in sys.contact_groups if isinstance(c, colliders.CapsuleCapsule))
    _, info = kernels.pbd_step_plain(one_pass(sys), qp, act)
    assert not info.contact.vel[:, int(g.com.body_b[0])].any()
    assert float(info.contact.vel[:, np.unique(g.com.body_a)].abs().max()) > 1.0
    _within_tolerance(one_pass(sys), qp, act)
    _within_tolerance(sys, qp, act)


def test_frozen_palm_stays_in_place():
    """The palm, frozen and the parent of four joints, keeps its position
    and rotation and has no velocity after the kernel's step (emulated) and
    the twin's: its joint and contact updates die in its body masks."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env, states = _grasp(5)
    qp, act = states[GRASP_STATES[1]]
    palm = env.art.body_index["HandPalm"]
    twin, _ = kernels.pbd_step_plain(env.sys, qp, act)
    emulated = pbd_emulation.emulate(env.sys, qp, act)
    twin = {"pos": twin.pos, "rot": twin.rot, "vel": twin.vel, "ang": twin.ang}
    for out in (twin, dict(zip(TOLERANCE, emulated))):
        assert torch.equal(out["pos"][:, palm], qp.pos[:, palm])
        assert torch.equal(out["rot"][:, palm], qp.rot[:, palm])
        assert not out["vel"][:, palm].any() and not out["ang"][:, palm].any()


def test_earlier_scenes_preprocess_as_without_the_new_sections():
    """Each earlier scene's source, preprocessed, is token for token the
    source with every PBD_CAPCAP_ONEWAY and PBD_SPHERICAL_ANGLE block cut
    out; grasp's is not."""
    cpp = shutil.which("cpp")
    if cpp is None:
        pytest.skip("needs the host C preprocessor")

    def tokens(text):
        text = text.replace("#include <cuda_runtime.h>\n", "").replace("#include <math.h>\n", "")
        out = subprocess.run([cpp, "-P", "-x", "c++", "-"], input=text, capture_output=True,
                             text=True, check=True).stdout
        return [line for line in out.splitlines() if line.strip()]

    systems = {name: _system(name) for name in SCENES}
    systems["grasp"] = Grasp(batch_size=1, device="cpu").sys
    assert len(systems) == 12
    for name, sys in systems.items():
        whole = kernels.kernel_source(sys).read_text()
        cut = _without_blocks(whole, NEW_SECTIONS)
        assert "#ifdef PBD_CAPCAP_ONEWAY" in whole and "#ifdef PBD_CAPCAP_ONEWAY" not in cut
        assert (tokens(whole) == tokens(cut)) == (name != "grasp"), name
