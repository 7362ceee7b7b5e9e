"""The PBD kernel's wide route (PBD_WIDE) on the CPU: the composer's
multi-agent scenes, whose envs take more lanes than a warp has.

The 2-agent chase (19 bodies, 35 contact points: 64 lanes) and the 4-agent
chase (37 bodies, 170 contact points: 256 lanes) put one env in a block of
`lanes` threads, whose lanes exchange through shared memory where a warp's
shuffle.  Held here: their plans and headers (lanes, block shape, the
per-body gather lists past a warp), every one-warp System's header byte for
byte as the parent commit's kernels.py writes it and its source, once
preprocessed, as the source without the wide route; the generated kernel
in the CPU emulation (tests/pbd_emulation.py: a block of 64-256 threads,
`__syncthreads` a barrier) against the twin from a reset and 10 twin steps
after it by TOLERANCE, and with the ants overlapping (a chaotic step: the
twin itself, under 1e-6 input noise, leaves TOLERANCE in ~57% of the
2-agent chase's envs) by the chaos rule; and faults planted in the wide
route (tests/pbd_faults.py) failing the rounding rule over one pass.
"""

import hashlib
import shutil
import subprocess

import pytest
import torch

from brax_torch.composer import envs as cenvs
from brax_torch.sim import kernels
from brax_torch.tools import pbd_parity as pp

from tests import pbd_emulation, pbd_faults
from tests.test_torch_cuda import _without_blocks
from tests.test_torch_fetch_kernel import PARENT_HEADERS
from tests.test_torch_pbd_launch import _array, _system
from tests.test_torch_spring_kernel import FETCH_HEADERS
from tests.torch_parity import one_torch_thread  # noqa: F401

# sha256(kernels.scene_header(sys))[:16] of the spring Systems and of the
# composer's one-warp scenes (ant_run's System is v1 ant's), written by the
# parent commit's kernels.py
EARLIER_HEADERS = {
    "ant_spring": "331b0025adf26db1", "ant_spring_one_pass": "9083a6eb6f8e26b0",
    "halfcheetah_spring": "d8ac8c9e1bf8059d",
    "halfcheetah_spring_one_pass": "c2140f26c56395f2",
    "humanoid_legacy_spring": "266394cc615997db",
    "humanoid_legacy_spring_one_pass": "abe7d7c9e382a87d",
    "humanoidstandup_spring": "9b9b198d9f4df7a4",
    "humanoidstandup_spring_one_pass": "6497c95282442266",
    "inverted_pendulum_spring": "aa68a5707738952d",
    "inverted_pendulum_spring_one_pass": "4e3906015c3f636d",
    "inverted_double_pendulum_spring": "7b67d3b5b12e6ca8",
    "inverted_double_pendulum_spring_one_pass": "9d5bb4b42d5eea03",
    "reacher_spring": "5ef2d4ccd1508b97", "reacher_spring_one_pass": "5aa68f08b48e58ad",
    "reacherangle_spring": "47cf6ac9c9f9b922",
    "reacherangle_spring_one_pass": "cdb202e6a9c719c4",
    "ant_run": "02609bd5fc02eb6b", "ant_run_one_pass": "5bbea6eea5c8699a",
    "pro_ant_run": "f66850ea23a3a229", "pro_ant_run_one_pass": "9cda0ac4da846976",
    "ant_push": "9ca37f9654813388", "ant_push_one_pass": "bc269a839d1eb3df",
    "ant_on_ball": "af346759573a4489", "ant_on_ball_one_pass": "0543f17e341d4138",
    "halfcheetah_run": "f69c945bd0a6e5c4", "halfcheetah_run_one_pass": "c8040850cc6175c2",
    "humanoid_run": "160a22af95303640", "humanoid_run_one_pass": "5dd54737d2e6a45e",
}
# (lanes, the longest side-a and side-b contact lists) of the wide scenes
WIDE = {"chase": (64, 5, 5), "chase4": (256, 15, 15)}
N = {"chase": 5, "chase4": 3}
WIDE_FAULTS = ("wide_warp_local", "wide_v3_swapped", "wide_float_own_lane")


def _composer_sys(task):
    return cenvs.create_env(task, auto_reset=False, batch_size=1, device="cpu").sys


def _earlier_systems():
    """Every one-warp System of the earlier tests' lists, the spring
    Systems and the composer's one-warp scenes, with their one-pass ones."""
    from tests.test_torch_spring_kernel import _earlier_systems as spring_earlier

    systems = dict(spring_earlier())
    for name in pp.SPRING_SCENES:
        systems[f"{name}_spring"] = pp.spring_env(name, 1, "cpu").sys
    for task in ("ant_run", "pro_ant_run", "ant_push", "ant_on_ball", "halfcheetah_run",
                 "humanoid_run"):
        systems[task] = _composer_sys(task)
    for name in [k for k in systems if k.endswith("_spring") or k in EARLIER_HEADERS]:
        systems[f"{name}_one_pass"] = pp.one_pass(systems[name])
    return systems


def test_wide_headers_and_plans():
    for name in WIDE:
        _wide_header_and_plan(name)


def _wide_header_and_plan(name):
    """One env a block of `lanes` threads (PBD_WIDE, PBD_ENVS_PER_BLOCK 1),
    every table [field][lane] past the warp, and each body lane's gather
    lists as the plan's (lanes past the bodies empty)."""
    env = pp.composer_env(name, 1, "cpu")
    p = kernels.plan(env.sys)
    lanes, kg, kgb = WIDE[name]
    assert (p.lanes, p.envs_per_block, p.threads, p.wide) == (lanes, 1, lanes, True)
    assert (p.widths[3], p.width_b, p.ng) == (kg, kgb, 2)
    assert kernels.launch_geometry(p, 4096) == (4096, lanes)
    header = kernels.scene_header(env.sys)
    assert "#define PBD_WIDE 1\n" in header and f"#define PBD_LANES {lanes}\n" in header
    assert "#define PBD_ENVS_PER_BLOCK 1\n" in header and "#define PBD_CAPCAP 1\n" in header
    assert _array(header, "JOINT_F").shape[1] == _array(header, "CAPCAP_F").shape[1] == lanes
    con, con_b = _array(header, "BODY_CON"), _array(header, "BODY_CON_B")
    assert con.shape == (2, kg, lanes) and con_b.shape == (2, kgb, lanes)
    for g in range(2):
        for b in range(lanes):
            want_a = list(p.body_contacts[g][b]) if b < p.nb else []
            want_b = list(p.body_contacts_b[g][b]) if b < p.nb else []
            assert [c for c in con[g, :, b] if c >= 0] == want_a
            assert [c for c in con_b[g, :, b] if c >= 0] == want_b
    assert _array(header, "CONTACT_A")[:p.nc].tolist() == list(p.contact_a)
    assert max(max(p.contact_a), max(p.contact_b)) < p.nb


def test_one_warp_headers_are_the_parents():
    """Every one-warp System's header, byte for byte the parent commit's:
    the earlier tests' lists (PARENT_HEADERS, FETCH_HEADERS), the spring
    Systems and the composer's single-agent scenes; none defines PBD_WIDE."""
    systems = _earlier_systems()
    got = {name: hashlib.sha256(kernels.scene_header(s).encode()).hexdigest()[:16]
           for name, s in systems.items()}
    want = {**PARENT_HEADERS, **FETCH_HEADERS, **EARLIER_HEADERS}
    assert {k: got[k] for k in want if k in got} == {k: want[k] for k in want if k in got}
    assert set(EARLIER_HEADERS) | set(FETCH_HEADERS) <= set(got)
    assert not any(kernels.plan(s).wide for s in systems.values())


def test_one_warp_sources_preprocess_as_without_the_wide_route():
    """A one-warp scene's source, preprocessed, is token for token the
    source with every PBD_WIDE block cut out (its #else kept): the shuffles
    and the one-warp asserts; a wide scene's is not."""
    cpp = shutil.which("cpp")
    if cpp is None:
        pytest.skip("needs the host C preprocessor")

    def tokens(text):
        text = text.replace("#include <cuda_runtime.h>\n", "").replace("#include <math.h>\n", "")
        out = subprocess.run([cpp, "-P", "-x", "c++", "-"], input=text, capture_output=True,
                             text=True, check=True).stdout
        return [line for line in out.splitlines() if line.strip()]

    systems = {name: _system(name) for name in ("ant", "humanoid", "halfcheetah", "swimmer")}
    systems.update(ant_spring=pp.spring_env("ant", 1, "cpu").sys,
                   ant_on_ball=_composer_sys("ant_on_ball"),
                   chase=pp.composer_env("chase", 1, "cpu").sys)
    for name, sys in systems.items():
        whole = kernels.kernel_source(sys).read_text()
        cut = _without_blocks(whole, ("PBD_WIDE",))
        assert "#ifdef PBD_WIDE" in whole and "#ifdef PBD_WIDE" not in cut
        assert (tokens(whole) == tokens(cut)) == (name != "chase"), name


def _emulated(name, state_names, source=None, one_pass=False):
    env = pp.composer_env(name, N[name], "cpu")
    sys = pp.one_pass(env.sys) if one_pass else env.sys
    states = pp.composer_states(name, env, N[name], 0, "cpu")
    out = {}
    for state in state_names:
        qp, act = states[state]
        got = dict(zip(pp.TOLERANCE, pbd_emulation.emulate(sys, qp, act, source)))
        out[state] = (sys, qp, act, got)
    return out


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_route_matches_twin_in_emulation(name):
    """The whole step from a reset and 10 twin steps after it: every env
    within TOLERANCE of the twin; with the ants overlapping (chaotic), no
    env strays beyond 2x the twin's own spread (the chaos rule)."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    for state, (sys, qp, act, got) in _emulated(name, pp.COMPOSER_STATES).items():
        want = pp.fields(*kernels.pbd_step_plain(sys, qp, act))
        if state == pp.COMPOSER_STATES[2]:
            assert pp.capcap_share(sys, qp) > 0.5
            report, strays, allowed = pp.chaos_rule(sys, qp, act, got, want)
            assert len(strays) <= allowed, (state, report)
        else:
            errs = {k: float((got[k] - want[k]).abs().max()) for k in pp.TOLERANCE}
            assert all(errs[k] <= pp.TOLERANCE[k] for k in pp.TOLERANCE), (state, errs)


@pytest.mark.parametrize("fault", WIDE_FAULTS)
def test_planted_wide_fault_fails_the_rounding_rule(fault):
    """Each fault planted in the wide route's exchange fails the rounding
    rule over one pass of the 2-agent chase from a reset or 10 twin steps
    after it; the correct kernel passes there (the test above)."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    assert "chase" in pbd_faults.FAULT_SCENES[fault]
    verdicts = {}
    for state, (sys, qp, act, got) in _emulated("chase", pp.COMPOSER_STATES[:2],
                                                pbd_faults.planted_text(fault),
                                                one_pass=True).items():
        r = pp.rounding_rule(sys, qp, act, got, torch.Generator().manual_seed(7))
        verdicts[state] = (r["passes"], len(r["outliers"]), r["errs"])
    assert not all(v[0] for v in verdicts.values()), verdicts
