"""The PBD kernel's wide route in legacy-spring mode on the CPU: octopus_run.

octopus_run (28 bodies, 26 spring hinges, 26 torque actuators and 50
one-way capsule-plane contact points) takes 64 lanes, so its header defines
PBD_WIDE with PBD_SPRING: one env a block of 64 threads, the spring
substep's exchanges through shared memory.  Held here: its plan and header
(the spring tables and gather lists laid out over 64 lanes; its
preprocessed source in tests/test_torch_octopus.py); every earlier System's header and
preprocessed source as the parent commit's; the generated kernel in the
CPU emulation (tests/pbd_emulation.py: a block of 64 fibers, each
`__syncthreads` a barrier) against the twin from pbd_parity.octopus_states
over one substep and the whole step, by pbd_parity.RULES["octopus_run"]
(the reset, whose contacts sit on the floor to the last bit, by the chaos
rule); and the faults planted in the wide route's exchange
(tests/pbd_faults.py) failing the rounding rule over one substep.
"""

import hashlib
import shutil
import subprocess

import pytest
import torch

from brax_torch.sim import kernels
from brax_torch.tools import pbd_parity as pp

from tests import pbd_emulation, pbd_faults
from tests.test_torch_composer_kernel import EARLIER_HEADERS, WIDE_FAULTS, _earlier_systems
from tests.test_torch_fetch_kernel import PARENT_HEADERS
from tests.test_torch_pbd_launch import _array, _system
from tests.test_torch_spring_kernel import FETCH_HEADERS
from tests.torch_parity import one_torch_thread  # noqa: F401

# a ragged batch for the emulation (one env a block)
N = 5
# sha256[:16] of the parent commit's scene headers (the System's, its one
# pass's) and of the source each compiles, preprocessed (`_tokens`)
PARENT_WIDE_HEADERS = {"chase": ("deb96a46245a42b0", "e50b4ebb435a8a02"),
                       "sumo": ("a335508f9a13f0e2", "a53b3385fc93c562"),
                       "chase4": ("31d92098af19d36a", "14ef0b1da4ff20df")}
PARENT_TOKENS = {"ant": "077b0a3d7398816f", "ant_spring": "8d5b5eaced9141f6",
                 "humanoid_legacy_spring": "c3c0b5d538112354", "chase": "d4f9901cc298722b",
                 "sumo": "60dc313537b85f52", "chase4": "2aa6a4da92267572"}


def _hash(text):
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _tokens(sys):
    """The System's generated source, preprocessed by the host's cpp, its
    blank lines dropped (comments and the sections it does not define
    gone)."""
    text = kernels.kernel_source(sys).read_text()
    text = text.replace("#include <cuda_runtime.h>\n", "").replace("#include <math.h>\n", "")
    out = subprocess.run([shutil.which("cpp"), "-P", "-x", "c++", "-"], input=text,
                         capture_output=True, text=True, check=True).stdout
    return "\n".join(line for line in out.splitlines() if line.strip())


def _octopus(n):
    return pp.composer_env(pp.OCTOPUS, n, "cpu")


def test_octopus_plan_and_header():
    """64 lanes, one env a block; PBD_WIDE and PBD_SPRING together, its
    substeps counted by PBD_SUBSTEPS; the spring tables [field][lane] and
    the body lanes' joint lists over all 64 lanes, the contacts on lanes
    past the first warp gathered by their tentacle segments."""
    sys = _octopus(1).sys
    p = kernels.plan(sys)
    assert (p.nb, p.nj, p.na, p.nc) == (28, 26, 26, 50)
    assert (p.lanes, p.envs_per_block, p.threads, p.wide, p.spring) == (64, 1, 64, True, True)
    assert (p.passes, p.ng, p.euler) == (sys.substeps, 1, False)
    assert kernels.launch_geometry(p, 4096) == (4096, 64)
    assert kernels.unsupported_features(sys, 26) == []
    header = kernels.scene_header(sys)
    for line in ("#define PBD_WIDE 1\n", "#define PBD_SPRING 1\n", "#define PBD_LANES 64\n",
                 "#define PBD_ENVS_PER_BLOCK 1\n", f"#define PBD_SUBSTEPS {sys.substeps}\n"):
        assert line in header, line
    assert "PBD_PASSES" not in header and "PBD_SPRING_EULER" not in header
    for name, fields in (("SPRING_F", 3), ("SPRING_B_F", 1), ("SPRING_C_F", 3), ("JOINT_F", 33)):
        assert _array(header, name).shape == (fields, 64), name
    for name in ("JOINT_DOF", "JOINT_ACT", "CONTACT_A"):
        assert _array(header, name).shape == (64,), name
    assert _array(header, "JOINT_DOF")[:26].tolist() == [1] * 26
    sj = _array(header, "BODY_SJ")
    assert sj.shape == (p.width_sj, 64)
    for b in range(64):
        want = [j for j, _ in p.body_spring_joints[b]] if b < p.nb else []
        assert [j for j in sj[:, b] if j >= 0] == want
    con = _array(header, "BODY_CON")
    gathered = sorted(int(c) for c in con.flatten() if c >= 0)
    assert gathered == list(range(50)) and max(gathered) > 31


def test_earlier_headers_and_sources_are_the_parents():
    """Every earlier System's header byte for byte the parent commit's (the
    one-warp Systems of tests/test_torch_composer_kernel.py and the wide
    chase, sumo and 4-agent chase), and the sources of a one-warp, two
    spring and the wide Systems, preprocessed, token for token."""
    systems = _earlier_systems()
    got = {name: _hash(kernels.scene_header(s)) for name, s in systems.items()}
    want = {**PARENT_HEADERS, **FETCH_HEADERS, **EARLIER_HEADERS}
    assert {k: got[k] for k in want if k in got} == {k: want[k] for k in want if k in got}
    wide = {name: pp.composer_env(name, 1, "cpu").sys for name in PARENT_WIDE_HEADERS}
    assert {name: (_hash(kernels.scene_header(s)), _hash(kernels.scene_header(pp.one_pass(s))))
            for name, s in wide.items()} == PARENT_WIDE_HEADERS
    if shutil.which("cpp") is None:
        return
    sources = {**wide, "ant": _system("ant"), "ant_spring": pp.spring_env("ant", 1, "cpu").sys,
               "humanoid_legacy_spring": pp.spring_env("humanoid_legacy", 1, "cpu").sys}
    assert {name: _hash(_tokens(s)) for name, s in sources.items()} == PARENT_TOKENS


def _emulated(states, source=None, one_pass=False):
    env = _octopus(N)
    sys = pp.one_pass(env.sys) if one_pass else env.sys
    got = {}
    for state, (qp, act) in pp.octopus_states(env, N, 0, "cpu").items():
        if state in states:
            got[state] = (sys, qp, act,
                          dict(zip(pp.TOLERANCE, pbd_emulation.emulate(sys, qp, act, source))))
    return got


@pytest.mark.parametrize("state", pp.OCTOPUS_STATES)
def test_octopus_matches_twin_in_emulation(state):
    """Over one substep and over the whole step, by the rules
    pbd_parity.RULES["octopus_run"] names for the state: every env within
    TOLERANCE (the rounding rule at these few envs), or no env beyond 2x
    the twin's own spread (the chaos rule)."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    rules = pp.RULES[pp.OCTOPUS][state]
    for rule, one_pass in zip(rules, (True, False)):
        sys, qp, act, got = _emulated((state,), one_pass=one_pass)[state]
        want = pp.fields(*kernels.pbd_step_plain(sys, qp, act))
        if rule == "chaos_rule":
            report, strays, _ = pp.chaos_rule(sys, qp, act, got, want)
            assert len(strays) == 0, (state, one_pass, report)
        else:
            errs = {k: float((got[k] - want[k]).abs().max()) for k in pp.TOLERANCE}
            assert all(errs[k] <= pp.TOLERANCE[k] for k in pp.TOLERANCE), (state, one_pass, errs)


@pytest.mark.parametrize("fault", WIDE_FAULTS)
def test_planted_wide_fault_fails_octopus_rounding_rule(fault):
    """Each fault planted in the wide route's exchange fails the rounding
    rule over one substep of octopus_run after 10 twin steps or from the
    jiggled state, where the correct kernel keeps every env within
    TOLERANCE (the test above)."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    assert pp.OCTOPUS in pbd_faults.FAULT_SCENES[fault]
    verdicts = {}
    for state, (sys, qp, act, got) in _emulated(pp.OCTOPUS_STATES[1:],
                                                pbd_faults.planted_text(fault),
                                                one_pass=True).items():
        r = pp.rounding_rule(sys, qp, act, got, torch.Generator().manual_seed(7))
        verdicts[state] = (r["passes"], len(r["outliers"]), r["errs"])
    assert not any(v[0] for v in verdicts.values()), verdicts
