"""The PBD kernel's legacy-spring section (PBD_SPRING) on the CPU: the
scene header and plan of the spring Systems, the earlier Systems' headers
and preprocessed sources unchanged, and the twin against the JAX package's
Pallas kernel body, the reference the CUDA kernel follows.

The Pallas body (`brax_tpu.sim.kernels._build_tile_step`, run eagerly: its
jit takes minutes here; 1-2 s eagerly) steps one spring substep (the
System with substeps=1, what its fori_loop repeats) of ant,
humanoid_legacy and halfcheetah (two-way capsule-capsule contacts) 10
twin steps after a reset, against the twin at tests/test_torch_step.py's
one-step tolerances.
"""

import hashlib
import shutil
import subprocess

import pytest

from brax_torch.envs.fetch import Fetch
from brax_torch.envs.grasp import Grasp
from brax_torch.envs.hopper import Hopper
from brax_torch.envs.walker2d import Walker2d
from brax_torch.sim import kernels
from brax_torch.tools import pbd_parity as pp

from tests import spring_parity as sp
from tests.test_torch_cuda import _without_blocks
from tests.test_torch_fetch_kernel import PARENT_HEADERS
from tests.test_torch_pbd_launch import SCENES, _system
from tests.torch_parity import one_torch_thread  # noqa: F401

# sha256(kernels.scene_header(sys))[:16] of fetch's, hopper's and
# walker2d's Systems, written by the parent commit's kernels.py
FETCH_HEADERS = {"fetch": "b554c7bb588a4bff", "fetch_one_pass": "0a92c241d42ca43c",
                 "hopper": "9a068469a8958211", "hopper_one_pass": "b9960769d93fc427",
                 "walker2d": "523fa59fc57c5a27", "walker2d_one_pass": "9d59c176500b839c"}


def _header_defines(header):
    return {line.split()[1]: line.split()[2] if len(line.split()) > 2 else ""
            for line in header.splitlines() if line.startswith("#define ")}


def test_spring_header_and_plan():
    """A spring scene's header has its substep count (no PBD_PASSES),
    PBD_SPRING and its tables; the Euler-angle code only where a
    universal or spherical joint is (the humanoids); a joint lane carries
    the actuator on its joint; a body lane's joints are listed in joint
    order; a two-way contact's impulse divides by both inverse masses."""
    for name, euler in (("ant", False), ("humanoid_legacy", True), ("halfcheetah", False)):
        sys = sp.port_env(name).sys
        p = kernels.plan(sys)
        defines = _header_defines(kernels.scene_header(sys))
        assert p.spring and p.passes == sys.substeps == int(defines["PBD_SUBSTEPS"])
        assert "PBD_PASSES" not in defines and "PBD_SPRING" in defines
        assert ("PBD_SPRING_EULER" in defines) == euler == p.euler
        assert p.joint_dof == tuple(g.dof for g in sys.joint_groups for _ in range(g.n))
        assert p.joint_act == tuple(range(p.nj))  # each actuator on its own joint lane
        for b, joints in enumerate(p.body_spring_joints):
            assert [j for j, _ in joints] == sorted(j for j, _ in joints)
            assert all((p.joint_parent if sign > 0 else p.joint_child)[j] == b
                       for j, sign in joints)
        ftab, itab = kernels.pack_tables(sys)
        nb, nj, nc = p.nb, p.nj, p.nc
        tail = ftab[len(ftab) - (kernels.SJ_SIZE * nj + nb + kernels.SC_SIZE * nc + 1):]
        stiffness = [float(x) for g in sys.joint_groups for x in g.stiffness]
        assert tail[0:3 * nj:3].tolist() == stiffness
        assert itab[-2 * nj::2].tolist() == list(p.joint_dof)
        assert abs(tail[-1] - sys.solver.baumgarte_erp) <= 1e-6 * sys.solver.baumgarte_erp
    # halfcheetah's feet pair (the last contact) is two-way: 1/m_a + 1/m_b
    sys = sp.port_env("halfcheetah").sys
    p = kernels.plan(sys)
    cc = sys.contact_groups[1].com
    ftab, _ = kernels.pack_tables(sys)
    last = ftab[len(ftab) - 1 - kernels.SC_SIZE:len(ftab) - 1]
    assert p.contact_capcap[-1] and abs(
        last[2] - (1 / float(cc.mass_a[0]) + 1 / float(cc.mass_b[0]))) < 1e-6


def _earlier_systems():
    systems = {name: _system(name) for name in SCENES}
    systems["grasp"] = Grasp(batch_size=1, device="cpu").sys
    for name, cls in (("fetch", Fetch), ("hopper", Hopper), ("walker2d", Walker2d)):
        systems[name] = cls(batch_size=1, device="cpu").sys
        systems[f"{name}_one_pass"] = pp.one_pass(systems[name])
    return systems


def test_earlier_headers_are_the_parents():
    """The earlier Systems' headers, byte for byte the parent commit's:
    tests/test_torch_fetch_kernel.py's PARENT_HEADERS (whose test holds
    them too) and the fetch, hopper and walker2d Systems'."""
    systems = _earlier_systems()
    got = {name: hashlib.sha256(kernels.scene_header(s).encode()).hexdigest()[:16]
           for name, s in systems.items()}
    assert {k: got[k] for k in FETCH_HEADERS} == FETCH_HEADERS
    assert all(got[k] == PARENT_HEADERS[k] for k in got if k in PARENT_HEADERS)


def test_earlier_scenes_preprocess_as_without_the_spring_section():
    """Each earlier scene's source, preprocessed, is token for token the
    source with every PBD_SPRING block cut out; a spring scene's is not."""
    cpp = shutil.which("cpp")
    if cpp is None:
        pytest.skip("needs the host C preprocessor")

    def tokens(text):
        text = text.replace("#include <cuda_runtime.h>\n", "").replace("#include <math.h>\n", "")
        out = subprocess.run([cpp, "-P", "-x", "c++", "-"], input=text, capture_output=True,
                             text=True, check=True).stdout
        return [line for line in out.splitlines() if line.strip()]

    systems = _earlier_systems()
    systems["ant_spring"] = sp.port_env("ant").sys
    for name, sys in systems.items():
        whole = kernels.kernel_source(sys).read_text()
        cut = _without_blocks(whole, ("PBD_SPRING",))
        assert "#ifdef PBD_SPRING" in whole and "#ifdef PBD_SPRING" not in cut
        assert (tokens(whole) == tokens(cut)) == (name != "ant_spring"), name


@pytest.mark.parametrize("name", ["ant", "humanoid_legacy", "halfcheetah"])
def test_twin_matches_pallas_body_over_one_substep(name):
    sys = pp.one_pass(sp.port_env(name).sys)
    qp, act = sp.settled(name)
    want = sp.pallas_one_substep(name, qp, act)
    got = pp.fields(*kernels.pbd_step_plain(sys, qp, act))
    for k in sp.OUTPUTS:
        err = float((got[k] - want[k]).abs().max())
        assert err <= sp.ONE_STEP[k], (name, k, err)
    assert float(got["contact_vel"].abs().max()) > 0  # in contact
