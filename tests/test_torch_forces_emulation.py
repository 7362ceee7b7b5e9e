"""The generated PBD kernel of the thruster/twister and angle-actuator
scenes in the CPU's warp emulation (tests/pbd_emulation.py), against the
twin.

Each scene has no contacts (PBD_NC 0: the contact passes run on lanes that
no body gathers); inverted_pendulum and inverted_double_pendulum have no
actuators either (PBD_NA 0).  Their sources compile PBD_FORCES
(inverted_pendulum, inverted_double_pendulum, swimmer) or PBD_ANGLE
(reacherangle); reacher compiles neither.  Ragged batches after 10 twin
steps, on `pbd_parity.physics_actions`: inverted_pendulum on its 1-wide
action (the thruster's columns clipped to it), swimmer on 11 columns,
reacherangle on targets past its joints' limits.  Every env within
`pbd_parity.TOLERANCE` of the twin.  And the earlier scenes' sources hold
none of the new sections: preprocessed, each is the source with every
PBD_FORCES and PBD_ANGLE block cut out, token for token (on the card,
tests/test_torch_cuda.py compares the two builds' SASS).  No JAX, no card:
the card's build is held to the twin by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import shutil
import subprocess

import pytest

from brax_torch.sim import kernels

from brax_torch.tools.pbd_parity import PHYSICS_ACT, TOLERANCE, physics_actions

from tests import pbd_emulation
from tests.test_torch_cuda import _without_blocks
from tests.test_torch_pbd_launch import Scene, _config, _system, scene_state
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name,n", sorted(pbd_emulation.FORCE_SCENES.items()))
def test_force_and_angle_lane_logic_matches_twin_in_emulation(name, n):
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env = Scene(_config(name), batch_size=n, device="cpu")
    qp, act = scene_state(env, n, steps=10, seed=0, device="cpu",
                          draw=lambda gen: physics_actions(name, n, gen, "cpu"))
    assert act.shape == (n, PHYSICS_ACT[name])
    errs = pbd_emulation.max_errors(env.sys, qp, act)
    assert all(errs[k] <= TOLERANCE[k] for k in TOLERANCE), errs


def test_earlier_scenes_preprocess_as_without_the_new_sections():
    cpp = shutil.which("cpp")
    if cpp is None:
        pytest.skip("needs the host C preprocessor")

    def tokens(text):
        text = text.replace("#include <cuda_runtime.h>\n", "").replace("#include <math.h>\n", "")
        out = subprocess.run([cpp, "-P", "-x", "c++", "-"], input=text, capture_output=True,
                             text=True, check=True).stdout
        return [line for line in out.splitlines() if line.strip()]

    macros = ("PBD_FORCES", "PBD_ANGLE")
    for name in ("ant", "humanoid", "humanoidstandup", "halfcheetah", "pusher", "swimmer",
                 "reacherangle", "reacher"):
        whole = kernels.kernel_source(_system(name)).read_text()
        cut = _without_blocks(whole, macros)
        assert "#ifdef PBD_FORCES" in whole and "#ifdef PBD_FORCES" not in cut
        same = tokens(whole) == tokens(cut)
        assert same == (name in ("ant", "humanoid", "humanoidstandup", "halfcheetah", "pusher",
                                 "reacher")), name
