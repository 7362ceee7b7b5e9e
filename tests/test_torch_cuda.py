"""The CUDA kernels (PBD step, fused MLP, generalized step, the launch-overhead
probe) against their plain versions, on a CUDA card, the physics steps'
autograd Functions (APG's gradients) with the kernels forward, and SAC's
route through the fused kernels (its critics' 257-wide input).

These tests skip without a card.  This file imports no JAX, so that it runs
where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses
import math

import pytest
import torch

from brax_torch import cuda_build
from brax_torch.envs.ant import Ant
from brax_torch.sim import kernels
from brax_torch.tools import grad_parity as gp
from brax_torch.tools import probe_overhead as probe
from brax_torch.training import fused_mlp
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels as gen_kernels

from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _contact_state(device, n=256, steps=10):
    """n ant envs after `steps` twin steps (contact-rich), and one more action."""
    env = Ant(use_contact_forces=True, batch_size=n, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    qp = env.reset(gen).qp
    for _ in range(steps):
        act = torch.rand((n, 8), generator=gen, device=device) * 2 - 1
        qp, _ = kernels.pbd_step_plain(env.sys, qp, act)
    return env, qp, torch.rand((n, 8), generator=gen, device=device) * 2 - 1


def test_kernel_matches_twin_in_contact(cuda):
    env, qp, act = _contact_state(cuda)
    before = kernels.pbd_step_launch.launches
    out, info = kernels.pbd_step(env.sys, qp, act)
    torch.cuda.synchronize()
    assert kernels.pbd_step_launch.launches == before + 1
    ref, info_ref = kernels.pbd_step_plain(env.sys, qp, act)
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=1e-4)
    torch.testing.assert_close(out.rot, ref.rot, rtol=0, atol=1e-4)
    torch.testing.assert_close(out.vel, ref.vel, rtol=0, atol=3e-3)
    torch.testing.assert_close(out.ang, ref.ang, rtol=0, atol=3e-3)
    torch.testing.assert_close(info.contact.vel, info_ref.contact.vel, rtol=0, atol=3e-3)
    torch.testing.assert_close(info.contact.ang, info_ref.contact.ang, rtol=0, atol=3e-3)


def test_kernel_raises_on_unsupported_system(cuda):
    env, qp, act = _contact_state(cuda, n=32, steps=0)
    other = dataclasses.replace(env.sys, collider_cutoff=4)
    with pytest.raises(NotImplementedError, match="collider_cutoff"):
        kernels.pbd_step(other, qp, act)


def test_kernel_rejects_cpu_mixed_inputs(cuda):
    env, qp, act = _contact_state(cuda, n=32, steps=0)
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.pbd_step(env.sys, qp, act.cpu())


def _rounding_rule_holds(sys, qp, act, device):
    """chip_smoke.py's rule: every output within TOLERANCE of the twin, but
    for at most MAX_OUTLIERS envs, each one whose result float rounding
    decides (pbd_parity.max_errors raises otherwise)."""
    from brax_torch.tools import pbd_parity

    gen = torch.Generator(device=device).manual_seed(7)
    _, _, outliers = pbd_parity.max_errors(sys, qp, act, gen)
    assert outliers <= pbd_parity.MAX_OUTLIERS


@pytest.mark.parametrize("n", [1, 128, 2048, 4097])
def test_generated_kernel_matches_twin_by_batch(cuda, n):
    env, qp, act = _contact_state(cuda, n=n)
    before = kernels.pbd_step_launch.launches
    _rounding_rule_holds(env.sys, qp, act, cuda)
    assert kernels.pbd_step_launch.launches == before + 1


def test_generated_kernel_matches_twin_on_two_legged_ant(cuda):
    from tests.test_torch_pbd_launch import Scene, scene_state, two_legged_ant_config

    env = Scene(two_legged_ant_config(), batch_size=1000, device=cuda)
    assert kernels.plan(env.sys).lanes == 8
    qp, act = scene_state(env, 1000, steps=10, seed=1, device=cuda)
    _rounding_rule_holds(env.sys, qp, act, cuda)


def test_generated_kernel_gives_the_same_bits_twice(cuda):
    env, qp, act = _contact_state(cuda, n=2048)
    a, info_a = kernels.pbd_step(env.sys, qp, act)
    b, info_b = kernels.pbd_step(env.sys, qp, act)
    for x, y in zip((a.pos, a.rot, a.vel, a.ang, info_a.contact.vel, info_a.contact.ang),
                    (b.pos, b.rot, b.vel, b.ang, info_b.contact.vel, info_b.contact.ang)):
        assert torch.equal(x, y)


def test_generated_kernel_replays_from_a_cuda_graph(cuda):
    """A launch captured in a CUDA graph and replayed gives the eager bits."""
    env, qp, act = _contact_state(cuda, n=512)
    want, info_want = kernels.pbd_step(env.sys, qp, act)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.pbd_step(env.sys, qp, act)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, info_got = kernels.pbd_step(env.sys, qp, act)
    for t in (got.pos, got.vel, info_got.contact.ang):
        t.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip((want.pos, want.rot, want.vel, want.ang, info_want.contact.vel),
                    (got.pos, got.rot, got.vel, got.ang, info_got.contact.vel)):
        assert torch.equal(x, y)
    assert torch.equal(info_want.contact.ang, info_got.contact.ang)


def _humanoid_state(name, device, n, steps=10, seed=0):
    """n envs of a spherical scene (humanoid or humanoidstandup) after
    `steps` twin steps from reset noise (feet or body on the floor), and one
    more action."""
    from tests.test_torch_pbd_launch import Scene, _config, scene_state

    env = Scene(_config(name), batch_size=n, device=device)
    return env, *scene_state(env, n, steps=steps, seed=seed, device=device)


@pytest.mark.parametrize("name", ["humanoid", "humanoidstandup"])
@pytest.mark.parametrize("n", [1, 2, 4097])
def test_spherical_kernel_matches_twin_by_batch(cuda, name, n):
    """The spherical joint rows and 3-dof actuators (PBD_SPHERICAL), on
    ragged batches in contact: humanoid 16 lanes (2 envs a warp),
    humanoidstandup 32 (1 env a warp)."""
    env, qp, act = _humanoid_state(name, cuda, n)
    assert kernels.plan(env.sys).spherical
    before = kernels.pbd_step_launch.launches
    _rounding_rule_holds(env.sys, qp, act, cuda)
    assert kernels.pbd_step_launch.launches == before + 1


def test_spherical_kernel_gives_the_same_bits_twice_and_from_a_graph(cuda):
    env, qp, act = _humanoid_state("humanoid", cuda, 1024)
    want, info_want = kernels.pbd_step(env.sys, qp, act)
    again, info_again = kernels.pbd_step(env.sys, qp, act)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.pbd_step(env.sys, qp, act)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, info_got = kernels.pbd_step(env.sys, qp, act)
    got.pos.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    fields = lambda q, i: (q.pos, q.rot, q.vel, q.ang, i.contact.vel, i.contact.ang)
    for x, y, z in zip(fields(want, info_want), fields(again, info_again),
                       fields(got, info_got)):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_humanoid_env_step_launches_the_kernel_once(cuda):
    from brax_torch import envs

    for name in ("humanoid", "humanoid_legacy", "humanoidstandup"):
        env = envs.create(name, batch_size=64)
        state = env.reset(torch.Generator(device=cuda).manual_seed(0))
        before = kernels.pbd_step_launch.launches
        for _ in range(3):
            state = env.step(state, torch.zeros((64, 17), device=cuda))
        assert kernels.pbd_step_launch.launches == before + 3
        assert state.obs.shape == (64, 240) and bool(torch.isfinite(state.obs).all())


# ---------------------------------------------------------------------------
# v1 halfcheetah and pusher: the two-way capsule-capsule group (PBD_CAPCAP)
# ---------------------------------------------------------------------------


def _capcap_state(name, device, n, seed=0):
    """n envs of halfcheetah or pusher with their capsule-capsule pairs
    overlapping (pbd_parity.capcap_state), and an action."""
    from brax_torch.tools.pbd_parity import capcap_state
    from tests.test_torch_pbd_launch import Scene, _config

    env = Scene(_config(name), batch_size=n, device=device)
    return env, *capcap_state(name, env, n, seed, device)


@pytest.mark.parametrize("name", ["halfcheetah", "pusher"])
@pytest.mark.parametrize("n", [1, 2, 4097])
def test_capcap_kernel_matches_twin_by_batch(cuda, name, n):
    """The capsule-capsule lanes and the two-way passes (PBD_CAPCAP), on
    ragged batches whose pairs overlap: 32 lanes, an env a warp.  Over one
    pass (pbd_parity.one_pass) and over the whole step, by the rules
    chip_smoke.py holds this state to (pbd_parity.RULES: pusher's pass by
    the rounding rule, the rest, chaotic, by the chaos rule)."""
    from brax_torch.tools import pbd_parity

    env, qp, act = _capcap_state(name, cuda, n)
    assert kernels.plan(env.sys).capcap and kernels.plan(env.sys).lanes == 32
    gen = torch.Generator(device=cuda).manual_seed(7)
    before = kernels.pbd_step_launch.launches
    pbd_parity.hold_capcap(name, "capsule-capsule contact", env.sys, qp, act, gen, f"{name} ")
    assert kernels.pbd_step_launch.launches == before + 2


@pytest.mark.parametrize("name", ["halfcheetah", "pusher"])
def test_capcap_kernel_gives_the_same_bits_twice_and_from_a_graph(cuda, name):
    env, qp, act = _capcap_state(name, cuda, 1024)
    want, info_want = kernels.pbd_step(env.sys, qp, act)
    again, info_again = kernels.pbd_step(env.sys, qp, act)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.pbd_step(env.sys, qp, act)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, info_got = kernels.pbd_step(env.sys, qp, act)
    got.vel.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    fields = lambda q, i: (q.pos, q.rot, q.vel, q.ang, i.contact.vel, i.contact.ang)
    for x, y, z in zip(fields(want, info_want), fields(again, info_again),
                       fields(got, info_got)):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_capcap_env_step_launches_the_kernel_once(cuda):
    from brax_torch import envs

    for name, obs, n_act in (("halfcheetah", 18, 6), ("pusher", 23, 7)):
        env = envs.create(name, batch_size=64)
        state = env.reset(torch.Generator(device=cuda).manual_seed(0))
        before = kernels.pbd_step_launch.launches
        for _ in range(3):
            state = env.step(state, torch.zeros((64, n_act), device=cuda))
        assert kernels.pbd_step_launch.launches == before + 3
        assert state.obs.shape == (64, obs) and bool(torch.isfinite(state.obs).all())


def _without_blocks(source: str, macros) -> str:
    """pbd_step.cu with every `#if...` block that names one of `macros` cut
    out; such a block's `#else` branch stays, without its directives."""
    out, depth, cut, kept = [], 0, None, None
    for line in source.splitlines(keepends=True):
        directive = line.strip()
        if directive.startswith("#if"):
            depth += 1
            if cut is None and any(m in directive for m in macros):
                cut = depth
                continue
        elif directive.startswith("#else") and cut == depth:
            cut, kept = None, depth
            continue
        elif directive.startswith("#endif") and depth in (cut, kept):
            cut = None if cut == depth else cut
            kept = None if kept == depth else kept
            depth -= 1
            continue
        elif directive.startswith("#endif"):
            depth -= 1
        if cut is None:
            out.append(line)
    return "".join(out)


@pytest.mark.parametrize("name", ["ant", "humanoid", "humanoidstandup"])
def test_scenes_without_capcap_compile_as_without_its_section(cuda, name):
    """ant's and the humanoids' kernels hold none of the capsule-capsule
    section: their SASS equals that of a build whose source has every
    PBD_CAPCAP block cut out (the parent's bits and speed are held by
    `python -m brax_torch.tools.pbd_turns`)."""
    from tests.test_torch_pbd_launch import _system

    sys_ = _system(name)
    whole = kernels.kernel_source(sys_)
    cut = whole.with_name(whole.stem + "_without_capcap.cu")
    cut.write_text(_without_blocks(whole.read_text(), ("PBD_CAPCAP",)))
    assert "#ifdef PBD_CAPCAP" in whole.read_text() and "#ifdef PBD_CAPCAP" not in cut.read_text()
    assert _sass(whole) == _sass(cut) != []


def _sass(source):
    """The SASS instructions of `source`'s build."""
    return cuda_build.sass(cuda_build.build(source)[source])


# ---------------------------------------------------------------------------
# thrusters/twisters (PBD_FORCES) and angle actuators (PBD_ANGLE)
# ---------------------------------------------------------------------------

FORCE_SCENES = ("inverted_pendulum", "inverted_double_pendulum", "swimmer", "reacherangle",
                "reacher")


def _force_state(name, device, n, seed=0):
    """n envs of a scene without contacts after 10 twin steps on its physics
    actions (inverted_pendulum's 1-wide, swimmer's 11 columns, reacherangle's
    targets past the limits), and one more action."""
    from brax_torch.tools.pbd_parity import physics_actions
    from tests.test_torch_pbd_launch import Scene, _config, scene_state

    env = Scene(_config(name), batch_size=n, device=device)
    return env, *scene_state(env, n, steps=10, seed=seed, device=device,
                             draw=lambda gen: physics_actions(name, n, gen, device))


@pytest.mark.parametrize("name", FORCE_SCENES)
@pytest.mark.parametrize("n", [1, 2, 4097])
def test_force_and_angle_kernel_matches_twin_by_batch(cuda, name, n):
    """The thruster and angle-actuator sections on ragged batches (2-4 lanes
    an env, 8-16 envs a warp), by the rounding rule, one launch each."""
    env, qp, act = _force_state(name, cuda, n)
    p = kernels.plan(env.sys)
    assert p.nc == 0 and p.forces == (name in FORCE_SCENES[:3]) and p.angle == (
        name == "reacherangle")
    before = kernels.pbd_step_launch.launches
    _rounding_rule_holds(env.sys, qp, act, cuda)
    assert kernels.pbd_step_launch.launches == before + 1


def test_zero_contact_zero_actuator_scene_builds_and_launches(cuda):
    """inverted_pendulum: no contacts, no actuators (PBD_NC 0, PBD_NA 0), 2
    lanes an env; its 1-wide action read by the thruster's three clipped
    columns, the same bits as that action repeated to 4 columns; finite."""
    env, qp, act = _force_state("inverted_pendulum", cuda, 4096)
    p = kernels.plan(env.sys)
    assert (p.na, p.nc, p.nf, p.lanes, act.shape[1]) == (0, 0, 1, 2, 1)
    before = kernels.pbd_step_launch.launches
    out, info = kernels.pbd_step(env.sys, qp, act)
    wide, _ = kernels.pbd_step(env.sys, qp, act.repeat(1, 4))
    torch.cuda.synchronize()
    assert kernels.pbd_step_launch.launches == before + 2
    for x, y in zip((out.pos, out.rot, out.vel, out.ang), (wide.pos, wide.rot, wide.vel, wide.ang)):
        assert torch.equal(x, y) and bool(torch.isfinite(x).all())
    assert not info.contact.vel.any() and not info.contact.ang.any()


def test_force_env_step_launches_the_kernel_once(cuda):
    from brax_torch import envs

    for name, obs, n_act in (("inverted_pendulum", 4, 1), ("inverted_double_pendulum", 8, 1),
                             ("swimmer", 8, 2), ("reacherangle", 11, 2), ("reacher", 11, 2)):
        env = envs.create(name, batch_size=64)
        state = env.reset(torch.Generator(device=cuda).manual_seed(0))
        before = kernels.pbd_step_launch.launches
        for _ in range(3):
            state = env.step(state, torch.rand((64, n_act), device=cuda) * 2 - 1)
        assert kernels.pbd_step_launch.launches == before + 3
        assert state.obs.shape == (64, obs) and bool(torch.isfinite(state.obs).all())


@pytest.mark.parametrize("name", ["ant", "humanoid", "humanoidstandup", "halfcheetah", "pusher"])
def test_scenes_without_forces_or_angle_compile_as_without_their_sections(cuda, name):
    """The scenes of the earlier groups hold none of the thruster and
    angle-actuator sections: their SASS equals that of a build whose source
    has every PBD_FORCES and PBD_ANGLE block cut out."""
    from tests.test_torch_pbd_launch import _system

    sys_ = _system(name)
    whole = kernels.kernel_source(sys_)
    cut = whole.with_name(whole.stem + "_without_forces.cu")
    cut.write_text(_without_blocks(whole.read_text(), ("PBD_FORCES", "PBD_ANGLE")))
    assert "#ifdef PBD_FORCES" in whole.read_text() and "#ifdef PBD_ANGLE" in whole.read_text()
    assert "#ifdef PBD_FORCES" not in cut.read_text() and "PBD_ANGLE)" not in cut.read_text()
    assert _sass(whole) == _sass(cut) != []


@pytest.mark.parametrize("n", [1, 2, 4097])
def test_twister_kernel_matches_twin_by_batch(cuda, n):
    """swimmer with its torso's thruster made a twister
    (pbd_parity.twister_swimmer; no default scene has one): the twister
    branch of PBD_FORCES by the rounding rule, after 10 twin steps."""
    from brax_torch.tools.pbd_parity import physics_actions, twister_swimmer
    from tests.test_torch_pbd_launch import Scene, _config, scene_state

    sys_ = twister_swimmer(cuda)
    assert kernels.plan(sys_).force_twister == (False, False, True)
    env = Scene(_config("swimmer"), batch_size=n, device=cuda)
    qp, act = scene_state(env, n, steps=10, seed=0, device=cuda,
                          draw=lambda gen: physics_actions("swimmer", n, gen, cuda))
    before = kernels.pbd_step_launch.launches
    _rounding_rule_holds(sys_, qp, act, cuda)
    assert kernels.pbd_step_launch.launches == before + 1


# ---------------------------------------------------------------------------
# grasp: one-way capsule-capsule contacts (PBD_CAPCAP_ONEWAY) and angle
# actuators on spherical joints (PBD_SPHERICAL_ANGLE)
# ---------------------------------------------------------------------------


def _grasp_states(device, n):
    from brax_torch.envs.grasp import Grasp
    from brax_torch.tools.pbd_parity import grasp_states

    env = Grasp(batch_size=n, device=device)
    return env, grasp_states(env, n, 0, device)


@pytest.mark.parametrize("n", [1, 2, 4097])
def test_grasp_kernel_matches_twin_by_batch(cuda, n):
    """grasp from a reset and with its claw closed on the ball, over one
    pass and over the whole step, by the rules chip_smoke.py holds it to
    (pbd_parity.RULES), on ragged batches: 16 lanes, 2 envs a warp."""
    from brax_torch.tools import pbd_parity

    env, states = _grasp_states(cuda, n)
    assert kernels.plan(env.sys).oneway and kernels.plan(env.sys).lanes == 16
    gen = torch.Generator(device=cuda).manual_seed(7)
    for state, (qp, act) in states.items():
        before = kernels.pbd_step_launch.launches
        pbd_parity.hold_capcap("grasp", state, env.sys, qp, act, gen, f"grasp {state} ")
        assert kernels.pbd_step_launch.launches == before + 2


@pytest.mark.parametrize("made", ["grasp_padded", "pusher_oneway"])
def test_made_scenes_match_twin(cuda, made):
    """grasp_padded (padded spherical angle dofs, pbd_parity.padded_grasp)
    from the claw closed on the ball, and pusher_oneway (a one-way pair
    whose body b moves, pbd_parity.oneway_pusher) from its pairs
    overlapping, at 4097 envs over one pass and the whole step, by the
    rules pbd_parity.RULES names (grasp's: the rounding rule; and
    pusher_oneway's: the chaos rule, its step from overlapping pairs being
    chaotic over one pass and the whole step)."""
    from brax_torch.tools import pbd_parity
    from tests.test_torch_pbd_launch import Scene, _config

    n = 4097
    if made == "grasp_padded":
        env, states = _grasp_states(cuda, n)
        sys_, rules, state = pbd_parity.padded_grasp(env.sys), "grasp", "claw closed on the ball"
    else:
        env = Scene(_config("pusher"), batch_size=n, device=cuda)
        sys_, rules, state = pbd_parity.oneway_pusher(env.sys), made, "capsule-capsule contact"
        states = {state: pbd_parity.capcap_state("pusher", env, n, 0, cuda)}
    qp, act = states[state]
    gen = torch.Generator(device=cuda).manual_seed(7)
    pbd_parity.hold_capcap(rules, state, sys_, qp, act, gen, f"{made} ")


def test_grasp_kernel_gives_the_same_bits_twice_and_from_a_graph(cuda):
    env, states = _grasp_states(cuda, 1024)
    qp, act = states["claw closed on the ball"]
    want, info_want = kernels.pbd_step(env.sys, qp, act)
    again, info_again = kernels.pbd_step(env.sys, qp, act)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.pbd_step(env.sys, qp, act)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, info_got = kernels.pbd_step(env.sys, qp, act)
    got.ang.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    fields = lambda q, i: (q.pos, q.rot, q.vel, q.ang, i.contact.vel, i.contact.ang)
    for x, y, z in zip(fields(want, info_want), fields(again, info_again),
                       fields(got, info_got)):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_grasp_acrobot_ur5e_env_step_launches_the_kernel_once(cuda):
    from brax_torch import envs

    for name, obs, n_act in (("grasp", 132, 39), ("acrobot", 4, 1), ("ur5e", 66, 6)):
        env = envs.create(name, batch_size=64)
        state = env.reset(torch.Generator(device=cuda).manual_seed(0))
        before = kernels.pbd_step_launch.launches
        for _ in range(3):
            state = env.step(state, torch.rand((64, n_act), device=cuda) * 2 - 1)
        assert kernels.pbd_step_launch.launches == before + 3
        assert state.obs.shape == (64, obs) and bool(torch.isfinite(state.obs).all())


def test_kernel_raises_on_box_plane(cuda):
    """A System with a contact group the kernel lacks (fetch's box-plane
    group made two-way, which the JAX package's kernel refuses too) raises
    NotImplementedError on CUDA tensors, and launches nothing."""
    from brax_torch.envs.fetch import Fetch
    from brax_torch.tools.pbd_parity import fetch_states

    env = Fetch(batch_size=32, device=cuda)
    qp, act = fetch_states(env, 32, 0, cuda)["reset"]
    (g,) = env.sys.contact_groups
    two_way = dataclasses.replace(g, com=dataclasses.replace(g.com, one_way=False))
    other = dataclasses.replace(env.sys, contact_groups=(two_way,))
    before = kernels.pbd_step_launch.launches
    with pytest.raises(NotImplementedError, match="two-way BoxPlane contacts"):
        kernels.pbd_step(other, qp, act)
    assert kernels.pbd_step_launch.launches == before


@pytest.mark.parametrize("name", ["ant", "humanoid", "humanoidstandup", "halfcheetah", "pusher",
                                  "inverted_pendulum", "inverted_double_pendulum", "swimmer",
                                  "reacherangle", "reacher"])
def test_earlier_scenes_compile_as_without_the_grasp_sections(cuda, name):
    """The earlier scenes hold none of grasp's sections: their SASS equals
    that of a build whose source has every PBD_CAPCAP_ONEWAY and
    PBD_SPHERICAL_ANGLE block cut out."""
    from tests.test_torch_pbd_launch import _system

    whole = kernels.kernel_source(_system(name))
    cut = whole.with_name(whole.stem + "_without_grasp.cu")
    cut.write_text(_without_blocks(whole.read_text(), ("PBD_CAPCAP_ONEWAY",
                                                       "PBD_SPHERICAL_ANGLE")))
    assert "#ifdef PBD_CAPCAP_ONEWAY" in whole.read_text()
    assert "#ifdef PBD_SPHERICAL_ANGLE" not in cut.read_text()
    assert _sass(whole) == _sass(cut) != []


# ---------------------------------------------------------------------------
# fetch: one-way box-plane contacts (each corner a capsule-plane lane of
# radius 0); hopper and walker2d
# ---------------------------------------------------------------------------


def _box_scene_states(name, device, n):
    """(env, {state: (qp, act)}) of fetch (pbd_parity.fetch_states), or of
    hopper or walker2d (a reset and 10 twin steps after it)."""
    from brax_torch import envs
    from brax_torch.tools import pbd_parity

    env = envs.create(name, episode_length=1000, batch_size=n, device=device)
    if name == "fetch":
        return env, pbd_parity.fetch_states(env.unwrapped, n, 0, device)
    return env, pbd_parity.force_scene_states(name, env, n, 0, device)


@pytest.mark.parametrize("n", [128, 2048, 4096])
def test_fetch_kernel_matches_twin_by_batch(cuda, n):
    """fetch from a reset and with its feet on the ground, over one pass
    and over the whole step, by the rules chip_smoke.py holds it to
    (pbd_parity.RULES): 32 lanes, one env a warp, PBD_KG 8."""
    from brax_torch.tools import pbd_parity

    env, states = _box_scene_states("fetch", cuda, n)
    p = kernels.plan(env.sys)
    assert (p.lanes, p.widths[3], p.nc) == (32, 8, 32)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for state, (qp, act) in states.items():
        before = kernels.pbd_step_launch.launches
        pbd_parity.hold_capcap("fetch", state, env.sys, qp, act, gen, f"fetch {state} ")
        assert kernels.pbd_step_launch.launches == before + 2


@pytest.mark.parametrize("name", ["hopper", "walker2d"])
@pytest.mark.parametrize("n", [1, 4097])
def test_hopper_walker2d_kernel_matches_twin_by_batch(cuda, name, n):
    from brax_torch.tools import pbd_parity

    env, states = _box_scene_states(name, cuda, n)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for state, (qp, act) in states.items():
        pbd_parity.hold_capcap(name, state, env.sys, qp, act, gen, f"{name} {state} ")


def test_fetch_kernel_gives_the_same_bits_twice_and_from_a_graph(cuda):
    env, states = _box_scene_states("fetch", cuda, 1024)
    qp, act = states["feet on the ground"]
    want, info_want = kernels.pbd_step(env.sys, qp, act)
    again, info_again = kernels.pbd_step(env.sys, qp, act)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.pbd_step(env.sys, qp, act)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, info_got = kernels.pbd_step(env.sys, qp, act)
    got.vel.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    fields = lambda q, i: (q.pos, q.rot, q.vel, q.ang, i.contact.vel, i.contact.ang)
    for x, y, z in zip(fields(want, info_want), fields(again, info_again),
                       fields(got, info_got)):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_fetch_hopper_walker2d_env_step_launches_the_kernel_once(cuda):
    from brax_torch import envs

    for name, obs, n_act in (("fetch", 101, 10), ("hopper", 11, 3), ("walker2d", 17, 6)):
        env = envs.create(name, batch_size=64)
        state = env.reset(torch.Generator(device=cuda).manual_seed(0))
        before = kernels.pbd_step_launch.launches
        for _ in range(3):
            state = env.step(state, torch.rand((64, n_act), device=cuda) * 2 - 1)
        assert kernels.pbd_step_launch.launches == before + 3
        assert state.obs.shape == (64, obs) and bool(torch.isfinite(state.obs).all())


@pytest.mark.parametrize("name", ["fetch", "hopper", "walker2d"])
def test_box_plane_and_walker_scenes_compile_no_section(cuda, name):
    """fetch's, hopper's and walker2d's kernels compile none of the
    optional sections: their SASS equals that of a build whose source has
    every PBD_SPHERICAL, PBD_CAPCAP, PBD_FORCES and PBD_ANGLE block cut out,
    as ant's does."""
    env, _ = _box_scene_states(name, cuda, 1)
    whole = kernels.kernel_source(env.sys)
    cut = whole.with_name(whole.stem + "_without_sections.cu")
    cut.write_text(_without_blocks(whole.read_text(), ("PBD_SPHERICAL", "PBD_CAPCAP",
                                                       "PBD_FORCES", "PBD_ANGLE")))
    assert "#ifdef PBD_CAPCAP" not in cut.read_text()
    assert _sass(whole) == _sass(cut) != []


# ---------------------------------------------------------------------------
# legacy spring (PBD_SPRING): the eight envs legacy_spring=True switches
# ---------------------------------------------------------------------------

SPRING_SCENES = ("ant", "halfcheetah", "humanoid_legacy", "humanoidstandup", "inverted_pendulum",
                 "inverted_double_pendulum", "reacher", "reacherangle")
# the earlier Systems (tests/test_torch_pbd_launch.py's scenes, grasp,
# acrobot, ur5e, fetch, hopper, walker2d)
EARLIER_SCENES = ("ant", "two_legged_ant", "humanoid", "humanoidstandup", "halfcheetah",
                  "pusher", "inverted_pendulum", "inverted_double_pendulum", "swimmer",
                  "reacherangle", "reacher", "grasp", "acrobot", "ur5e", "fetch", "hopper",
                  "walker2d")


@pytest.fixture(scope="module")
def spring_built():
    """Every spring System's kernel and its one-substep kernel, built in
    parallel (one nvcc each) before the tests that launch them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    from brax_torch.tools import pbd_parity

    systems = [pbd_parity.spring_env(name, 1, "cuda").sys for name in SPRING_SCENES]
    cuda_build.build(*(kernels.kernel_source(s) for s in systems),
                     *(kernels.kernel_source(pbd_parity.one_pass(s)) for s in systems))


@pytest.mark.parametrize("name", SPRING_SCENES)
@pytest.mark.parametrize("n", [1, 2, 4097])
def test_spring_kernel_matches_twin_by_batch(cuda, spring_built, name, n):
    """Each spring System from a reset and 10 twin steps after it
    (pbd_parity.spring_states), over one substep and over the whole step,
    by the rules chip_smoke.py holds it to (pbd_parity.RULES, "<env>_spring"),
    on ragged batches (a warp's last env copied), one launch each."""
    from brax_torch.tools import pbd_parity

    env = pbd_parity.spring_env(name, n, cuda)
    assert kernels.plan(env.sys).spring and kernels.unsupported_features(env.sys) == []
    gen = torch.Generator(device=cuda).manual_seed(7)
    for state, (qp, act) in pbd_parity.spring_states(name, env, n, 0, cuda).items():
        before = kernels.pbd_step_launch.launches
        pbd_parity.hold_capcap(f"{name}_spring", state, env.sys, qp, act, gen,
                               f"{name} spring {state} ")
        assert kernels.pbd_step_launch.launches == before + 2


def test_spring_kernel_gives_the_same_bits_twice_and_from_a_graph(cuda, spring_built):
    from brax_torch.tools import pbd_parity

    env = pbd_parity.spring_env("humanoid_legacy", 1024, cuda)
    qp, act = pbd_parity.spring_states("humanoid_legacy", env, 1024, 0, cuda)[
        pbd_parity.SPRING_STATES[1]]
    want, info_want = kernels.pbd_step(env.sys, qp, act)
    again, info_again = kernels.pbd_step(env.sys, qp, act)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.pbd_step(env.sys, qp, act)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, info_got = kernels.pbd_step(env.sys, qp, act)
    got.vel.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    fields = lambda q, i: (q.pos, q.rot, q.vel, q.ang, i.contact.vel, i.contact.ang)
    for x, y, z in zip(fields(want, info_want), fields(again, info_again),
                       fields(got, info_got)):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_spring_env_step_launches_the_kernel_once(cuda, spring_built):
    """envs.create(name, legacy_spring=True) steps with one launch per
    env.step; inverted_double_pendulum's env cannot reset (nor can the
    JAX one), and its System steps with one launch per sys.step."""
    from brax_torch import envs

    obs = {"ant": 87, "halfcheetah": 18, "humanoid_legacy": 227, "humanoidstandup": 227,
           "inverted_pendulum": 4, "reacher": 11, "reacherangle": 11}
    for name, width in obs.items():
        env = envs.create(name, batch_size=64, legacy_spring=True)
        assert env.sys.dynamics_mode == "legacy_spring"
        state = env.reset(torch.Generator(device=cuda).manual_seed(0))
        before = kernels.pbd_step_launch.launches
        for _ in range(3):
            state = env.step(state, torch.rand((64, env.action_size), device=cuda) * 2 - 1)
        assert kernels.pbd_step_launch.launches == before + 3
        assert state.obs.shape == (64, width) and bool(torch.isfinite(state.obs).all())
    env = envs.create("inverted_double_pendulum", batch_size=64, legacy_spring=True)
    with pytest.raises(RuntimeError, match="must match the size"):
        env.reset(torch.Generator(device=cuda).manual_seed(0))
    zero = torch.zeros((64, 0), device=cuda)
    qp = env.unwrapped.default_qp(joint_angle=zero, joint_velocity=zero)
    before = kernels.pbd_step_launch.launches
    out, _ = env.sys.step(qp, torch.rand((64, 1), device=cuda) * 2 - 1)
    assert kernels.pbd_step_launch.launches == before + 1 and bool(torch.isfinite(out.pos).all())


@pytest.fixture(scope="module")
def earlier_cut_sources():
    """{scene: (source, source with every PBD_SPRING block cut out)} of the
    earlier Systems, both built in parallel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    from brax_torch.envs import Acrobot, Fetch, Grasp, Hopper, Ur5e, Walker2d
    from tests.test_torch_pbd_launch import _system

    made = {"grasp": Grasp, "acrobot": Acrobot, "ur5e": Ur5e, "fetch": Fetch, "hopper": Hopper,
            "walker2d": Walker2d}
    pairs = {}
    for name in EARLIER_SCENES:
        sys_ = made[name](batch_size=1, device="cpu").sys if name in made else _system(name)
        whole = kernels.kernel_source(sys_)
        cut = whole.with_name(whole.stem + "_without_spring.cu")
        cut.write_text(_without_blocks(whole.read_text(), ("PBD_SPRING",)))
        pairs[name] = (whole, cut)
    cuda_build.build(*(p for pair in pairs.values() for p in pair))
    return pairs


@pytest.mark.parametrize("name", EARLIER_SCENES)
def test_earlier_scenes_compile_as_without_the_spring_section(cuda, earlier_cut_sources, name):
    """Each earlier System's kernel holds none of the legacy-spring section:
    its SASS equals that of a build whose source has every PBD_SPRING block
    cut out (the parent's bits and speed: python -m
    brax_torch.tools.pbd_turns)."""
    whole, cut = earlier_cut_sources[name]
    assert "#ifdef PBD_SPRING" in whole.read_text() and "#ifdef PBD_SPRING" not in cut.read_text()
    assert _sass(whole) == _sass(cut) != []


# ---------------------------------------------------------------------------
# fused MLP kernels
# ---------------------------------------------------------------------------

# f32: tests/test_fused_mlp.py's tolerances; bf16: BF16_REL of the largest
# plain-version value (tests/test_torch_fused_mlp.py)
BF16_REL = 1e-2


def _chain(device, lead, d0, sizes, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dims = [d0, *sizes]
    x = torch.randn(lead + (d0,), generator=gen)
    ws = [(torch.rand((a, b), generator=gen) * 2 - 1) * (3.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.randn((b,), generator=gen) * 0.1 for b in dims[1:]]
    g = torch.randn(lead + (dims[-1],), generator=gen)
    to = lambda t: t.to(device)
    return to(x), [to(w) for w in ws], [to(b) for b in bs], to(g)


def _close(got, want, bf16, kind):
    if bf16:
        err = float((got - want).abs().max())
        assert err <= BF16_REL * float(want.abs().max()), (kind, err)
    elif kind == "fwd":
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("lead,d0,sizes,activation", [
    ((137,), 87, (256,) * 5 + (1,), "swish"),
    ((137,), 87, (32,) * 4 + (16,), "swish"),
    ((137,), 27, (256,) * 5 + (1,), "swish"),
    ((137,), 27, (32,) * 4 + (16,), "swish"),
    ((137,), 240, (256,) * 5 + (1,), "swish"),
    ((137,), 240, (32,) * 4 + (34,), "swish"),
    ((137,), 18, (256,) * 5 + (1,), "swish"),
    ((137,), 18, (32,) * 4 + (12,), "swish"),
    ((64,), 87, (64, 64, 8), "relu"),
    ((33,), 87, (40, 3), "tanh"),
    ((5, 33), 29, (64, 7), "swish"),
])
def test_fused_kernels_match_plain(cuda, lead, d0, sizes, activation, bf16):
    x, ws, bs, g = _chain(cuda, lead, d0, sizes)
    x2, g2 = x.reshape(-1, d0), g.reshape(-1, sizes[-1])
    y = fused_mlp.chain_fwd(x2, ws, bs, activation, bf16)
    dx, dws, dbs = fused_mlp.chain_bwd(x2, ws, bs, g2, activation, bf16)
    torch.cuda.synchronize()
    _close(y, fused_mlp.chain_fwd_plain(x2, ws, bs, activation, bf16), bf16, "fwd")
    pdx, pdws, pdbs = fused_mlp.chain_bwd_plain(x2, ws, bs, g2, activation, bf16)
    for got, want in zip([dx, *dws, *dbs], [pdx, *pdws, *pdbs]):
        _close(got, want, bf16, "bwd")


def test_dense_chain_autograd_launches_both_kernels(cuda):
    x, ws, bs, g = _chain(cuda, (5, 33), 29, (64, 7))
    ws = [w.requires_grad_() for w in ws]
    bs = [b.requires_grad_() for b in bs]
    x.requires_grad_()
    fwd0, bwd0 = fused_mlp.chain_fwd.launches, fused_mlp.chain_bwd.launches
    y = fused_mlp.dense_chain(x, ws, bs, activation="swish", matmul_dtype=torch.float32)
    assert fused_mlp.chain_fwd.launches == fwd0 + 1 and y.shape == (5, 33, 7)
    y.backward(g)
    assert fused_mlp.chain_bwd.launches == bwd0 + 1
    ref = [t.detach().clone().requires_grad_() for t in (x, *ws, *bs)]
    y_ref = fused_mlp.dense_chain_plain(ref[0], ref[1:3], ref[3:], "swish", torch.float32)
    y_ref.backward(g)
    _close(y, y_ref, False, "fwd")
    for got, want in zip((x, *ws, *bs), ref):
        _close(got.grad, want.grad, False, "bwd")


def test_fused_kernels_raise_on_width_above_max(cuda):
    x, ws, bs, g = _chain(cuda, (8,), 8, (fused_mlp.MAX_WIDTH + 1, 2))
    with pytest.raises(NotImplementedError, match=str(fused_mlp.MAX_WIDTH + 1)):
        fused_mlp.chain_fwd(x, ws, bs)
    with pytest.raises(NotImplementedError, match=str(fused_mlp.MAX_WIDTH + 1)):
        fused_mlp.chain_bwd(x, ws, bs, g)


def test_fused_kernels_reject_cpu_mixed_inputs(cuda):
    x, ws, bs, g = _chain(cuda, (8,), 8, (16, 2))
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_mlp.chain_fwd(x, [ws[0].cpu(), ws[1]], bs)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_mlp.chain_bwd(x, ws, bs, g.cpu())


def test_fused_counters_advance_by_one_per_call(cuda):
    x, ws, bs, g = _chain(cuda, (8,), 8, (16, 2))
    for _ in range(3):
        fwd0, bwd0 = fused_mlp.chain_fwd.launches, fused_mlp.chain_bwd.launches
        fused_mlp.chain_fwd(x, ws, bs)
        assert fused_mlp.chain_fwd.launches == fwd0 + 1
        fused_mlp.chain_bwd(x, ws, bs, g)
        assert fused_mlp.chain_bwd.launches == bwd0 + 1


def _check_against_plain(x2, ws, bs, g2, activation, bf16):
    """Kernel against plain version, forward and backward, at the file's
    tolerances; returns the kernel's outputs."""
    y = fused_mlp.chain_fwd(x2, ws, bs, activation, bf16)
    dx, dws, dbs = fused_mlp.chain_bwd(x2, ws, bs, g2, activation, bf16)
    torch.cuda.synchronize()
    _close(y, fused_mlp.chain_fwd_plain(x2, ws, bs, activation, bf16), bf16, "fwd")
    pdx, pdws, pdbs = fused_mlp.chain_bwd_plain(x2, ws, bs, g2, activation, bf16)
    for got, want in zip([dx, *dws, *dbs], [pdx, *pdws, *pdbs]):
        _close(got, want, bf16, "bwd")
    return y, dx, dws, dbs


VALUE = (87, (256,) * 5 + (1,))
POLICY = (87, (32,) * 4 + (16,))


@pytest.mark.parametrize("chain", [VALUE, POLICY], ids=["value", "policy"])
def test_fused_kernels_give_the_same_bits_twice(cuda, chain):
    x, ws, bs, g = _chain(cuda, (5120,), *chain)
    first = [fused_mlp.chain_fwd(x, ws, bs), *_flat(fused_mlp.chain_bwd(x, ws, bs, g))]
    second = [fused_mlp.chain_fwd(x, ws, bs), *_flat(fused_mlp.chain_bwd(x, ws, bs, g))]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _flat(grads):
    dx, dws, dbs = grads
    return [dx, *dws, *dbs]


@pytest.mark.parametrize("rows", [1, 63, 65, 5127])
@pytest.mark.parametrize("chain", [VALUE, POLICY], ids=["value", "policy"])
def test_fused_kernels_ragged_rows(cuda, chain, rows):
    """1 row, one less and one more than the recipe plan's 64-row tile,
    and 5120 + 7 rows."""
    x, ws, bs, g = _chain(cuda, (rows,), *chain)
    _check_against_plain(x, ws, bs, g / rows, "swish", True)


@pytest.mark.parametrize("width", [1, 16, 27, 87, 255, 256])
def test_fused_kernels_at_every_width(cuda, width):
    x, ws, bs, g = _chain(cuda, (300,), width, (width, 64, width))
    _check_against_plain(x, ws, bs, g, "swish", True)


@pytest.mark.parametrize("d0,sizes", [(87, (16,)), (64, (64,) * 8), (256, (256,) * 8)],
                         ids=["1-layer", "8-layers", "8x256"])
def test_fused_kernels_one_and_eight_layers(cuda, d0, sizes):
    x, ws, bs, g = _chain(cuda, (700,), d0, sizes)
    _check_against_plain(x, ws, bs, g, "swish", True)


# relu' is a step at 0.  In bf16 mode a pre-activation near 0 can fall on
# either side in the kernel and in the plain version: their sums run in
# other orders, an activation then rounds to a neighbouring bf16 number, and
# the next layer's z moves by ~1e-3, so on the 256-wide chain some rows'
# gradients differ by their whole size.  relu is held here in bf16 forward
# (continuous) and in f32 mode backward, on the rows whose plain
# pre-activations all lie further than RELU_KINK from 0 (f32 sums differ by
# ~1e-6; some 90% of the rows); test_fused_kernels_match_plain holds the
# bf16 relu backward on a chain narrow enough to have no such row.
RELU_KINK = 1e-5


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_fused_kernels_relu_tanh_on_the_value_chain(cuda, activation):
    x, ws, bs, g = _chain(cuda, (1024,), *VALUE)
    g = g / 1024
    if activation == "tanh":
        _check_against_plain(x, ws, bs, g, activation, True)
        return
    y = fused_mlp.chain_fwd(x, ws, bs, activation, True)
    _close(y, fused_mlp.chain_fwd_plain(x, ws, bs, activation, True), True, "fwd")
    zs = fused_mlp._forward_plain(x, ws, bs, activation, False, keep=True)[2]
    clear = torch.stack([z.abs().amin(dim=1) for z in zs]).amin(dim=0) > RELU_KINK
    assert int(clear.sum()) > 900
    _check_against_plain(x[clear].contiguous(), ws, bs, g[clear].contiguous(), activation, False)


@pytest.mark.parametrize("chain", [VALUE, POLICY], ids=["value", "policy"])
def test_fused_kernels_f32_mode_ragged(cuda, chain):
    x, ws, bs, g = _chain(cuda, (5127,), *chain)
    _check_against_plain(x, ws, bs, g / 5127, "swish", False)


def test_dense_chain_captured_in_a_cuda_graph(cuda):
    """Forward and backward of dense_chain captured in one CUDA graph: the
    replay equals the eager result bit for bit."""
    x, ws, bs, g = _chain(cuda, (1024,), *VALUE)
    params = [t.requires_grad_() for t in (*ws, *bs)]

    def step():
        y = fused_mlp.dense_chain(x, params[:6], params[6:])
        return (y, *torch.autograd.grad(y, params, g))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    eager = step()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_fused_kernels_raise_on_a_chain_too_deep(cuda):
    x, ws, bs, g = _chain(cuda, (8,), 8, (16,) * (fused_mlp.MAX_LAYERS + 1))
    with pytest.raises(NotImplementedError, match=str(fused_mlp.MAX_LAYERS + 1)):
        fused_mlp.chain_fwd(x, ws, bs)
    with pytest.raises(NotImplementedError, match=str(fused_mlp.MAX_LAYERS + 1)):
        fused_mlp.chain_bwd(x, ws, bs, g)


# ---------------------------------------------------------------------------
# SAC: the fused MLP's Q route
# ---------------------------------------------------------------------------

# SAC's critics take the observation and the action together: humanoid's
# 240 + 17 = 257 inputs (past MAX_WIDTH), halfcheetah's 18 + 6, and the
# widest input the kernels hold
Q_CHAINS = {"humanoid": (257, (256, 256, 1)), "halfcheetah": (24, (256, 256, 1)),
            "widest": (fused_mlp.MAX_IN_WIDTH, (256, 256, 1))}


@pytest.mark.parametrize("name", sorted(Q_CHAINS))
def test_q_chain_relu_matches_plain_by_the_kink_rule(cuda, name):
    """relu at the critics' shapes (RELU_KINK's rule): bf16 forward, and
    f32 mode backward on the rows clear of the kink."""
    d0, sizes = Q_CHAINS[name]
    x, ws, bs, g = _chain(cuda, (256,), d0, sizes)
    g = g / 256
    y = fused_mlp.chain_fwd(x, ws, bs, "relu", True)
    _close(y, fused_mlp.chain_fwd_plain(x, ws, bs, "relu", True), True, "fwd")
    zs = fused_mlp._forward_plain(x, ws, bs, "relu", False, keep=True)[2]
    clear = torch.stack([z.abs().amin(dim=1) for z in zs]).amin(dim=0) > RELU_KINK
    assert int(clear.sum()) > 200
    _check_against_plain(x[clear].contiguous(), ws, bs, g[clear].contiguous(), "relu", False)


@pytest.mark.parametrize("rows", [1, 17, 256, 1029])
@pytest.mark.parametrize("name", sorted(Q_CHAINS))
def test_q_chain_bf16_matches_plain_whole(cuda, name, rows):
    """The bf16 kernels, dx's second round of columns included, on every
    row: swish (no kink) at the critics' shapes."""
    x, ws, bs, g = _chain(cuda, (rows,), *Q_CHAINS[name])
    _check_against_plain(x, ws, bs, g / rows, "swish", True)


@pytest.mark.parametrize("rows", [128, 256])
@pytest.mark.parametrize("name", sorted(Q_CHAINS) + ["policy_humanoid"])
def test_sac_chain_relu_bf16_backward_every_row(cuda, name, rows):
    """relu's bf16 backward (the mode SAC's path launches) on every row,
    held by what bf16 rounding moves at the kink: dx differs from the plain
    bf16 version's by more than BF16_REL of its largest value on no more
    rows than those where the plain version's bf16 and f32 pre-activations
    put some unit on other sides of 0; each dW's and db's relative norm
    error is at most the plain bf16 version's own against f32, or f32
    mode's rtol 2e-4 where that is smaller (the last db)."""
    d0, sizes = Q_CHAINS.get(name, (240, (256, 256, 34)))
    x, ws, bs, g = _chain(cuda, (rows,), d0, sizes)
    g = g / rows
    got = fused_mlp.chain_bwd(x, ws, bs, g, "relu", True)
    plain = fused_mlp.chain_bwd_plain(x, ws, bs, g, "relu", True)
    plain_f32 = fused_mlp.chain_bwd_plain(x, ws, bs, g, "relu", False)
    z16, z32 = (fused_mlp._forward_plain(x, ws, bs, "relu", bf16, keep=True)[2]
                for bf16 in (True, False))
    torch.cuda.synchronize()
    flipped = torch.stack([((a > 0) != (b > 0)).any(dim=1) for a, b in zip(z16, z32)])
    off = (got[0] - plain[0]).abs().amax(dim=1) > BF16_REL * plain[0].abs().max()
    assert int(off.sum()) <= int(flipped.any(dim=0).sum())
    norm_err = lambda a, b: float((a - b).norm() / b.norm())
    for j in (1, 2):
        for i, (a, b, c) in enumerate(zip(got[j], plain[j], plain_f32[j])):
            assert norm_err(a, b) <= max(norm_err(b, c), 2e-4), (j, i)


def test_narrow_relu_q_chain_bf16_backward_whole(cuda):
    """relu in bf16, forward and backward on every row, on a 257-wide input
    with hidden layers narrow enough that no row's pre-activation lies near
    the kink."""
    x, ws, bs, g = _chain(cuda, (256,), 257, (32, 32, 1))
    _check_against_plain(x, ws, bs, g / 256, "relu", True)


def test_fused_kernels_raise_on_input_above_max_in_width(cuda):
    width = fused_mlp.MAX_IN_WIDTH + 1
    x, ws, bs, g = _chain(cuda, (8,), width, (256, 1))
    for bf16 in (True, False):
        with pytest.raises(NotImplementedError, match=str(width)):
            fused_mlp.chain_fwd(x, ws, bs, "relu", bf16)
        with pytest.raises(NotImplementedError, match=str(width)):
            fused_mlp.chain_bwd(x, ws, bs, g, "relu", bf16)


def test_q_route_captured_in_a_cuda_graph(cuda):
    """The humanoid critics' forward and backward (dx into obs and action,
    every dW and db) captured in one CUDA graph: the replay equals the
    eager result bit for bit; two launches of each kernel a step."""
    from brax_torch.training import networks

    q = networks.make_q_network(240, 17, device=cuda)
    params = q.init(torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    obs = torch.randn((256, 240), generator=gen, device=cuda).requires_grad_()
    act = (torch.rand((256, 17), generator=gen, device=cuda) * 2 - 1).requires_grad_()
    g = torch.randn((256, 2), generator=gen, device=cuda) / 256

    def step():
        y = q(None, params, obs, act)
        return (y, *torch.autograd.grad(y, [obs, act, *params.values()], g))

    with fused_mlp.enabled_as(True):
        fwd0, bwd0 = fused_mlp.chain_fwd.launches, fused_mlp.chain_bwd.launches
        step()
        assert (fused_mlp.chain_fwd.launches - fwd0, fused_mlp.chain_bwd.launches - bwd0) == (2, 2)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = step()
        eager = step()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_sac_training_step_launches_exactly(cuda):
    """sac.train on humanoid: one prefill actor step, one training step of
    2 SGD steps, an 8-step eval.  Fused forward: 1 + (1 + 2 x 9) + 8 (an
    SGD step runs the policy in each loss, the critics in the critic and
    actor losses, the target critics once); backward 2 x 5 (the critics
    twice, the policy once); PBD 1 + 1 + 8."""
    from brax_torch.training.agents.sac import train as sac

    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    _, _, metrics = sac.train("humanoid", num_timesteps=32, episode_length=8, num_envs=16,
                              num_eval_envs=16, batch_size=32, min_replay_size=16,
                              grad_updates_per_step=2, normalize_observations=True,
                              device=cuda)
    launches = (fused_mlp.chain_fwd.launches, fused_mlp.chain_bwd.launches,
                kernels.pbd_step_launch.launches)
    assert launches == (28, 10, 10)
    for k in ("critic_loss", "actor_loss", "alpha_loss", "alpha"):
        assert torch.isfinite(torch.tensor(metrics[f"training/{k}"])), k


# ---------------------------------------------------------------------------
# generalized step (v2)
# ---------------------------------------------------------------------------

# tests/test_v2_generalized_kernel.py's tolerances
GEN_TOL = {"q": 2e-5, "qd": 2e-4, "minv": 2e-5, "x_pos": 2e-5, "x_rot": 2e-5, "xd_ang": 2e-4,
           "xd_vel": 2e-4, "c_pos": 2e-5, "c_pen": 2e-5}


def _gen_state(device, n, steps=10):
    """n v2 ants after `steps` plain-version env steps, and one more action."""
    env = v2_envs.create("ant", batch_size=n, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    ps = env.reset(gen).pipeline_state
    q, qd, minv = ps.q, ps.qd, ps.mass_mx_inv
    for _ in range(steps):
        act = torch.rand((n, 8), generator=gen, device=device) * 2 - 1
        out = gen_kernels.gen_step_plain(env.sys, q, qd, minv, act, 5)
        q, qd, minv = out["q"], out["qd"], out["minv"]
    act = torch.rand((n, 8), generator=gen, device=device) * 2 - 1
    return env.unwrapped.sys, (q, qd, minv, act)


@pytest.mark.parametrize("n", [128, 4096])
@pytest.mark.parametrize("n_frames", [1, 5])
def test_gen_kernel_matches_plain(cuda, n, n_frames):
    """Every env within tolerance at one frame; at five, where contact
    thresholds can fall apart by rounding, all but 1 in 1000."""
    sys, ins = _gen_state(cuda, n)
    before = gen_kernels.gen_step_soa.launches
    got = gen_kernels.gen_step(sys, *ins, n_frames)
    torch.cuda.synchronize()
    assert gen_kernels.gen_step_soa.launches == before + 1
    want = gen_kernels.gen_step_plain(sys, *ins, n_frames)
    inside = torch.ones(n, dtype=torch.bool, device=cuda)
    for k, tol in GEN_TOL.items():
        assert torch.isfinite(got[k]).all(), k
        inside &= (got[k] - want[k]).abs().reshape(n, -1).amax(dim=1) <= tol
    assert int((~inside).sum()) <= (0 if n_frames == 1 else n // 1000), int((~inside).sum())


def test_gen_kernel_matches_plain_in_contact(cuda):
    """Five frames from a contact-rich reset (the torso lowered by up to
    0.35), 4096 envs: all but 1 in 1000 within tolerance."""
    n = 4096
    env = v2_envs.create("ant", batch_size=n, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    q_noise = torch.rand((n, 15), generator=gen, device=cuda) * 0.2 - 0.1
    q_noise[:, 2] -= torch.rand(n, generator=gen, device=cuda) * 0.35
    ps = env.unwrapped.reset_from_noise(
        q_noise, 0.1 * torch.randn((n, 14), generator=gen, device=cuda)).pipeline_state
    assert float((ps.contact.penetration > 0).any(dim=1).float().mean()) > 0.5
    ins = (ps.q, ps.qd, ps.mass_mx_inv, torch.rand((n, 8), generator=gen, device=cuda) * 2 - 1)
    got = gen_kernels.gen_step(env.unwrapped.sys, *ins, 5)
    want = gen_kernels.gen_step_plain(env.unwrapped.sys, *ins, 5)
    inside = torch.ones(n, dtype=torch.bool, device=cuda)
    for k, tol in GEN_TOL.items():
        inside &= (got[k] - want[k]).abs().reshape(n, -1).amax(dim=1) <= tol
    assert int((~inside).sum()) <= n // 1000, int((~inside).sum())


def test_gen_env_step_launches_once_per_step(cuda):
    env = v2_envs.create("ant", batch_size=256, device=cuda)
    state = env.reset(torch.Generator(device=cuda).manual_seed(1))
    before = gen_kernels.gen_step_soa.launches
    for _ in range(3):
        state = env.step(state, torch.zeros((256, 8), device=cuda))
    torch.cuda.synchronize()
    assert gen_kernels.gen_step_soa.launches == before + 3
    assert state.obs.shape == (256, 27) and torch.isfinite(state.obs).all()


def test_gen_kernel_raises_on_unsupported_system_and_cpu_inputs(cuda):
    sys, ins = _gen_state(cuda, 32, steps=0)
    other = dataclasses.replace(sys, actuator_types="p" * 8)
    with pytest.raises(NotImplementedError, match="actuator types"):
        gen_kernels.gen_step(other, *ins, 1)
    with pytest.raises(ValueError, match="one CUDA device"):
        gen_kernels.gen_step(sys, *ins[:3], ins[3].cpu(), 1)


# the v2 envs beside ant that the generalized kernel covers
V2_ENVS = ("inverted_pendulum", "inverted_double_pendulum", "reacher", "halfcheetah", "hopper",
           "walker2d")


@pytest.fixture(scope="module")
def gen_scenes():
    """Builds the kernel of every v2 scene at once, one nvcc each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    systems = [v2_envs.get_environment(name, device="cuda").sys for name in V2_ENVS]
    cuda_build.build(*(gen_kernels.kernel_source(s) for s in systems))


@pytest.mark.parametrize("name", V2_ENVS)
def test_gen_kernel_matches_plain_per_env(cuda, gen_scenes, name):
    """128 envs of each scene: three env steps, one launch each, then one
    kernel call against the plain version at the env's n_frames, every env
    within tolerance."""
    n = 128
    env = v2_envs.create(name, batch_size=n, device=cuda)
    bare = env.unwrapped
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = env.reset(gen)
    act = lambda: torch.rand((n, bare.action_size), generator=gen, device=cuda) * 2 - 1
    before = gen_kernels.gen_step_soa.launches
    for _ in range(3):
        state = env.step(state, act())
    torch.cuda.synchronize()
    assert gen_kernels.gen_step_soa.launches == before + 3
    assert torch.isfinite(state.obs).all()
    ps = state.pipeline_state
    ins = (ps.q, ps.qd, ps.mass_mx_inv, act())
    got = gen_kernels.gen_step(bare.sys, *ins, bare._n_frames)
    want = gen_kernels.gen_step_plain(bare.sys, *ins, bare._n_frames)
    assert sorted(got) == sorted(want)
    inside = torch.ones(n, dtype=torch.bool, device=cuda)
    for k, v in want.items():
        assert torch.isfinite(got[k]).all(), k
        inside &= (got[k] - v).abs().reshape(n, -1).amax(dim=1) <= GEN_TOL[k]
    assert bool(inside.all()), int((~inside).sum())


@pytest.mark.parametrize("name", ["ant", "halfcheetah"])
@pytest.mark.parametrize("n", [1, 33, 4095])
def test_gen_kernel_ragged_batches(cuda, gen_scenes, name, n):
    """A warp per env, several envs per block: at ragged batch sizes every
    env matches the plain version bit for bit, or within tolerance in all
    but 1 in 1000 (chip_smoke.py's rule), and its outputs do not depend on
    how many envs share its block."""
    env = v2_envs.create(name, batch_size=n, device=cuda)
    bare = env.unwrapped
    gen = torch.Generator(device=cuda).manual_seed(n)
    act = lambda: torch.rand((n, bare.action_size), generator=gen, device=cuda) * 2 - 1
    state = env.reset(gen)
    for _ in range(2):
        state = env.step(state, act())
    ps = state.pipeline_state
    ins = (ps.q, ps.qd, ps.mass_mx_inv, act())
    nf = bare._n_frames
    got = gen_kernels.gen_step(bare.sys, *ins, nf)
    want = gen_kernels.gen_step_plain(bare.sys, *ins, nf)
    identical = torch.ones(n, dtype=torch.bool, device=cuda)
    inside = torch.ones(n, dtype=torch.bool, device=cuda)
    for k, v in want.items():
        assert torch.isfinite(got[k]).all(), k
        identical &= (got[k] == v).reshape(n, -1).all(dim=1)
        inside &= (got[k] - v).abs().reshape(n, -1).amax(dim=1) <= GEN_TOL[k]
    assert int((~inside).sum()) <= n // 1000, (int(identical.sum()), int((~inside).sum()))
    soa = tuple(x.reshape(n, -1).t().contiguous() for x in ins)
    top = gen_kernels.max_envs_per_block(gen_kernels.plan(bare.sys))
    base = gen_kernels.gen_step_soa(bare.sys, *soa, nf, block=1)
    for block in (2, top):
        other = gen_kernels.gen_step_soa(bare.sys, *soa, nf, block=block)
        assert all(torch.equal(other[k], base[k]) for k in base), block


def test_gen_kernel_rejects_blocks_past_its_shared_memory(cuda):
    sys, ins = _gen_state(cuda, 32, steps=0)
    soa = tuple(x.reshape(32, -1).t().contiguous() for x in ins)
    top = gen_kernels.max_envs_per_block(gen_kernels.plan(sys))
    with pytest.raises(ValueError, match="outside"):
        gen_kernels.gen_step_soa(sys, *soa, 1, block=top + 1)


# ---------------------------------------------------------------------------
# launch-overhead probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,k", [(64, 3), (512, 6), (5120, 24), (1, 1), (100, 6),
                                    (5121, 24), (512, 1)])
def test_probe_dot_chain_matches_plain(cuda, rows, k):
    """bf16 products with f32 sums, summed in another order than the plain
    version's: max |err| <= 1e-2 max |plain| (the fused MLP's bf16 rule)."""
    gen = torch.Generator(device=cuda).manual_seed(rows + k)
    x = torch.randn((rows, probe.WIDTH), generator=gen, device=cuda)
    w = torch.randn((probe.WIDTH, probe.WIDTH), generator=gen, device=cuda) * 0.05
    before = probe.dot_chain.launches
    got = probe.dot_chain(x, w, k)
    torch.cuda.synchronize()
    assert probe.dot_chain.launches == before + 1
    want = probe.dot_chain_plain(x, w, k)
    assert float((got - want).abs().max()) <= BF16_REL * float(want.abs().max())


@pytest.mark.parametrize("blocks", [1, 10, 40])
def test_probe_copy_plus_one_is_exact(cuda, blocks):
    x = torch.randn(probe.TILE, device=cuda)
    before = probe.copy_plus_one.launches
    got = probe.copy_plus_one(x, blocks)
    torch.cuda.synchronize()
    assert probe.copy_plus_one.launches == before + 1
    assert torch.equal(got, probe.copy_plus_one_plain(x))


def test_probe_wrappers_raise_on_bad_inputs(cuda):
    x = torch.zeros((8, probe.WIDTH), device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        probe.dot_chain(x, torch.zeros((probe.WIDTH, probe.WIDTH)), 2)
    with pytest.raises(ValueError, match="takes"):
        probe.dot_chain(x[:, :128].contiguous(), torch.zeros((128, 128), device=cuda), 2)
    with pytest.raises(ValueError, match="at least one"):
        probe.dot_chain(x, torch.zeros((probe.WIDTH, probe.WIDTH), device=cuda), 0)


def test_probe_measure_times_every_key(cuda):
    replayed = probe.copy_plus_one.replayed, probe.dot_chain.replayed
    r = probe.result(probe.measure())
    keys = ("trivial_us", "grid10_us", "grid40_us", "dotchain6_us", "dotchain24_us",
            "dotchain5120_6_us", "dotchain5120_24_us", "fwd1_us", "fwd10_us")
    for key in keys:
        assert r[key] > 0 and r["host"][key] > 0, key
    assert sorted(r["cublas_chain"]) == sorted(k for k in keys if k.startswith("dotchain"))
    assert r["torch_add_trivial"]["graph"] > 0 and r["torch_add_trivial"]["host"] > 0
    # every graph replays its launches BATCHES + 1 times
    assert probe.copy_plus_one.replayed - replayed[0] == 3 * (probe.BATCHES + 1) * probe.LENGTH
    assert probe.dot_chain.replayed - replayed[1] == 4 * (probe.BATCHES + 1) * probe.CHAIN_LENGTH


@pytest.mark.parametrize("rows", [10240, 2048, 512, 128])
@pytest.mark.parametrize("chain", [(18, (256,) * 5 + (1,)), (18, (32,) * 4 + (12,))],
                         ids=["value", "policy"])
def test_fused_kernels_at_the_halfcheetah_chains(cuda, chain, rows):
    """halfcheetah's 18-wide observation at the recipe's rows: minibatch
    losses (512 x 20), the rollout (2048 envs), the bootstrap value (512),
    an evaluation (128), in the default bf16 mode."""
    x, ws, bs, g = _chain(cuda, (rows,), *chain)
    _check_against_plain(x, ws, bs, g / rows, "swish", True)


# ---------------------------------------------------------------------------
# APG: the physics steps' autograd Functions, the kernels forward
# ---------------------------------------------------------------------------


def test_pbd_function_gradients_equal_the_twins_bit_for_bit(cuda):
    """One step from the ant's contact state: the Function (one kernel
    launch forward, the twin's backward) against autograd through the twin."""
    env, qp, act = _contact_state(cuda, n=2048)
    ws = gp.weights(gp.pbd_outputs(*kernels.pbd_step_plain(env.sys, qp, act)))
    before = kernels.pbd_step_launch.launches
    with gp.deterministic():
        got = gp.pbd_grads(env.sys, qp, act, ws, kernels.pbd_step)
        want = gp.pbd_grads(env.sys, qp, act, ws, kernels.pbd_step_plain)
    torch.cuda.synchronize()
    assert kernels.pbd_step_launch.launches == before + 1
    assert gp.bit_identical(got, want)


def test_gen_function_gradients_equal_the_pipelines_bit_for_bit(cuda):
    env = v2_envs.create("ant", batch_size=512, device=cuda)
    state = env.reset(torch.Generator(device=cuda).manual_seed(0)).pipeline_state
    act = torch.rand((512, 8), generator=torch.Generator(device=cuda).manual_seed(1),
                     device=cuda) * 2 - 1
    ws = gp.weights(gen_kernels.float_leaves(state))
    before = gen_kernels.gen_step_soa.launches
    with gp.deterministic():
        got = gp.gen_grads(env.unwrapped.sys, state, act, 5, ws, "function")
        want = gp.gen_grads(env.unwrapped.sys, state, act, 5, ws, "pipeline")
    torch.cuda.synchronize()
    assert gen_kernels.gen_step_soa.launches == before + 1
    assert gp.bit_identical(got, want)


def test_grad_enabled_steps_launch_once_and_no_grad_steps_save_nothing(cuda):
    env, qp, act = _contact_state(cuda, n=256)
    leaf = act.clone().requires_grad_()
    before = kernels.pbd_step_launch.launches
    cur = qp
    for _ in range(3):
        (cur, _), saved = gp.saved_tensors(lambda: kernels.pbd_step(env.sys, cur, leaf))
        assert saved == 5 and type(cur.pos.grad_fn).__name__ == "PBDStepBackward"
    assert kernels.pbd_step_launch.launches == before + 3
    cur.pos.sum().backward()
    assert kernels.pbd_step_launch.launches == before + 3  # the backward is the twin's
    with torch.no_grad():
        (out, _), saved = gp.saved_tensors(lambda: kernels.pbd_step(env.sys, qp, leaf))
    assert saved == 0 and out.pos.grad_fn is None
    assert kernels.pbd_step_launch.launches == before + 4
    v2 = v2_envs.create("ant", batch_size=256, device=cuda)
    state = v2.reset(torch.Generator(device=cuda).manual_seed(1))
    v2_act = torch.zeros((256, 8), device=cuda, requires_grad=True)
    before = gen_kernels.gen_step_soa.launches
    for _ in range(3):
        state = v2.step(state, v2_act)
    torch.cuda.synchronize()
    assert gen_kernels.gen_step_soa.launches == before + 3
    grad = torch.autograd.grad(state.reward.sum(), v2_act)[0]
    assert gen_kernels.gen_step_soa.launches == before + 3
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


def test_no_grad_pbd_launch_replays_from_a_cuda_graph(cuda):
    """Inputs that require grad, stepped under no_grad: the plain launch,
    which a CUDA graph captures and replays to the eager bits."""
    env, qp, act = _contact_state(cuda, n=512)
    qp = dataclasses.replace(qp, pos=qp.pos.clone().requires_grad_())
    with torch.no_grad():
        want, _ = kernels.pbd_step(env.sys, qp, act)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernels.pbd_step(env.sys, qp, act)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got, _ = kernels.pbd_step(env.sys, qp, act)
        got.pos.fill_(float("nan"))
        graph.replay()
    torch.cuda.synchronize()
    assert got.pos.grad_fn is None
    for x, y in zip((want.pos, want.rot, want.vel, want.ang), (got.pos, got.rot, got.vel,
                                                               got.ang)):
        assert torch.equal(x, y)


def test_fused_policy_dx_reaches_the_physics_as_the_plain_chains(cuda, monkeypatch):
    """One APG step of the ant at 2048 envs: obs -> fused policy -> PBD
    step -> reward; d(reward)/d(obs) through the fused backward (its dx
    goes on into the physics) against the same step through the plain
    chain, within the fused tests' bf16 bound."""
    from brax_torch.training import networks
    from brax_torch.training.agents.apg import networks as apg_networks

    env, qp, _ = _contact_state(cuda, n=2048)
    state = env.reset(torch.Generator(device=cuda).manual_seed(0)).replace(qp=qp)
    state = state.replace(obs=env._get_obs(qp, env.sys.info(qp)))
    nets = apg_networks.make_apg_networks(87, 8, device=cuda)
    params = nets.policy_network.init(torch.Generator(device=cuda).manual_seed(0))
    policy = apg_networks.make_inference_fn(nets)((None, params), deterministic=True)

    def d_obs():
        obs = state.obs.clone().requires_grad_()
        nstate = env.step(state.replace(obs=obs), policy(obs, None)[0])
        return torch.autograd.grad(nstate.reward.sum(), obs)[0]

    with fused_mlp.enabled_as(True):
        before = fused_mlp.chain_bwd.launches
        got = d_obs()
        assert fused_mlp.chain_bwd.launches == before + 1
        monkeypatch.setattr(fused_mlp, "dense_chain", fused_mlp.dense_chain_plain)
        want = d_obs()
    assert networks.fused_mlp is fused_mlp
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()) and float(want.abs().max()) > 0
    assert err <= BF16_REL * float(want.abs().max()), err


# ---------------------------------------------------------------------------
# the composer's scenes: the PBD kernel past one warp (PBD_WIDE)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_states():
    """{name: (env, {state: (qp, act)})} of the 2- and 4-agent chase at 4096
    envs (pbd_parity.composer_states, seed 0), their kernels and one-pass
    kernels built together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    from brax_torch.tools import pbd_parity as pp

    envs_ = {name: pp.composer_env(name, 4096, "cuda") for name in pp.COMPOSER_WIDE}
    cuda_build.build(*(kernels.kernel_source(s) for e in envs_.values()
                       for s in (e.sys, pp.one_pass(e.sys))))
    return {name: (e, pp.composer_states(name, e, 4096, 0, "cuda")) for name, e in envs_.items()}


@pytest.mark.parametrize("name", ["chase", "chase4"])
def test_wide_kernel_matches_twin_by_its_rules(cuda, wide_states, name):
    """The wide route (64 lanes for the 2-agent chase, 256 for the 4-agent
    chase, an env a block) against the twin at 4096 envs from a reset, 10
    twin steps after it and with the ants overlapping, over one pass and the
    whole step, each by the rule pbd_parity.RULES names (chip_smoke.py's
    check); two launches a state."""
    from brax_torch.tools import pbd_parity as pp

    env, states = wide_states[name]
    p = kernels.plan(env.sys)
    assert p.wide and p.envs_per_block == 1 and p.lanes == (64 if name == "chase" else 256)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for state, (qp, act) in states.items():
        before = kernels.pbd_step_launch.launches
        pp.hold_capcap(name, state, env.sys, qp, act, gen, f"{name} {state} ")
        assert kernels.pbd_step_launch.launches == before + 2


@pytest.mark.parametrize("n", [1, 3, 4097])
def test_wide_kernel_ragged_batches(cuda, n):
    """The 2-agent chase on ragged batches (an env a block, so every batch
    is whole blocks), 10 twin steps after a reset, by its rules."""
    from brax_torch.tools import pbd_parity as pp

    env = pp.composer_env("chase", n, "cuda")
    qp, act = pp.composer_states("chase", env, n, 1, "cuda")[pp.COMPOSER_STATES[1]]
    assert kernels.launch_geometry(kernels.plan(env.sys), n) == (n, 64)
    pp.hold_capcap("chase", pp.COMPOSER_STATES[1], env.sys, qp, act,
                   torch.Generator(device=cuda).manual_seed(7), f"chase {n} ")


def test_wide_kernel_gives_the_same_bits_twice_and_from_a_graph(cuda, wide_states):
    from brax_torch.tools import pbd_parity as pp

    env, states = wide_states["chase4"]
    qp, act = states[pp.COMPOSER_STATES[2]]
    want, info_want = kernels.pbd_step(env.sys, qp, act)
    again, info_again = kernels.pbd_step(env.sys, qp, act)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.pbd_step(env.sys, qp, act)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, info_got = kernels.pbd_step(env.sys, qp, act)
    got.vel.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    fields = lambda q, i: (q.pos, q.rot, q.vel, q.ang, i.contact.vel, i.contact.ang)
    for x, y, z in zip(fields(want, info_want), fields(again, info_again),
                       fields(got, info_got)):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("fault", ["wide_warp_local", "wide_v3_swapped", "wide_float_own_lane"])
def test_planted_wide_fault_fails_its_rule(cuda, wide_states, fault):
    """A fault planted in the wide route's exchange (tests/pbd_faults.py)
    fails the rule chip_smoke.py holds the 2-agent chase's state 10 twin
    steps after a reset to over one pass (the rounding rule)."""
    from brax_torch.tools import pbd_parity as pp
    from brax_torch.tools import pbd_turns
    from tests import pbd_faults

    env, states = wide_states["chase"]
    qp, act = states[pp.COMPOSER_STATES[1]]
    sys_ = pp.one_pass(env.sys)
    assert pp.RULES["chase"][pp.COMPOSER_STATES[1]][0] == "max_errors"
    step = pbd_faults.card_step(pbd_turns.load(pbd_turns.other_source(
        sys_, pbd_faults.planted_path(fault))))
    got = pp.fields(*step(sys_, qp, act))
    r = pp.rounding_rule(sys_, qp, act, got, torch.Generator(device=cuda).manual_seed(7))
    assert not r["passes"], (fault, len(r["outliers"]), r["errs"])


def test_composer_env_step_launches_the_kernel_once(cuda):
    """Every composer scene (the 4-agent chase among them) at 64 envs: one
    PBD launch a step, finite observations, a reward an agent or one."""
    from brax_torch.tools import pbd_parity as pp

    for task in pp.COMPOSER_SCENES:
        env = pp.composer_scene(task, 64, cuda, episode_length=1000)
        state = env.reset(torch.Generator(device=cuda).manual_seed(0))
        before = kernels.pbd_step_launch.launches
        for _ in range(3):
            state = env.step(state, torch.rand((64, env.action_size), device=cuda) * 2 - 1)
        assert kernels.pbd_step_launch.launches == before + 3, task
        agents = len(env.unwrapped.agent_names)
        assert state.reward.shape == ((64, agents) if agents else (64,)), task
        assert bool(torch.isfinite(state.obs).all()), task


@pytest.fixture(scope="module")
def octopus_states():
    """(env, {state: (qp, act)}) of octopus_run at 4096 envs
    (pbd_parity.octopus_states, seed 0), its kernel and one-substep
    kernel built together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    from brax_torch.tools import pbd_parity as pp

    env = pp.composer_env(pp.OCTOPUS, 4096, "cuda")
    cuda_build.build(kernels.kernel_source(env.sys), kernels.kernel_source(pp.one_pass(env.sys)))
    return env, pp.octopus_states(env, 4096, 0, "cuda")


def test_octopus_kernel_matches_twin_by_its_rules(cuda, octopus_states):
    """octopus_run (PBD_WIDE with PBD_SPRING, 64 lanes) against the twin at
    4096 envs from a reset, 10 twin steps after it and jiggled, over one
    substep and the whole step, each by pbd_parity.RULES["octopus_run"]."""
    from brax_torch.tools import pbd_parity as pp

    env, states = octopus_states
    p = kernels.plan(env.sys)
    assert p.wide and p.spring and p.lanes == 64 and p.envs_per_block == 1
    gen = torch.Generator(device=cuda).manual_seed(7)
    for state, (qp, act) in states.items():
        before = kernels.pbd_step_launch.launches
        pp.hold_capcap(pp.OCTOPUS, state, env.sys, qp, act, gen, f"octopus_run {state} ")
        assert kernels.pbd_step_launch.launches == before + 2


@pytest.mark.parametrize("n", [1, 3, 4097])
def test_octopus_kernel_ragged_batches(cuda, n):
    from brax_torch.tools import pbd_parity as pp

    env = pp.composer_env(pp.OCTOPUS, n, "cuda")
    qp, act = pp.octopus_states(env, n, 1, "cuda")[pp.OCTOPUS_STATES[1]]
    assert kernels.launch_geometry(kernels.plan(env.sys), n) == (n, 64)
    pp.hold_capcap(pp.OCTOPUS, pp.OCTOPUS_STATES[1], env.sys, qp, act,
                   torch.Generator(device=cuda).manual_seed(7), f"octopus_run {n} ")


@pytest.mark.parametrize("fault", ["wide_warp_local", "wide_v3_swapped", "wide_float_own_lane"])
def test_planted_wide_fault_fails_octopus_rule(cuda, octopus_states, fault):
    """A fault planted in the wide route's exchange fails octopus_run's rule
    over one substep from the jiggled state (the rounding rule)."""
    from brax_torch.tools import pbd_parity as pp
    from brax_torch.tools import pbd_turns
    from tests import pbd_faults

    env, states = octopus_states
    qp, act = states[pp.OCTOPUS_STATES[2]]
    sys_ = pp.one_pass(env.sys)
    assert pp.RULES[pp.OCTOPUS][pp.OCTOPUS_STATES[2]][0] == "max_errors"
    step = pbd_faults.card_step(pbd_turns.load(pbd_turns.other_source(
        sys_, pbd_faults.planted_path(fault))))
    got = pp.fields(*step(sys_, qp, act))
    r = pp.rounding_rule(sys_, qp, act, got, torch.Generator(device=cuda).manual_seed(7))
    assert not r["passes"], (fault, len(r["outliers"]), r["errs"])


def _counted(run):
    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, (fused_mlp.chain_fwd.launches, fused_mlp.chain_bwd.launches,
                 kernels.pbd_step_launch.launches)


# a small recipe: 64 envs, 2 unrolls of 5 steps, 4 minibatches, 1 update
SMALL_RECIPE = dict(num_timesteps=320, episode_length=10, num_envs=64, batch_size=32,
                    num_minibatches=4, unroll_length=5, num_updates_per_batch=1, num_evals=1,
                    num_eval_envs=8, normalize_observations=True, seed=0)


def test_mappo_and_diayn_launch_exactly(cuda):
    """MAPPO on the 2-agent ant chase: per agent a policy chain an env step,
    three chains forward and two backward a minibatch; DIAYN on v1 ant:
    PPO's launches, and the discriminator's loss forward and backward and
    its relabel forward once a training step; the physics once an env step
    (the eval's 10 steps included); finite losses."""
    from brax_torch.braxlines import discriminators, train as bl_train
    from brax_torch.composer import envs as composer_envs
    from brax_torch.composer.training import mappo

    chase = lambda b, d: composer_envs.create_ma_env(
        task="chase", episode_length=None, batch_size=b, auto_reset=False, device=d).unwrapped
    (_, _, metrics), got = _counted(lambda: mappo.train(chase, device=cuda, **SMALL_RECIPE))
    rollout, sgd, evals = 10, 4, 10
    assert got == (2 * (rollout + 3 * sgd + evals), 2 * 2 * sgd, rollout + evals)
    assert math.isfinite(metrics["training/total_loss"])
    disc = discriminators.SkillDiscriminator(obs_indices=(13, 14), obs_scale=10.0, z_size=2,
                                             dist_q="categorical", dist_p="categorical")
    (_, params, metrics), got = _counted(lambda: bl_train.train_vgcrl(
        "ant", disc, device=cuda, use_fused_kernel=True, **SMALL_RECIPE))
    assert got == (rollout + 3 * sgd + 2 + evals, 2 * sgd + 1, rollout + evals)
    assert len(params) == 3 and math.isfinite(metrics["training/total_loss"])


@pytest.mark.parametrize("name", ["ant", "halfcheetah", "grasp", "fetch", "ant_spring",
                                  "ant_on_ball"])
def test_one_warp_scenes_compile_as_without_the_wide_route(cuda, name):
    """A one-warp scene's kernel holds none of the wide route: its SASS
    equals that of a build whose source has every PBD_WIDE block cut out
    (the shuffles kept); the parent's bits and speed are held by
    `python -m brax_torch.tools.pbd_turns`."""
    from brax_torch import envs
    from brax_torch.composer import envs as composer_envs

    if name == "ant_spring":
        sys_ = envs.create("ant", batch_size=1, legacy_spring=True).sys
    elif name == "ant_on_ball":
        sys_ = composer_envs.create_env(name, batch_size=1).sys
    else:
        sys_ = envs.create(name, batch_size=1).sys
    assert not kernels.plan(sys_).wide
    whole = kernels.kernel_source(sys_)
    cut = whole.with_name(whole.stem + "_without_wide.cu")
    cut.write_text(_without_blocks(whole.read_text(), ("PBD_WIDE",)))
    assert "#ifdef PBD_WIDE" in whole.read_text() and "#ifdef PBD_WIDE" not in cut.read_text()
    assert _sass(whole) == _sass(cut) != []


# ---------------------------------------------------------------------------
# the generalized kernel's chain entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [33, 4096])
def test_chain_equals_chained_gen_step_bit_for_bit(cuda, n):
    """Three chained steps of the chain (one launch each, no transposes)
    against three chained gen_step calls (the batch-first route) and
    gen_step_plain calls: every output the same bits."""
    sys, (q, qd, minv, act) = _gen_state(cuda, n)
    soa = lambda x: x.reshape(n, -1).t().contiguous()
    step_t, schema = gen_kernels.build_tiled_chain_fn(sys, 5, n)
    carry, state, plain = (soa(q), soa(qd), soa(minv)), [q, qd, minv], [q, qd, minv]
    for _ in range(3):
        before = gen_kernels.gen_step_soa.launches
        carry, outs = step_t(carry, soa(act))
        assert gen_kernels.gen_step_soa.launches == before + 1
        out = gen_kernels.gen_step(sys, *state, act, 5)
        ref = gen_kernels.gen_step_plain(sys, *plain, act, 5)
        state, plain = [out["q"], out["qd"], out["minv"]], [ref["q"], ref["qd"], ref["minv"]]
        assert [k for k, _ in schema] == list(outs)
        for k in outs:
            assert torch.equal(outs[k], soa(out[k])) and torch.equal(outs[k], soa(ref[k])), k


def test_chain_replays_from_a_cuda_graph(cuda):
    """Three chained steps captured in one CUDA graph and replayed: the same
    bits as the host-issued chain."""
    n = 512
    sys, (q, qd, minv, act) = _gen_state(cuda, n)
    soa = lambda x: x.reshape(n, -1).t().contiguous()
    step_t, _ = gen_kernels.build_tiled_chain_fn(sys, 5, n)
    carry0, act_t = (soa(q), soa(qd), soa(minv)), soa(act)

    def chain():
        c = carry0
        for _ in range(3):
            c, _ = step_t(c, act_t)
        return c

    want = chain()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = chain()
    got[0].fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(want, got))


def test_chain_raises_on_unsupported_system_and_mixed_inputs(cuda):
    sys, (q, qd, minv, act) = _gen_state(cuda, 32, steps=0)
    other = dataclasses.replace(sys, actuator_types="p" * 8)
    with pytest.raises(NotImplementedError, match="actuator types"):
        gen_kernels.build_tiled_chain_fn(other, 1, 32)
    step_t, _ = gen_kernels.build_tiled_chain_fn(sys, 1, 32)
    soa = lambda x: x.reshape(32, -1).t().contiguous()
    with pytest.raises(ValueError, match="one CUDA device"):
        step_t((soa(q), soa(qd), soa(minv)), soa(act).cpu())


BIGGYM_SCENES = ("race_proant_ant", "chase_proant_ant", "sumo_proant_ant",
                 "match_race_ma__ant_ant__proant_ant", "match_sumo__ant_ant__proant_ant",
                 "match_onigokko_prey__proant_ant__ant_ant")


@pytest.fixture(scope="module")
def biggym_states():
    """{scene: (env, {state: (qp, act)})} of biggym's new Systems at 4096 envs
    (pbd_parity.biggym_states, seed 0), their kernels and one-pass kernels
    built together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    from brax_torch.tools import pbd_parity as pp

    assert pp.BIGGYM_SCENES == BIGGYM_SCENES
    envs_ = {name: pp.biggym_env(name, 4096, "cuda") for name in BIGGYM_SCENES}
    cuda_build.build(*(kernels.kernel_source(s) for e in envs_.values()
                       for s in (e.sys, pp.one_pass(e.sys))))
    return {name: (e, pp.biggym_states(e, 4096, 0, "cuda")) for name, e in envs_.items()}


@pytest.mark.parametrize("name", BIGGYM_SCENES)
def test_biggym_kernel_matches_twin_by_its_rules(cuda, biggym_states, name):
    """Each new biggym System (one warp for race_proant_ant's 18 contact
    points, the wide route past it: 64 lanes for the pro-ant chase, 128 for
    73 and 117 contact points) against the twin at 4096 envs from a reset
    and 10 twin steps after it, over one pass and the whole step, by the
    rule pbd_parity.RULES names (chip_smoke.py's check); two launches a
    state."""
    from brax_torch.tools import pbd_parity as pp

    env, states = biggym_states[name]
    p = kernels.plan(env.sys)
    assert p.lanes == {"race_proant_ant": 32, "chase_proant_ant": 64}.get(name, 128)
    assert p.wide == (p.lanes > 32)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for state, (qp, act) in states.items():
        before = kernels.pbd_step_launch.launches
        pp.hold_capcap(name, state, env.sys, qp, act, gen, f"{name} {state} ")
        assert kernels.pbd_step_launch.launches == before + 2


def test_biggym_env_step_launches_the_kernel_once(cuda):
    """Every biggym scene through biggym.create at 64 envs: one PBD launch a
    step, finite observations and rewards, a (64, 2) reward on the
    two-agent and match scenes."""
    from brax_torch.tools import pbd_parity as pp

    biggym = pp.biggym_registry()
    assert len(biggym.ENVS) == 12
    for scene in biggym.ENVS:
        env = biggym.create(scene, batch_size=64, device=cuda)
        state = env.reset(torch.Generator(device=cuda).manual_seed(0))
        before = kernels.pbd_step_launch.launches
        for _ in range(3):
            state = env.step(state, torch.rand((64, env.action_size), device=cuda) * 2 - 1)
        assert kernels.pbd_step_launch.launches == before + 3, scene
        two = scene.startswith(("match_", "chase_", "sumo_"))
        assert state.reward.shape == ((64, 2) if two else (64,)), scene
        assert bool(torch.isfinite(state.obs).all()) and bool(torch.isfinite(state.reward).all())


def test_es_and_ars_launch_exactly(cuda):
    """ES (4 members, 8 envs) and ARS (4 directions, 8 envs) on v1 ant,
    episodes of 10 steps: two epochs (num_timesteps one past an epoch's
    steps) and one eval of 8 envs, one PBD launch an env step and no fused
    MLP launch; finite scores; the params moved."""
    from brax_torch.training.agents.ars import train as ars
    from brax_torch.training.agents.es import train as es

    small = dict(episode_length=10, num_eval_envs=8, seed=0, device=cuda)
    (_, params, metrics), got = _counted(lambda: es.train(
        "ant", num_timesteps=81, population_size=4, **small))
    assert got == (0, 0, 30)
    assert math.isfinite(metrics["training/eval_scores_mean"])
    assert all(bool(torch.isfinite(v).all()) for v in params[1].values())
    (_, params, metrics), got = _counted(lambda: ars.train(
        "ant", num_timesteps=81, number_of_directions=4, top_directions=2, **small))
    assert got == (0, 0, 30)
    assert math.isfinite(metrics["training/eval_scores_mean"])
    assert bool((params[1] != 0).any()) and bool(torch.isfinite(params[1]).all())


def test_model_file_round_trip_from_the_card(cuda, tmp_path):
    """io.model saves tensors of the card as CPU tensors: the file loads
    where there is no card, with the same values."""
    from brax_torch.io import model
    from brax_torch.training import running_statistics

    norm = running_statistics.init_state((5,), device=cuda)
    params = (norm, {"hidden_0.kernel": torch.randn((5, 3), device=cuda, requires_grad=True)})
    path = str(tmp_path / "params.pkl")
    model.save_params(path, params)
    loaded = model.load_params(path)
    kernel = loaded[1]["hidden_0.kernel"]
    assert kernel.device.type == "cpu" and loaded[0].mean.device.type == "cpu"
    assert torch.equal(kernel, params[1]["hidden_0.kernel"].detach().cpu())
    back = model.to_device(loaded, cuda)
    assert back[0].std.device.type == "cuda" and torch.equal(back[0].std, norm.std)


def test_learner_cli_ppo_on_v1_ant(cuda, tmp_path):
    """`python -m brax_torch.training.learner` at 64 envs on the card: one
    training step of 2 unrolls of 5 steps, 4 minibatches, and 2 evals of
    128 envs x 10 steps, a rollout of up to 10 steps at batch 1; exact PBD
    and fused launches; the params file, page, npy and event file."""
    from brax_torch.io import metrics, model, npy_file
    from brax_torch.training import learner

    argv = ["--env", "ant", "--learner", "ppo", "--num_envs", "64", "--batch_size", "32",
            "--num_minibatches", "4", "--unroll_length", "5", "--num_updates_per_batch", "1",
            "--total_env_steps", "640", "--num_evals", "2", "--episode_length", "10",
            "--num_trajectories_npy", "1", "--logdir", str(tmp_path)]
    (out, got) = _counted(lambda: learner.main(argv))
    rollout = out["rollout_steps"][0]
    # (fwd, bwd, pbd): 10 rollout steps + 3 x 4 minibatch forwards, 2 x 4
    # backwards, 2 evals of 10 steps, the rollout's steps
    assert got == (10 + 12 + 20 + rollout, 8, 10 + 20 + rollout)
    normalizer, policy = model.load_params(out["params"])
    assert policy["hidden_0.kernel"].device.type == "cpu" and float(normalizer.count) == 640
    assert npy_file.load(out["trajectories"][0])["pos"].shape == (rollout, 10, 3)
    assert "const system" in open(out["videos"][0]).read()
    evals = {s for tag, s, _ in metrics.read_scalars(out["events"]) if tag.startswith("eval/")}
    assert evals == {0, 640}
