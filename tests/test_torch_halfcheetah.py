"""The v1 halfcheetah and pusher paths of brax_torch against the JAX package,
on the CPU.

Covers the two-way capsule-capsule group: the segment-segment closest
points, `builder.build`'s group (halfcheetah's feet, pusher's arm against
the object) leaf for leaf, the two-way contact passes and the reset-time
impulse, the plain-torch step (`pbd_step_plain`) against the JAX jnp step
and, over one pass, against the Pallas kernel's math, the two envs' reset
and 5 steps, and one PPO training step at halfcheetah's widths.

Inputs are made with numpy or seeded torch generators and handed to both
packages; each JAX function is jitted once per process (the lru_caches
below).  halfcheetah's whole step is chaotic (its feet spin at hundreds of
rad/s and contact tests flip on the last bit), so its whole-step
comparisons with the JAX step use `pbd_parity.chaos_rule`: each env held
to the JAX step as closely as the port's twin holds to itself under 1e-6
of input noise, in all but a tenth of the envs.  pusher's, like ant's, are
held env by env.  The kernel is held to the twin by
tests/test_torch_pbd_launch.py (emulated) and tests/test_torch_cuda.py and
chip_smoke.py (on the card).
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.envs import halfcheetah as jax_halfcheetah
from brax_tpu.envs import pusher as jax_pusher
from brax_tpu.envs.assets.half_cheetah import halfcheetah_config as jax_halfcheetah_config
from brax_tpu.envs.assets.pusher import pusher_config as jax_pusher_config
from brax_tpu.sim import builder as jax_builder
from brax_tpu.sim import colliders as jax_colliders
from brax_tpu.sim import geometry as jax_geometry
from brax_tpu.sim import kernels as jax_kernels
from brax_tpu.sim import system as jax_system
from brax_torch import envs
from brax_torch.envs.assets.half_cheetah import halfcheetah_config, halfcheetah_config_spring
from brax_torch.envs.assets.pusher import pusher_config
from brax_torch.envs.halfcheetah import Halfcheetah
from brax_torch.envs.pusher import Pusher
from brax_torch.sim import builder, colliders, geometry, kernels
from brax_torch.sim.system import flatten
from brax_torch.sim.types import QP
from brax_torch.tools.pbd_parity import TOLERANCE, capcap_share, capcap_state, chaos_rule, fields

from tests import torch_parity as tp
from tests.test_torch_sim import _assert_tables_equal
from tests.torch_parity import one_torch_thread  # noqa: F401

NAMES = ("halfcheetah", "pusher")
# envs per batch: halfcheetah's whole-step comparisons are statistical
# (chaos_rule), so it takes more
BATCH = {"halfcheetah": 32, "pusher": 8}
ENVS = {"halfcheetah": (Halfcheetah, jax_halfcheetah.Halfcheetah),
        "pusher": (Pusher, jax_pusher.Pusher)}
CONFIGS = {"halfcheetah": (halfcheetah_config, jax_halfcheetah_config),
           "pusher": (pusher_config, jax_pusher_config)}
OBS = {"halfcheetah": 18, "pusher": 23}
NDOF = {"halfcheetah": 6, "pusher": 7}
# contacts: capsule-plane ones, then the capsule-capsule pairs
CONTACTS = {"halfcheetah": (16, 1), "pusher": (16, 7)}
METRICS = {"halfcheetah": ("x_position", "x_velocity", "reward_ctrl", "reward_run"),
           "pusher": ("reward_dist", "reward_ctrl", "reward_near")}
# tests/test_env_suite_parity.py::PAIRS' halfcheetah and pusher tolerance and horizon
ENV_TOL, ENV_STEPS = 1e-3, 5


@functools.lru_cache(maxsize=None)
def jax_env(name):
    return ENVS[name][1]()


@functools.lru_cache(maxsize=None)
def port_env(name):
    return ENVS[name][0](batch_size=BATCH[name], device="cpu")


@functools.lru_cache(maxsize=None)
def jax_raw_step(name):
    """(qp, act) -> (qp, info): the JAX jnp physics step, vmapped.

    _pbd_step runs its substeps / 2 passes under lax.scan(unroll=True),
    whose jit takes 28 s for halfcheetah's 8 passes and 109 s for pusher's
    25 on this CPU; here one pass (the System with 2 substeps) is jitted
    and run substeps / 2 times, its contact impulses summed from the left
    as the scan's carry sums them."""
    sys = jax_env(name).sys
    one_pass = jax.jit(jax.vmap(
        lambda qp, act: jax_system._raw_step(sys.replace(substeps=2), qp, act)))

    def step(qp, act):
        contact = None
        for _ in range(sys.substeps // 2):
            qp, info = one_pass(qp, act)
            contact = info.contact if contact is None else contact + info.contact
        return qp, info.replace(contact=contact)

    return step


@functools.lru_cache(maxsize=None)
def jax_reset(name):
    """keys -> (draws, State): the JAX env's reset, and the noise it drew,
    for the port's reset_from_noise."""
    env = jax_env(name)
    nd = env.sys.num_joint_dof

    def draws(key):
        rng, rng1, rng2 = jax.random.split(key, 3)
        if name == "halfcheetah":
            noise = lambda k: jax.random.uniform(k, (nd,), minval=-0.1, maxval=0.1)
            return noise(rng1), noise(rng2)
        xy = jnp.concatenate([jax.random.uniform(rng, (1,), minval=-0.3, maxval=0),
                              jax.random.uniform(rng1, (1,), minval=-0.2, maxval=0.2)])
        return xy, jax.random.uniform(rng2, (nd - 4,), minval=-0.005, maxval=0.005)

    return jax.jit(jax.vmap(lambda k: (draws(k), env.reset(k))))


@functools.lru_cache(maxsize=None)
def jax_env_step_given(name):
    """(state, act, qp_next, info) -> state: the JAX env step with its physics
    given (from `jax_raw_step`), so that the physics compiles once."""
    def step(state, act, qp, info):
        env = copy.copy(jax_env(name))
        env.sys = tp._GivenPhysics(env.sys, qp, info)
        return env.step(state, act)

    return jax.jit(jax.vmap(step))


def keys(name, seed):
    return jax.random.split(jax.random.PRNGKey(seed), BATCH[name])


def actions(name, seed, steps=1):
    shape = (steps, BATCH[name], NDOF[name])
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def reset_qp(name, seed=0):
    """The port's reset QP (its parity with the JAX reset is
    test_env_matches_jax's)."""
    return port_env(name).reset(torch.Generator().manual_seed(seed)).qp


def contact_qp(name, seed=0):
    """States whose two-way capsule-capsule pairs overlap, and actions."""
    env = port_env(name)
    qp, act = capcap_state(name, env, BATCH[name], seed=seed, device="cpu")
    assert capcap_share(env.sys, qp) > 0.75
    return qp, act.numpy()


def assert_step_close(name, sys, qp, act, got, want, tol):
    """pusher: every env within `tol`; halfcheetah: chaos_rule."""
    if name == "halfcheetah":
        report, strays, allowed = chaos_rule(sys, qp, torch.from_numpy(act), got, want, tol)
        assert len(strays) <= allowed, (strays, report)
        return
    for k in tol:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=tol[k], err_msg=k)


def jax_fields(jqp, jinfo):
    pos, rot, vel, ang = (torch.from_numpy(x.copy()) for x in tp.qp_numpy(jqp))
    return {"pos": pos, "rot": rot, "vel": vel, "ang": ang,
            "contact_vel": torch.from_numpy(np.array(jinfo.contact.vel)),
            "contact_ang": torch.from_numpy(np.array(jinfo.contact.ang))}


# ---------------------------------------------------------------------------
# the scene build and the narrowphase
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_build_matches_jax(name):
    """The port's System equals the JAX build leaf by leaf: a one-way
    capsule-plane group and a two-way capsule-capsule group."""
    sys, art = builder.build(CONFIGS[name][0](), device="cpu")
    jax_sys, _ = jax_builder.build(CONFIGS[name][1]())
    _assert_tables_equal(flatten(sys), flatten(jax_sys))
    plane, capcap = sys.contact_groups
    assert isinstance(plane, colliders.CapsulePlane) and plane.com.one_way
    assert isinstance(capcap, colliders.CapsuleCapsule) and not capcap.com.one_way
    assert (plane.end.shape[0] * plane.end.shape[1], len(capcap.com.body_a)) == CONTACTS[name]
    assert sys.num_contacts == sum(CONTACTS[name]) and art.action_size == NDOF[name]
    assert kernels.unsupported_features(sys) == []


def test_legacy_spring_still_raises():
    """halfcheetah's legacy-spring scene is ported: the builder makes the
    JAX package's System leaf for leaf (six spring revolute joints, damped
    by 0.5 sqrt(stiffness), the one-way capsule-plane and two-way
    capsule-capsule groups), the CUDA kernel covers it and the env switches
    to it; what still raises is its capsule-plane group made two-way."""
    from brax_tpu.envs.assets.half_cheetah import (
        halfcheetah_config_spring as jax_halfcheetah_config_spring)

    sys, _ = builder.build(halfcheetah_config_spring(), device="cpu")
    _assert_tables_equal(flatten(sys), flatten(jax_builder.build(
        jax_halfcheetah_config_spring())[0]))
    assert kernels.unsupported_features(sys) == []
    assert Halfcheetah(legacy_spring=True, device="cpu").sys.dynamics_mode == "legacy_spring"
    plane = sys.contact_groups[0]
    two_way = dataclasses.replace(plane, com=dataclasses.replace(plane.com, one_way=False))
    other = dataclasses.replace(sys, contact_groups=(two_way,) + sys.contact_groups[1:])
    assert kernels.unsupported_features(other) == ["two-way CapsulePlane contacts"]


def _segments():
    """(a0, a1, b0, b1), (k, 3) float32 each: random segments, then parallel,
    collinear, a point against a segment, and two points."""
    rs = np.random.RandomState(0)
    a0, a1, b0, b1 = (rs.randn(256, 3) for _ in range(4))
    d = rs.randn(32, 3)
    par_a0, par_b0 = rs.randn(32, 3), rs.randn(32, 3)
    parallel = (par_a0, par_a0 + d, par_b0, par_b0 + 0.5 * d)
    col_a0 = rs.randn(32, 3)
    collinear = (col_a0, col_a0 + d, col_a0 + 0.5 * d, col_a0 + 2 * d)
    point = rs.randn(32, 3)
    point_seg = (point, point, par_b0, par_b0 + d)
    points = (point, point, par_b0, par_b0)
    parts = [(a0, a1, b0, b1), parallel, collinear, point_seg, points]
    return tuple(np.concatenate([p[i] for p in parts]).astype(np.float32) for i in range(4))


def test_closest_segment_points_match_jax():
    """closest_segment_to_segment_points against brax_tpu.sim.geometry's on
    384 segment pairs: the points of the 256 random pairs and of a point
    against a segment and two points (zero-length segments), at float32
    rounding of O(1) coordinates (1e-5); for the parallel and collinear
    pairs, whose closest points are not unique (rounding picks them along
    the overlap), the distance between them."""
    segs = _segments()
    best_a, best_b = geometry.closest_segment_to_segment_points(
        *(torch.from_numpy(s) for s in segs))
    jbest_a, jbest_b = (np.asarray(x) for x in
                        jax.jit(jax_geometry.closest_segment_to_segment_points)(*segs))
    assert np.isfinite(best_a.numpy()).all() and np.isfinite(best_b.numpy()).all()
    unique = np.r_[0:256, 320:384]
    np.testing.assert_allclose(best_a.numpy()[unique], jbest_a[unique], atol=1e-5)
    np.testing.assert_allclose(best_b.numpy()[unique], jbest_b[unique], atol=1e-5)
    dist = np.linalg.norm((best_a - best_b).numpy(), axis=-1)
    np.testing.assert_allclose(dist, np.linalg.norm(jbest_a - jbest_b, axis=-1), atol=1e-5)
    p, d2 = geometry.closest_segment_point_and_dist(*(torch.from_numpy(s) for s in segs[1:]))
    jp, jd2 = jax.jit(jax_geometry.closest_segment_point_and_dist)(*segs[1:])
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# the two-way passes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_passes(name):
    sys = jax_env(name).sys
    g, nb, solver = sys.contact_groups[1], sys.num_bodies, sys.solver

    def passes(qp, qp_prev):
        dq, dlambda, contact = jax_colliders.position_apply(g, qp, qp_prev, solver, nb)
        dp = jax_colliders.velocity_apply(g, qp, dlambda, qp_prev, contact, solver, nb)
        return dq, dlambda, contact, dp, jax_colliders.spring_apply(g, qp, solver, nb)[0]

    return jax.jit(jax.vmap(passes))


@pytest.mark.parametrize("name", NAMES)
def test_two_way_passes_match_jax(name):
    """The capsule-capsule group's position pass (contact, dlambda, the
    per-body update of both bodies), velocity pass and reset-time impulse
    against the JAX package's, from states whose pairs overlap (the
    previous substep: positions a tenth of a substep of velocity back).
    Contact points and depths at float32 rounding (1e-5).  The normal to
    1e-3: where a segment's closest point to the other's is equally near
    from both ends of the search (pusher's object is a sphere, a segment of
    length 0), the d1 < d2 select takes either of two candidates that
    differ by the 1e-6 regularizer of the point-segment projection, on
    rounding, and the normal turns by that over the distance (2e-4 here).
    The updates and impulses, which carry the normal, to 1e-3 of each
    one's largest value."""
    sys = port_env(name).sys
    qp, _ = contact_qp(name)
    h = sys.solver.h
    prev = QP(pos=qp.pos - 0.1 * h * qp.vel, rot=qp.rot, vel=0.9 * qp.vel, ang=0.9 * qp.ang)
    g, nb = sys.contact_groups[1], sys.num_bodies
    dq, dlambda, contact = colliders.position_apply(g, qp, prev, sys.solver, nb)
    dp = colliders.velocity_apply(g, qp, dlambda, prev, contact, sys.solver, nb)
    spring, _ = colliders.spring_apply(g, qp, sys.solver, nb)
    jdq, jdlambda, jcontact, jdp, jspring = _jax_passes(name)(tp.to_jax_qp(qp),
                                                            tp.to_jax_qp(prev))
    assert (contact.penetration > 0).any(dim=(1, 2)).float().mean() > 0.75
    np.testing.assert_allclose(contact.pos.numpy(), np.asarray(jcontact.pos), atol=1e-5)
    np.testing.assert_allclose(contact.penetration.numpy(), np.asarray(jcontact.penetration),
                               atol=1e-5)
    np.testing.assert_allclose(contact.normal.numpy(), np.asarray(jcontact.normal), atol=1e-3)
    for got, want in ((dq.pos, jdq.pos), (dq.rot, jdq.rot), (dlambda, jdlambda),
                      (dp.vel, jdp.vel), (dp.ang, jdp.ang), (spring.vel, jspring.vel),
                      (spring.ang, jspring.ang)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())
    # both bodies of an overlapping pair move; body b's velocity changes
    # where the pair closes or slides (restitution, friction)
    b = int(g.com.body_b[0])
    assert (dq.pos[:, b].abs().amax(dim=1) > 0).float().mean() > 0.75
    assert (dp.vel[:, b].abs().amax(dim=1) > 0).float().mean() > 0.25


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state", ["reset", "contact"])
@pytest.mark.parametrize("name", NAMES)
def test_twin_step_matches_jnp_path(name, state):
    """pbd_step_plain against jax.vmap(_raw_step): from a reset, and from
    states whose capsule-capsule pairs overlap, at TOLERANCE
    (tests/test_torch_step.py's in-contact tolerances): pusher 8 envs env
    by env, halfcheetah 32 envs by chaos_rule.  From a reset too: pusher's
    25 passes amplify float32 rounding so that its twin moves by up to 6e-4
    rad/s in the wrist's angular velocity (~2.8 rad/s) from 1e-7 of input
    noise, past the 5e-4 that test_torch_step.py holds ant's 5 passes to
    from a reset."""
    if state == "reset":
        qp, act = reset_qp(name), actions(name, seed=1)[0]
    else:
        qp, act = contact_qp(name)
    sys = port_env(name).sys
    out, info = kernels.pbd_step_plain(sys, qp, torch.from_numpy(act))
    jout, jinfo = jax_raw_step(name)(tp.to_jax_qp(qp), act)
    want = jax_fields(jout, jinfo)
    if state == "contact":
        # the overlapping pair's body b (the object, a foot) gets an impulse
        b = int(sys.contact_groups[1].com.body_b[0])
        assert (want["contact_vel"][:, b].abs().amax(dim=1) > 0).float().mean() > 0.25
    assert_step_close(name, sys, qp, act, fields(out, info), want, TOLERANCE)


def test_twin_matches_pallas_kernel_math():
    """pbd_step_plain against _build_tile_step (the Pallas kernel's body,
    run eagerly: jitting it costs minutes of CPU compile), halfcheetah from
    a reset and with its feet together, 32 envs each, over one pass (the
    System with 2 substeps: a pass is what the kernel's loop repeats, and
    one keeps the eager run short and the chaos small), at TOLERANCE env by
    env."""
    sys = dataclasses.replace(port_env("halfcheetah").sys, substeps=2)
    tile_step = jax_kernels._build_tile_step(jax_env("halfcheetah").sys.replace(substeps=2))
    t = lambda x: jnp.asarray(np.transpose(x.numpy(), (1, 2, 0)))
    reset, feet = reset_qp("halfcheetah", seed=2), contact_qp("halfcheetah", seed=1)
    qp = QP(*(torch.cat([getattr(reset, f), getattr(feet[0], f)])
              for f in ("pos", "rot", "vel", "ang")))
    act = np.concatenate([actions("halfcheetah", seed=2)[0], feet[1]])
    out, info = kernels.pbd_step_plain(sys, qp, torch.from_numpy(act))
    outs = tile_step(t(qp.pos), t(qp.rot), t(qp.vel), t(qp.ang), jnp.asarray(act.T))
    got = fields(out, info)
    for k, o in zip(TOLERANCE, outs):
        want = np.transpose(np.asarray(o), (2, 0, 1))
        np.testing.assert_allclose(got[k].numpy(), want, atol=TOLERANCE[k], err_msg=k)


# ---------------------------------------------------------------------------
# the envs
# ---------------------------------------------------------------------------


def _to_jax_state(name, state):
    from brax_tpu.envs import base as jax_base

    num = lambda t: jnp.asarray(t.detach().cpu().numpy())
    return jax_base.State(qp=tp.to_jax_qp(state.qp), obs=num(state.obs), reward=num(state.reward),
                          done=num(state.done),
                          metrics={k: num(state.metrics[k]) for k in METRICS[name]})


@pytest.mark.slow  # the JAX reset's jit: 5-6 s per env on this CPU, the file's budget is ~30 s
@pytest.mark.parametrize("name", NAMES)
def test_env_reset_matches_jax(name):
    """The port's reset_from_noise of the JAX reset's draws: qp, obs,
    reward, done and metrics of the JAX env's reset."""
    env = port_env(name)
    (draw_a, draw_b), jstate = jax_reset(name)(keys(name, 0))
    state = env.reset_from_noise(torch.from_numpy(np.array(draw_a)),
                                 torch.from_numpy(np.array(draw_b)))
    assert state.obs.shape == (BATCH[name], OBS[name])
    assert sorted(state.metrics) == sorted(METRICS[name])
    for got, want in zip(state.qp.numpy(), tp.qp_numpy(jstate.qp)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=1e-5)
    for got, want in [(state.reward, jstate.reward), (state.done, jstate.done)] + [
            (state.metrics[k], jstate.metrics[k]) for k in METRICS[name]]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_env_steps_match_jax(name):
    """5 steps, each from the JAX env's state loaded into the port (the
    port's reset to start): position, obs, reward, done and metrics at
    tests/test_env_suite_parity.py's tolerance.  pusher steps its own
    physics; halfcheetah, whose step is chaotic
    (test_twin_step_matches_jnp_path holds it), steps the JAX physics, so
    that what is compared is the env's own arithmetic."""
    env = port_env(name)
    state = env.reset(torch.Generator().manual_seed(0))
    jstate = _to_jax_state(name, state)
    for a in actions(name, seed=6, steps=ENV_STEPS):
        shared = state.replace(qp=QP.from_numpy(*tp.qp_numpy(jstate.qp), device="cpu"))
        jq, jinfo = jax_raw_step(name)(jstate.qp, a)
        stepper = env
        if name == "halfcheetah":
            stepper = copy.copy(env)
            stepper.sys = tp._GivenPhysics(env.sys, QP.from_numpy(*tp.qp_numpy(jq), device="cpu"),
                                           None)
        state = stepper.step(shared, torch.from_numpy(a))
        jstate = jax_env_step_given(name)(jstate, a, jq, jinfo)
        np.testing.assert_allclose(state.qp.pos.numpy(), np.asarray(jstate.qp.pos), atol=1e-4)
        np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=ENV_TOL)
        np.testing.assert_allclose(state.reward.numpy(), np.asarray(jstate.reward),
                                   atol=ENV_TOL, rtol=ENV_TOL)
        np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))
        for k in METRICS[name]:
            np.testing.assert_allclose(state.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                       atol=ENV_TOL, rtol=ENV_TOL, err_msg=k)


def test_create_registers_halfcheetah_and_pusher():
    """envs.create builds each env on the CPU at its batch (obs 18 and 23,
    actions 6 and 7); the CPU step runs the twin and launches nothing."""
    for name in NAMES:
        env = envs.create(name, batch_size=2, episode_length=4, device="cpu")
        assert env.observation_size == OBS[name] and env.action_size == NDOF[name]
        state = env.reset(torch.Generator().manual_seed(0))
        before = kernels.pbd_step_launch.launches
        state = env.step(state, torch.zeros((2, NDOF[name])))
        assert kernels.pbd_step_launch.launches == before
        assert state.obs.shape == (2, OBS[name]) and bool(torch.isfinite(state.obs).all())


# ---------------------------------------------------------------------------
# PPO at halfcheetah's widths
# ---------------------------------------------------------------------------


def test_ppo_trains_halfcheetah_for_one_step():
    from brax_torch.training.agents.ppo import train as ppo

    _, params, metrics = ppo.train(
        "halfcheetah", num_timesteps=32, episode_length=4, num_envs=4, num_eval_envs=2,
        unroll_length=2, batch_size=4, num_minibatches=4, num_updates_per_batch=1,
        num_evals=1, normalize_observations=True, reward_scaling=1.0, discounting=0.95,
        seed=0, device="cpu")
    for key in ("training/total_loss", "training/policy_loss", "training/v_loss",
                "eval/episode_reward"):
        assert np.isfinite(metrics[key]), key
    assert params[1]["hidden_0.kernel"].shape == (OBS["halfcheetah"], 32)
    assert params[1]["hidden_4.kernel"].shape == (32, 2 * NDOF["halfcheetah"])
