"""Shared JAX references for the legacy-spring tests: the eight envs whose
`legacy_spring=True` switches to a spring scene (ant, halfcheetah,
humanoid_legacy, humanoidstandup, inverted_pendulum,
inverted_double_pendulum, reacher, reacherangle), on the CPU.

Each JAX function is jitted once per process (the lru_caches below) and
shared by the tests of one scene, which sit together in one of
tests/test_torch_spring_*.py.  Inputs are numpy arrays or port states made
from fixed seeds and handed to both packages.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from brax_tpu import envs as jax_envs
from brax_tpu.sim import kernels as jax_kernels
from brax_tpu.sim import lowering
from brax_tpu.sim import system as jax_system
from brax_torch.sim import kernels
from brax_torch.sim.system import flatten
from brax_torch.sim.types import DP, QP
from brax_torch.tools import pbd_parity as pp

from tests import torch_parity as tp

N = 16
OUTPUTS = ("pos", "rot", "vel", "ang", "contact_vel", "contact_ang")
# tests/test_pallas_kernel.py::test_tile_step_math_spring_mode's bounds on a
# whole spring step (pos 1e-5, vel 1e-3), for each position and velocity field
STEP_BOUNDS = {"pos": 1e-5, "rot": 1e-5, "vel": 1e-3, "ang": 1e-3, "contact_vel": 1e-3,
               "contact_ang": 1e-3}
# tests/test_torch_step.py's one-step tolerances, for one substep of the
# Pallas body against the twin
ONE_STEP = {"pos": 2e-5, "rot": 2e-5, "vel": 5e-4, "ang": 5e-4, "contact_vel": 5e-4,
            "contact_ang": 5e-4}
# tests/test_env_suite_parity.py::PAIRS' horizon and atol per env (ant, not
# in PAIRS, as the contact envs there)
ENV_STEPS = {"ant": (5, 1e-3), "halfcheetah": (5, 1e-3), "humanoid_legacy": (5, 1e-3),
             "humanoidstandup": (5, 1e-3), "inverted_pendulum": (10, 1e-4),
             "inverted_double_pendulum": (10, 1e-4), "reacher": (10, 1e-4),
             "reacherangle": (10, 1e-4)}
# each JAX env's reset noise (uniform in +-scale on the joint angles and
# velocities); the reachers draw their own
RESET_SCALE = {"ant": 0.1, "halfcheetah": 0.1, "humanoid_legacy": 1e-2,
               "humanoidstandup": 1e-2, "inverted_pendulum": 0.01}


@functools.lru_cache(maxsize=None)
def jax_env(name):
    return jax_envs._envs[name](legacy_spring=True)


@functools.lru_cache(maxsize=None)
def port_env(name, n=N):
    return pp.spring_env(name, n, "cpu")


def assert_same_system(name):
    """The port's spring System of `name` equals the JAX one leaf for leaf."""
    want = flatten(jax_env(name).sys)
    got = flatten(port_env(name).sys)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


@functools.lru_cache(maxsize=None)
def jax_substep(name):
    """(qp, act) -> (qp, info): one substep of the JAX jnp spring step,
    vmapped, traced in the JAX package's kernel mode (its polynomial
    arctan2 is the twin's; see tests/forces_parity.py::jax_raw_step)."""
    sys = jax_env(name).sys.replace(substeps=1)
    return jax.jit(jax.vmap(lambda qp, act: jax_system._raw_step(sys, qp, act)))


def jax_step(name, qp, act):
    """The JAX jnp spring step, `substeps` calls of `jax_substep`, its
    contact impulses summed from the left as `_spring_step`'s scan sums
    them."""
    contact = None
    with lowering.kernel_mode():  # read while the first call traces
        for _ in range(jax_env(name).sys.substeps):
            qp, info = jax_substep(name)(qp, act)
            contact = info.contact if contact is None else contact + info.contact
    return qp, info.replace(contact=contact)


def jax_fields(jqp, jinfo):
    pos, rot, vel, ang = (torch.from_numpy(x.copy()) for x in tp.qp_numpy(jqp))
    return {"pos": pos, "rot": rot, "vel": vel, "ang": ang,
            "contact_vel": torch.from_numpy(np.array(jinfo.contact.vel)),
            "contact_ang": torch.from_numpy(np.array(jinfo.contact.ang))}


def from_jax_qp(jqp):
    return QP.from_numpy(*tp.qp_numpy(jqp), device="cpu")


def actions(name, seed, n=N):
    """(n, action_size) float32 actions uniform in [-1, 1]; reacherangle's
    in degrees, +-300, past its joints' limits."""
    width = port_env(name).action_size
    act = np.random.RandomState(seed).uniform(-1, 1, (n, width)).astype(np.float32)
    return torch.from_numpy(act * 300.0 if name == "reacherangle" else act)


def states(name, seed=0):
    """{"reset": qp, "jiggled": qp}: the port's reset state of `name` (N
    envs; inverted_double_pendulum's, which cannot reset in legacy spring,
    default_qp with both angles 0), and that state with its velocities
    and angular velocities moved by 0.3 x a standard normal draw, as
    tests/test_pallas_kernel.py jiggles its spring scene."""
    env = port_env(name)
    gen = torch.Generator().manual_seed(seed)
    if name == "inverted_double_pendulum":
        zero = torch.zeros((N, 0))
        reset = env.default_qp(joint_angle=zero, joint_velocity=zero)
    else:
        reset = env.reset(gen).qp
    integ = env.sys.integrator
    kick = lambda x, mask: x + 0.3 * torch.randn(x.shape, generator=gen) * mask
    return {"reset": reset, "jiggled": QP(pos=reset.pos, rot=reset.rot,
                                          vel=kick(reset.vel, integ.pos_mask),
                                          ang=kick(reset.ang, integ.rot_mask))}


def assert_twin_matches_jax_step(name):
    """The twin's whole spring step equals the JAX jnp step from a reset and
    from a jiggled state, within STEP_BOUNDS in every env; for the scenes
    whose whole step pbd_parity.RULES holds by the chaos rule from a reset
    (the contact scenes: their contacts sit exactly on the floor there),
    within STEP_BOUNDS or 2x the twin's own spread under 1e-6 input noise
    (`pbd_parity.chaos_rule`; at 16 envs none may stray)."""
    sys = port_env(name).sys
    chaotic = pp.RULES[f"{name}_spring"]["reset"][1] == "chaos_rule"
    for label, qp in states(name).items():
        act = actions(name, 1)
        out, info = kernels.pbd_step_plain(sys, qp, act)
        jax_out = jax_fields(*jax_step(name, tp.to_jax_qp(qp), jnp.asarray(act.numpy())))
        twin = pp.fields(out, info)
        if chaotic:
            _, strays, allowed = pp.chaos_rule(sys, qp, act, jax_out, twin, tol=STEP_BOUNDS)
            assert len(strays) <= allowed, (name, label, strays.tolist())
            continue
        for k in OUTPUTS:
            err = float((twin[k] - jax_out[k]).abs().max())
            assert err <= STEP_BOUNDS[k], (name, label, k, err)


def assert_emulation_matches_twin(name):
    """The generated kernel in the CPU's warp emulation
    (tests/pbd_emulation.py) within pp.TOLERANCE of the twin in every env of
    a ragged batch (a warp's last env copied), over the whole step 10 twin
    steps after a reset (the card holds one substep too, chip_smoke.py)."""
    from tests import pbd_emulation

    lanes = kernels.plan(port_env(name).sys).lanes
    n = 9 if lanes == 32 else 17
    env = pp.spring_env(name, n, "cpu")
    qp, act = pp.spring_states(name, env, n, 0, "cpu")[pp.SPRING_STATES[1]]
    errs = pbd_emulation.max_errors(env.sys, qp, act)
    assert all(errs[k] <= pp.TOLERANCE[k] for k in pp.TOLERANCE), (name, errs)


def pallas_one_substep(name, qp, act):
    """The Pallas kernel body (`_build_tile_step`, run eagerly) over one
    spring substep, on batch-first inputs; its six outputs batch-first."""
    tile_step = jax_kernels._build_tile_step(jax_env(name).sys.replace(substeps=1))
    t = lambda x: jnp.asarray(np.transpose(x.numpy(), (1, 2, 0)))
    outs = tile_step(t(qp.pos), t(qp.rot), t(qp.vel), t(qp.ang), jnp.asarray(act.numpy().T))
    return {k: torch.from_numpy(np.transpose(np.asarray(o), (2, 0, 1)).copy())
            for k, o in zip(OUTPUTS, outs)}


def settled(name, steps=10, seed=0):
    """N envs of `name` `steps` twin steps after its reset state, and one
    more action: away from the reset's contacts exactly on the floor, where
    one substep decides by the last bit whether an impulse applies."""
    sys, qp = port_env(name).sys, states(name, seed)["reset"]
    for s in range(steps):
        qp, _ = kernels.pbd_step_plain(sys, qp, actions(name, 100 + s))
    return qp, actions(name, 99)


@functools.lru_cache(maxsize=None)
def jax_reset(name):
    """keys -> (draws, State): the JAX env's reset and the draws it made, in
    the form the port's reset_from_noise takes."""
    env = jax_env(name)
    nd = env.sys.num_joint_dof

    def draws(key):
        rng, rng1, rng2 = jax.random.split(key, 3)
        if name in ("reacher", "reacherangle"):
            qpos = jax.random.uniform(rng1, (nd,), minval=-0.1, maxval=0.1)
            qvel = jax.random.uniform(rng2, (nd,), minval=-0.005, maxval=0.005)
            _, t1, t2 = jax.random.split(rng, 3)
            return qpos, qvel, jnp.stack([jax.random.uniform(t1), jax.random.uniform(t2)])
        scale = RESET_SCALE[name]
        noise = lambda k: jax.random.uniform(k, (nd,), minval=-scale, maxval=scale)
        return noise(rng1), noise(rng2)

    return jax.jit(jax.vmap(lambda k: (draws(k), env.reset(k))))


@functools.lru_cache(maxsize=None)
def jax_env_parts(name):
    """(before, after) of the JAX env's step, vmapped: the physics action of
    (qp, action) (reacherangle maps the action onto the joint limits), and
    the env's step (state, action, qp, info) -> state with its physics
    result given (`jax_step` computes it)."""
    env = jax_env(name)
    if name == "reacherangle":
        before = jax.jit(jax.vmap(lambda qp, a: env._min_act + env._range_act * ((a + 1) / 2.0)))
    else:
        before = lambda qp, a: a

    def given(state, act, qp, info):
        e = copy.copy(env)
        e.sys = tp._GivenPhysics(env.sys, qp, info)
        return e.step(state, act)

    return before, jax.jit(jax.vmap(given))


# tests/test_env_suite_parity.py::test_env_parity's relative tolerance and
# reward tolerance, beside PAIRS' atol
OBS_RTOL, REWARD_ATOL = 3e-2, 1e-3


def on_the_floor(sys, qp):
    """(N,) envs with a contact whose penetration lies within 1e-6 of 0:
    whether its impulse applies is decided by the last bit of the state."""
    flags = torch.zeros(qp.pos.shape[0], dtype=torch.bool)
    for g in sys.contact_groups:
        c = g.contact(qp.take(g.com.body_a), qp.take(g.com.body_b))
        flags |= (c.penetration.abs() <= 1e-6).flatten(1).any(dim=1)
    return flags


def assert_env_matches_jax(name):
    """The port's env of `name` from the JAX reset's draws, then PAIRS'
    horizon of steps of both envs on the same actions (0.3 x uniform in
    [-1, 1]), each JAX step on `jax_step`'s physics: the reset state and
    observation (its contact impulses may differ only in the envs
    `on_the_floor`, whose reset impulses the last bit decides, and there
    in at most a quarter of the envs), and the observation, reward, done
    and metrics after.  The scenes without contacts step free; the contact scenes,
    chaotic from a reset (`assert_twin_matches_jax_step`), step on the JAX
    physics, so that what is compared is the env's own arithmetic, as
    tests/test_torch_halfcheetah.py holds halfcheetah's."""
    env = port_env(name)
    keys = jax.random.split(jax.random.PRNGKey(11), N)
    draws, jstate = jax_reset(name)(keys)
    state = env.reset_from_noise(*(torch.from_numpy(np.array(d)) for d in draws))
    assert sorted(state.metrics) == sorted(jstate.metrics)
    for got, want in zip(state.qp.numpy(), tp.qp_numpy(jstate.qp)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    off = np.abs(state.obs.numpy() - np.asarray(jstate.obs)).max(axis=1) > 1e-5
    assert not (off & ~on_the_floor(env.sys, state.qp).numpy()).any() and off.sum() <= N // 4

    free = not env.sys.contact_groups
    steps, atol = ENV_STEPS[name]
    acts = 0.3 * np.random.RandomState(5).uniform(-1, 1, (steps, N, env.action_size))
    before, after = jax_env_parts(name)
    for a in acts.astype(np.float32):
        jq, jinfo = jax_step(name, jstate.qp, before(jstate.qp, a))
        stepper = env
        if not free:
            stepper = copy.copy(env)
            contact = DP(torch.from_numpy(np.array(jinfo.contact.vel)),
                         torch.from_numpy(np.array(jinfo.contact.ang)))
            stepper.sys = tp._GivenPhysics(env.sys, from_jax_qp(jq),
                                           kernels._kernel_info(contact, N, "cpu"))
            state = state.replace(qp=from_jax_qp(jstate.qp))
        state = stepper.step(state, torch.from_numpy(a))
        jstate = after(jstate, a, jq, jinfo)
        np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), atol=atol,
                               rtol=OBS_RTOL)
    np.testing.assert_allclose(state.reward.numpy(), np.asarray(jstate.reward),
                               atol=REWARD_ATOL)
    for k in state.metrics:
        np.testing.assert_allclose(state.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                   atol=atol, rtol=OBS_RTOL, err_msg=k)
