"""Shared JAX references for the APG gradient tests, on the CPU.

The port's gradients through a v1 env step (the physics in
`brax_torch.sim.kernels.PBDStep`) are held to `jax.grad` through the JAX
env's step, whose physics is the jnp step (`jax.vmap(system._raw_step)`,
the JAX package's `_with_vjp` backward).  The JAX side is traced under
`jax.default_matmul_precision("highest")`: the jnp v1 path runs at JAX's
default matmul precision, bf16 on this build (docs/production.md:185-197),
which would put a bf16 floor under every comparison.  Each JAX function is
jitted once per process (the lru_caches below).

Tolerance: every entry of each gradient within GRAD_RTOL of that
gradient's largest |entry| in JAX, and finite wherever JAX's is.  Set from
the JAX gradient's own spread (`python -m tests.apg_parity` prints it): 4
copies of each test's inputs under 1e-7 relative noise move each gradient
by at most 1.0e-5 (ant, 2 steps), 6.3e-4 (grasp's d/d(action)), 1.6e-5
(spring ant) and 1.6e-4 (the v2 step's VJP, fresh State) of its largest
entry; 1e-3 is about 1.6x the largest.  fetch's gradient is not smooth
there (its box corners touch the ground: 1e-7 of noise moves its rot
gradient by 0.49 of its largest entry), and the bound is no looser for it.
"""

import functools

import numpy as np
import torch

from brax_torch import envs
from brax_torch.envs.ant import Ant
from brax_torch.sim.types import QP

from tests import torch_parity as tp

N = 4
GRAD_RTOL = 1e-3
PBD_INPUTS = ("act", "pos", "rot", "vel", "ang")
# the v1 scenes held to jax.grad over one step, each (env name, its kwargs),
# settled by SETTLE_STEPS steps of zero action; the uniform draws each
# env's step takes for a new target (they touch no gradient)
SCENES = {"grasp": ("grasp", {}), "fetch": ("fetch", {}),
          "ant_spring": ("ant", {"legacy_spring": True})}
SETTLE_STEPS = 3
TARGET_DRAWS = {"grasp": 3, "fetch": 2}
# the ant's states: torch_parity's reset noise settled into ground contact
ANT_SETTLE_STEPS = 5
# the v2 ant's frames per env step (brax_tpu/v2/envs/ant.py:32) and the
# kernel-route steps that make a stale State
V2_FRAMES = 5
V2_STALE_STEPS = 3


def assert_grads_close(got, want, label=""):
    """got, want: {name: array-like} of the same shapes (a None in got:
    zeros).  Every entry within GRAD_RTOL of max|want|, finite wherever
    want is."""
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        g = np.zeros_like(w) if g is None else np.asarray(
            g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g)
        finite = np.isfinite(w)
        assert np.isfinite(g[finite]).all(), f"{label}{k}: non-finite where JAX's is finite"
        if not finite.any():
            continue
        tol = GRAD_RTOL * np.abs(w[finite]).max()
        err = np.abs(g - w)[finite].max()
        assert err <= tol, f"{label}{k}: max|port - jax| {err:.3e} > {tol:.3e}"


def port_reward_grads(step, state, action, steps=1):
    """{input: gradient} of sum(reward) after `steps` calls of `step`
    (state, action) -> state from `state`, the action held, w.r.t. the
    action and the state's qp."""
    ins = [t.detach().clone().requires_grad_()
           for t in (action, state.qp.pos, state.qp.rot, state.qp.vel, state.qp.ang)]
    s = state.replace(qp=QP(*ins[1:]))
    for _ in range(steps):
        s = step(s, ins[0])
    grads = torch.autograd.grad(s.reward.sum(), ins, allow_unused=True)
    return dict(zip(PBD_INPUTS, grads))


def to_jax_state(state, keys=None):
    """A JAX env State holding a port env State's numbers (its info: the
    per-env rng keys where given)."""
    import jax.numpy as jnp
    from brax_tpu.envs import base as jax_base

    num = lambda t: jnp.asarray(t.detach().cpu().numpy())
    return jax_base.State(qp=tp.to_jax_qp(state.qp), obs=num(state.obs),
                          reward=num(state.reward), done=num(state.done),
                          metrics={k: num(v) for k, v in state.metrics.items()},
                          info={} if keys is None else {"rng": keys})


@functools.lru_cache(maxsize=None)
def jax_reward_grad_fn(env, steps):
    """(act, pos, rot, vel, ang, state) -> their gradients of sum(reward)
    after `steps` steps of the JAX env (jax.vmap of env.step), the action
    held; jitted."""
    import jax
    import jax.numpy as jnp
    from brax_tpu.sim.types import QP as JaxQP

    def reward(a, pos, rot, vel, ang, s):
        s = s.replace(qp=JaxQP(pos, rot, vel, ang))
        s = jax.lax.scan(lambda c, _: (env.step(c, a), None), s, None, length=steps)[0]
        return s.reward

    def total(*args):
        return jnp.sum(jax.vmap(reward)(*args))

    return jax.jit(jax.grad(total, argnums=(0, 1, 2, 3, 4)))


def jax_reward_grads(env, state, action, steps=1, keys=None):
    """{input: gradient} of `jax_reward_grad_fn` on a port state and action,
    traced and run at the highest matmul precision."""
    import jax

    qp = [x.detach().cpu().numpy() for x in (state.qp.pos, state.qp.rot, state.qp.vel,
                                            state.qp.ang)]
    with jax.default_matmul_precision("highest"):
        grads = jax_reward_grad_fn(env, steps)(np.asarray(action), *qp,
                                               to_jax_state(state, keys))
    return dict(zip(PBD_INPUTS, (np.asarray(g) for g in grads)))


def settled_ant(legacy_spring=False):
    """(env, state, action): N ants from torch_parity's reset noise, settled
    into ground contact by ANT_SETTLE_STEPS steps of zero action, and an
    action in [-0.5, 0.5]."""
    env = Ant(use_contact_forces=True, legacy_spring=legacy_spring, batch_size=N, device="cpu")
    qpos, qvel = tp.noise(seed=0)
    state = env.reset_from_noise(torch.from_numpy(qpos[:N]), torch.from_numpy(qvel[:N]))
    with torch.no_grad():
        for _ in range(ANT_SETTLE_STEPS):
            state = env.step(state, torch.zeros((N, 8)))
    act = np.random.RandomState(1).uniform(-0.5, 0.5, (N, 8)).astype(np.float32)
    return env, state, torch.from_numpy(act)


def scene_inputs(scene):
    """(port step, settled state, action, the JAX env, its rng keys or
    None) of one of SCENES: reset, SETTLE_STEPS steps of zero action, then
    the zero action (the spring ant: one in [-0.3, 0.3])."""
    import jax
    from brax_tpu import envs as jax_envs

    name, kwargs = SCENES[scene]
    env = envs._envs[name](batch_size=N, device="cpu", **kwargs)
    if name in TARGET_DRAWS:
        draws = torch.zeros((N, TARGET_DRAWS[name]))
        step = lambda s, a: env.step_from_draws(s, a, draws)
    else:
        step = env.step
    state = env.reset(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for _ in range(SETTLE_STEPS):
            state = step(state, torch.zeros((N, env.action_size)))
    if name == "ant":
        act = np.random.RandomState(1).uniform(-0.3, 0.3, (N, 8)).astype(np.float32)
    else:
        act = np.zeros((N, env.action_size), np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), N) if "rng" in state.info else None
    return step, state, act, jax_envs._envs[name](**kwargs), keys


def v2_scene():
    """The v2 ant System, its inputs (torch_parity.v2_inputs, N envs), a
    random cotangent on every float leaf of its State, and the fresh
    (`pipeline.init`), stale (V2_STALE_STEPS kernel-route steps on: the
    CoM terms, Jacobian and smooth forces still the reset's, as the JAX
    kernel route leaves them) and refreshed (that State's caches recomputed
    from its q and qd) States."""
    from brax_torch.tools import grad_parity as gp
    from brax_torch.v2 import mjcf
    from brax_torch.v2.envs import assets
    from brax_torch.v2.generalized import kernels as gen_kernels
    from brax_torch.v2.generalized import pipeline

    sys_ = mjcf.loads(assets.ant_xml(), device="cpu")
    q, qd, act = (torch.from_numpy(x[:N].copy()) for x in tp.v2_inputs())
    fresh = pipeline.init(sys_, q, qd)
    stale = fresh
    with torch.no_grad():
        for _ in range(V2_STALE_STEPS):
            stale = gen_kernels.gen_step_state(sys_, stale, act, V2_FRAMES)
        refreshed = pipeline._refresh(sys_, stale, stale.q, stale.qd, approximate=True)
    return {"sys": sys_, "act": act, "ws": gp.weights(gen_kernels.float_leaves(fresh)),
            "fresh": fresh, "stale": stale, "refreshed": refreshed}


@functools.lru_cache(maxsize=None)
def _jax_v2_vjp():
    """(State, act, cotangent State) -> (State, act) cotangents of the JAX
    package's jnp_path (brax_tpu/v2/generalized/kernels.py:1323-1331,
    `_with_vjp`'s backward) over V2_FRAMES frames, vmapped and jitted."""
    import jax
    from brax_tpu.v2.generalized import pipeline as jax_pipeline

    sys_ = tp.jax_v2_ant().sys

    def jnp_path(state, act):
        return jax.vmap(lambda s, a: jax.lax.scan(
            lambda c, _: (jax_pipeline.step(sys_, c, a), None), s, (), V2_FRAMES)[0])(state, act)

    return jax.jit(lambda s, a, ct: jax.vjp(jnp_path, s, a)[1](ct))


def jax_v2_vjp(scene, floats):
    """[act, *float leaves] cotangents of jnp_path at the State whose float
    leaves are `floats` (torch tensors, in field order), for the scene's
    cotangent on its output State."""
    import jax
    import jax.numpy as jnp

    template = tp.jax_v2_init()(floats[0].numpy(), floats[1].numpy())
    leaves, treedef = jax.tree_util.tree_flatten(template)
    is_float = [jnp.issubdtype(l.dtype, jnp.floating) for l in leaves]

    def tree(values, other):
        it = iter(values)
        return jax.tree_util.tree_unflatten(treedef, [
            next(it) if f else other(l) for f, l in zip(is_float, leaves)])

    numpy = lambda ts: [t.detach().numpy() for t in ts]
    ct = tree(numpy(scene["ws"]), lambda l: np.zeros(l.shape, jax.dtypes.float0))
    with jax.default_matmul_precision("highest"):
        d_state, d_act = _jax_v2_vjp()(tree(numpy(floats), lambda l: l),
                                       scene["act"].numpy(), ct)
    return [np.asarray(d_act)] + [np.asarray(l) for l in jax.tree_util.tree_leaves(d_state)
                                  if l.dtype != jax.dtypes.float0]


def _relative_spread(base, copies):
    """Per input, the farthest a copy lands from `base`, over base's
    largest |entry|."""
    return [max(float(np.abs(c - b).max()) for c in cs) / max(float(np.abs(b).max()), 1e-30)
            for b, cs in zip(base, zip(*copies))]


def main(copies=4, noise=1e-7):
    """Prints the JAX gradient's own spread under `noise` relative input
    noise, per test input: what GRAD_RTOL is set from."""
    from brax_torch.v2.generalized import kernels as gen_kernels

    noisy = lambda x, rs: (x * (1 + noise * rs.randn(*x.shape))).astype(np.float32)
    cases = {"ant, 2 steps": settled_ant() + (2, tp.jax_ant(), None)}
    for scene in SCENES:
        step, state, act, jax_env, keys = scene_inputs(scene)
        cases[scene] = (None, state, torch.from_numpy(act), 1, jax_env, keys)
    for label, (_, state, act, steps, jax_env, keys) in cases.items():
        base = jax_reward_grads(jax_env, state, act.numpy(), steps, keys)
        runs = []
        for k in range(copies):
            rs = np.random.RandomState(10 + k)
            qp = QP(*(torch.from_numpy(noisy(t.numpy(), rs)) for t in (
                state.qp.pos, state.qp.rot, state.qp.vel, state.qp.ang)))
            runs.append(list(jax_reward_grads(jax_env, state.replace(qp=qp),
                                              noisy(act.numpy(), rs), steps, keys).values()))
        print(label, dict(zip(PBD_INPUTS, _relative_spread(list(base.values()), runs))))
    scene = v2_scene()
    for label in ("fresh", "stale"):
        floats = gen_kernels.float_leaves(scene[label])
        base = jax_v2_vjp(scene, floats)
        runs = []
        for k in range(copies):
            rs = np.random.RandomState(20 + k)
            runs.append(jax_v2_vjp(scene, [torch.from_numpy(noisy(t.numpy(), rs))
                                           for t in floats]))
        print(f"v2 ant, {label}: largest over the inputs", max(_relative_spread(base, runs)))


if __name__ == "__main__":
    main()
