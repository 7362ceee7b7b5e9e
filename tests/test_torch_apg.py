"""brax_torch's APG trainer against the JAX package's, on the CPU.

The policy (32x4 swish, NormalTanh) is carried over from flax params with
`networks.load_flax_params` and the normaliser with
`RunningStatisticsState.from_numpy`.  With the deterministic policy (the
mode), the gradient of -mean(reward) over a 4-step rollout from a shared
state (`apg.rollout_loss`, the trainer's own loss) is held for every
policy parameter to `jax.grad` of the JAX trainer's loss (its scan, with
its `stop_gradient` of the env State where truncation falls), on `fast`
(whose reward is not differentiable in its actions: zero in both) and on
the ant in ground contact, at tests/apg_parity.py's tolerance.  The clip
and Adam step are held to the JAX trainer's clip and `optax.adam`.  The
trainer itself passes tests/test_es_ars_apg.py's learning check on `fast`
(slow, mirrored exactly) and a short one, and runs on v1 and v2 ant.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from brax_tpu.envs import base as jax_base
from brax_tpu.envs import fast as jax_fast
from brax_tpu.training import running_statistics as jax_rs
from brax_tpu.training.agents.apg import networks as jax_apg_networks
from brax_torch import envs
from brax_torch.envs.ant import Ant
from brax_torch.sim import kernels
from brax_torch.training import gradients, networks, running_statistics
from brax_torch.training.agents.apg import networks as apg_networks
from brax_torch.training.agents.apg import train as apg
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels as gen_kernels

from tests import apg_parity as ap
from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

STEPS = 4
SCENES = {"fast": (2, 1), "ant": (87, 8)}  # observation and action widths


@functools.lru_cache(maxsize=None)
def _jax_networks(scene):
    obs, act = SCENES[scene]
    nets = jax_apg_networks.make_apg_networks(obs, act,
                                              preprocess_observations_fn=jax_rs.normalize)
    return nets, nets.policy_network.init(jax.random.PRNGKey(0))


def _normalizer(scene, seed=0):
    """A normaliser state, JAX's and the port's, holding the same numbers."""
    obs = SCENES[scene][0]
    rs = np.random.RandomState(seed)
    count = np.float32(100.0)
    mean = (rs.normal(size=obs) * 0.1).astype(np.float32)
    std = rs.uniform(0.5, 2.0, obs).astype(np.float32)
    var = (std * std * count).astype(np.float32)
    jax_state = jax_rs.RunningStatisticsState(
        count=jnp.asarray(count), mean=jnp.asarray(mean), std=jnp.asarray(std),
        summed_variance=jnp.asarray(var))
    return jax_state, running_statistics.RunningStatisticsState.from_numpy(
        count, mean, std, var, device="cpu")


def _port_policy(scene):
    """(make_policy, policy params) of the port, carried over from flax."""
    obs, act = SCENES[scene]
    nets = apg_networks.make_apg_networks(
        obs, act, preprocess_observations_fn=running_statistics.normalize, device="cpu")
    networks.load_flax_params(nets.policy_network.mlp, _jax_networks(scene)[1])
    return apg_networks.make_inference_fn(nets), dict(nets.policy_network.mlp.named_parameters())


def _start(scene):
    """(port env, port state, JAX env, JAX state): ap.N envs, the ant's
    reset from torch_parity's noise and settled into ground contact by 5
    steps of zero action; fast's reset moved by 5 steps of action 1."""
    if scene == "ant":
        env = Ant(use_contact_forces=True, batch_size=ap.N, device="cpu")
        qpos, qvel = tp.noise(seed=0)
        state = env.reset_from_noise(torch.from_numpy(qpos[:ap.N]),
                                     torch.from_numpy(qvel[:ap.N]))
        act, jax_env = torch.zeros((ap.N, 8)), tp.jax_ant()
    else:
        env = envs._envs["fast"](batch_size=ap.N, device="cpu")
        state = env.reset(torch.Generator().manual_seed(0))
        act, jax_env = torch.ones((ap.N, 1)), jax_fast.Fast()
    with torch.no_grad():
        for _ in range(5):
            state = env.step(state, act)
    num = lambda t: jnp.asarray(t.detach().numpy())
    jax_state = jax_base.State(
        qp=tp.to_jax_qp(state.qp), obs=num(state.obs), reward=num(state.reward),
        done=num(state.done), metrics={k: num(v) for k, v in state.metrics.items()})
    return env, state, jax_env, jax_state


@functools.lru_cache(maxsize=None)
def _jax_loss_grad(scene):
    """(policy params, normaliser, State, stop mask) -> d(loss)/d(params):
    the JAX trainer's loss (brax_tpu/training/agents/apg/train.py:114-139)
    from a given State with the deterministic policy, the env State
    stop_gradient-ed after step i where stop[i]; jitted."""
    nets, _ = _jax_networks(scene)
    make_policy = jax_apg_networks.make_inference_fn(nets)
    env = _start(scene)[2] if scene == "fast" else tp.jax_ant()

    def loss(policy_params, normalizer_params, state, stop):
        policy = make_policy((normalizer_params, policy_params), deterministic=True)

        def env_step(s, i):
            nstate = jax.vmap(env.step)(s, policy(s.obs, jax.random.PRNGKey(0))[0])
            nstate = jax.lax.cond(stop[i], jax.lax.stop_gradient, lambda x: x, nstate)
            return nstate, nstate.reward

        return -jnp.mean(jax.lax.scan(env_step, state, jnp.arange(STEPS))[1])

    return jax.jit(jax.grad(loss))


def _grads_both(scene, truncation_length=None):
    env, state, _, jax_state = _start(scene)
    jax_norm, port_norm = _normalizer(scene)
    make_policy, params = _port_policy(scene)
    loss, obs = apg.rollout_loss(env, state, make_policy((port_norm, params), deterministic=True),
                                 None, STEPS, truncation_length)
    assert obs.shape == (STEPS, ap.N, SCENES[scene][0]) and not obs.requires_grad
    names = list(params)
    got = (torch.autograd.grad(loss, [params[k] for k in names]) if loss.requires_grad
           else [torch.zeros_like(params[k]) for k in names])
    stop = np.array([truncation_length is not None and (i + 1) % truncation_length == 0
                     for i in range(STEPS)])
    with jax.default_matmul_precision("highest"):
        want = _jax_loss_grad(scene)(_jax_networks(scene)[1], jax_norm, jax_state, stop)
    flat = {f"{layer}.{leaf}": np.asarray(v) for layer, d in want["params"].items()
            for leaf, v in d.items()}
    return dict(zip(names, got)), flat


@pytest.mark.parametrize("scene", ["fast", "ant"])
def test_policy_gradient_matches_jax(scene):
    got, want = _grads_both(scene)
    assert sorted(got) == sorted(want)
    ap.assert_grads_close(got, want, f"{scene} ")
    if scene == "ant":
        assert all(float(np.abs(w).max()) > 0 for w in want.values())


def test_truncation_stops_the_gradient_where_jax_does():
    got, want = _grads_both("ant", truncation_length=2)
    ap.assert_grads_close(got, want, "ant, truncation 2 ")
    whole, _ = _grads_both("ant")
    assert any(not torch.allclose(got[k], whole[k]) for k in got)


def test_policy_and_normaliser_carry_over_from_flax():
    """Actions of the deterministic policy and their gradient w.r.t. the
    observations: normalize passes it, the statistics held constant."""
    nets, jax_params = _jax_networks("ant")
    jax_norm, port_norm = _normalizer("ant")
    obs = np.random.RandomState(2).normal(size=(16, 87)).astype(np.float32)
    make_policy, params = _port_policy("ant")
    t_obs = torch.from_numpy(obs).requires_grad_()
    act = make_policy((port_norm, params), deterministic=True)(t_obs, None)[0]
    d_obs = torch.autograd.grad(act.sum(), t_obs)[0]
    jax_policy = jax_apg_networks.make_inference_fn(nets)((jax_norm, jax_params),
                                                          deterministic=True)
    with jax.default_matmul_precision("highest"):
        want = jax_policy(obs, None)[0]
        want_d = jax.grad(lambda o: jnp.sum(jax_policy(o, None)[0]))(obs)
    np.testing.assert_allclose(act.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(d_obs.numpy(), np.asarray(want_d), rtol=2e-4, atol=2e-5)
    assert not port_norm.mean.requires_grad


def test_clip_and_adam_match_optax():
    """Three steps at gradient norms below, at and above max_gradient_norm."""
    rs = np.random.RandomState(6)
    params = {"a": rs.normal(size=(5, 3)).astype(np.float32),
              "b": rs.normal(size=(7,)).astype(np.float32)}
    base = {k: rs.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    max_norm = float(optax.global_norm(base))
    opt = optax.adam(3e-4)
    jparams, state = params, opt.init(params)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    adam = gradients.adam(list(tparams.values()), 3e-4)
    for scale in (0.5, 1.0, 2.0):
        g = {k: v * np.float32(scale) for k, v in base.items()}
        g_norm = optax.global_norm(g)
        jg = jax.tree_util.tree_map(
            lambda t: jnp.where(g_norm < max_norm, t, (t / g_norm) * max_norm), g)
        updates, state = opt.update(jg, state)
        jparams = optax.apply_updates(jparams, updates)
        tg = apg.clip_by_global_norm({k: torch.tensor(v) for k, v in g.items()}, max_norm)
        for k in params:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-7)
            tparams[k].grad = tg[k]
        adam.step()
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-6)


@pytest.mark.slow
def test_apg_learns_fast_env():
    """tests/test_es_ars_apg.py::test_apg_learns_fast_env, as written."""
    _, _, metrics = apg.train("fast", episode_length=128, num_envs=64, num_evals=200,
                              learning_rate=3e-3, normalize_observations=True, seed=1,
                              device="cpu")
    assert metrics["eval/episode_reward"] > 50


def test_apg_short_learning_check():
    """The check above over 9 epochs, seeds 0-2 (measured on the CPU:
    70.7, 72.5 and 80.2; the gate 50, as above)."""
    for seed in (0, 1, 2):
        _, _, metrics = apg.train("fast", episode_length=128, num_envs=64, num_evals=10,
                                  learning_rate=3e-3, normalize_observations=True, seed=seed,
                                  device="cpu")
        assert metrics["eval/episode_reward"] > 50, (seed, metrics["eval/episode_reward"])


def test_train_runs_on_v1_and_v2_ant():
    """One epoch each: finite nonzero gradients, moved parameters, one
    backward of the physics per step whose reward keeps its gradient
    (v1: 8 steps truncated every 4, so 6; v2: 4 steps, 4)."""
    v2_ant = lambda batch_size, device: v2_envs.get_environment("ant", batch_size=batch_size,
                                                                device=device)
    for environment, steps, truncation, fn, want_calls in (
            ("ant", 8, 4, kernels.PBDStep, 6), (v2_ant, 4, None, gen_kernels.GenStep, 4)):
        initial = {}

        def factory(*args, **kwargs):
            nets = apg_networks.make_apg_networks(*args, **kwargs)
            init = nets.policy_network.init
            nets.policy_network.init = lambda gen: initial.update(
                {k: v.detach().clone() for k, v in init(gen).items()}) or dict(
                nets.policy_network.mlp.named_parameters())
            return nets

        calls = fn.backward_calls
        _, (_, params), metrics = apg.train(
            environment, episode_length=steps, num_envs=ap.N, num_eval_envs=ap.N, num_evals=2,
            learning_rate=5e-4, normalize_observations=True, truncation_length=truncation,
            network_factory=factory, device="cpu")
        assert fn.backward_calls - calls == want_calls
        assert np.isfinite(metrics["training/grad_norm"]) and metrics["training/grad_norm"] > 0
        assert np.isfinite(metrics["eval/episode_reward"])
        assert all(float((params[k] - v).abs().max()) > 0 for k, v in initial.items())
