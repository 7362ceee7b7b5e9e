"""brax_torch's PPO stack against the JAX package's, on the CPU.

Networks, distribution, normaliser, GAE, the PPO loss and its gradients,
and one Adam step are fed the same numpy inputs (from seeds) and, where
there are weights, the same JAX-initialised parameters through
`load_flax_params`.  f32 paths are held to tests/test_fused_mlp.py's
tolerances (2e-5 forward, rtol 2e-4 / atol 2e-5 for gradients); the fused
(bf16) route to BF16_REL of the largest value, as in
tests/test_torch_fused_mlp.py.  The trainer itself is held to the JAX
package's learning gate on `fast` (tests/test_ppo.py).
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from brax_tpu import envs as jax_envs
from brax_tpu.braxlines import defaults as jax_defaults
from brax_tpu.training import distribution as jax_distribution
from brax_tpu.training import fused_mlp as jax_fused
from brax_tpu.training import running_statistics as jax_rs
from brax_tpu.training.agents.ppo import losses as jax_losses
from brax_tpu.training.agents.ppo import networks as jax_ppo_networks
from brax_torch import envs
from brax_torch.braxlines import defaults
from brax_torch.envs import wrappers
from brax_torch.training import (acting, distribution, fused_mlp, gradients, networks,
                                 running_statistics, types)
from brax_torch.training.agents.ppo import losses
from brax_torch.training.agents.ppo import networks as ppo_networks
from brax_torch.training.agents.ppo import train as ppo

from tests.torch_parity import one_torch_thread  # noqa: F401

OBS, ACT = 87, 8
BF16_REL = 1e-2
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _jax_networks():
    """The JAX ant PPO networks (normalising), and their params from key 0."""
    nets = jax_ppo_networks.make_ppo_networks(
        OBS, ACT, preprocess_observations_fn=jax_rs.normalize)
    key_p, key_v = jax.random.split(jax.random.PRNGKey(0))
    return nets, nets.policy_network.init(key_p), nets.value_network.init(key_v)


def _port_networks():
    nets = ppo_networks.make_ppo_networks(
        OBS, ACT, preprocess_observations_fn=running_statistics.normalize, device="cpu")
    _, jp, jv = _jax_networks()
    networks.load_flax_params(nets.policy_network.mlp, jp)
    networks.load_flax_params(nets.value_network.mlp, jv)
    params = losses.PPONetworkParams(policy=dict(nets.policy_network.mlp.named_parameters()),
                                     value=dict(nets.value_network.mlp.named_parameters()))
    return nets, params


def _normalizer(seed=0):
    rs = np.random.RandomState(seed)
    count = np.float32(100.0)
    mean = (rs.normal(size=OBS) * 0.1).astype(np.float32)
    std = rs.uniform(0.5, 2.0, OBS).astype(np.float32)
    var = (std * std * count).astype(np.float32)
    jax_state = jax_rs.RunningStatisticsState(
        count=jnp.asarray(count), mean=jnp.asarray(mean), std=jnp.asarray(std),
        summed_variance=jnp.asarray(var))
    return jax_state, running_statistics.RunningStatisticsState.from_numpy(
        count, mean, std, var, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_apply(fused: bool):
    """(norm, policy params, value params, obs) -> (logits, values), traced
    with the JAX fused_mlp flag set as given."""
    nets, _, _ = _jax_networks()
    fn = jax.jit(lambda n, pp, vp, obs: (nets.policy_network.apply(n, pp, obs),
                                        nets.value_network.apply(n, vp, obs)))
    prev = jax_fused.enabled()
    jax_fused.enable(fused)
    try:
        norm = _normalizer()[0]
        _, jp, jv = _jax_networks()
        fn(norm, jp, jv, jnp.zeros((2, OBS)))  # trace now, under the flag
    finally:
        jax_fused.enable(prev)
    return fn


@pytest.mark.parametrize("fused", [False, True])
def test_policy_and_value_networks_match_jax(fused):
    obs = np.random.RandomState(1).normal(size=(96, OBS)).astype(np.float32)
    jn, tn = _normalizer()
    _, jp, jv = _jax_networks()
    want = _jax_apply(fused)(jn, jp, jv, obs)
    nets, params = _port_networks()
    prev = fused_mlp.enabled()
    fused_mlp.enable(fused)
    try:
        with torch.no_grad():
            got = (nets.policy_network(tn, params.policy, torch.tensor(obs)),
                   nets.value_network(tn, params.value, torch.tensor(obs)))
    finally:
        fused_mlp.enable(prev)
    assert got[0].shape == (96, 2 * ACT) and got[1].shape == (96,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if fused:
            assert np.abs(g.numpy() - w).max() <= BF16_REL * np.abs(w).max()
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)


def test_mlp_routes_through_dense_chain_only_under_the_predicate(monkeypatch):
    calls = []
    real = fused_mlp.dense_chain
    monkeypatch.setattr(fused_mlp, "dense_chain",
                        lambda *a, **k: calls.append(k["activation"]) or real(*a, **k))
    x = torch.randn(4, 6)
    make = lambda **kw: networks.MLP(6, [5, 3], device="cpu", **kw)
    fused_mlp.enable(True)
    try:
        make(activation=torch.nn.functional.silu)(x)
        make(activation=torch.tanh)(x)
        make(activation=torch.nn.functional.silu, activate_final=True)(x)
        make(activation=torch.nn.functional.silu, bias=False)(x)
        make(activation=torch.nn.functional.gelu)(x)
    finally:
        fused_mlp.enable(False)
    make(activation=torch.nn.functional.silu)(x)
    assert calls == ["swish", "tanh"]


def test_mlp_layout_and_lecun_uniform_init():
    mlp = networks.MLP(OBS, [256, 256, 1], device="cpu",
                       generator=torch.Generator().manual_seed(0))
    names = [n for n, _ in mlp.named_parameters()]
    assert names == ["hidden_0.kernel", "hidden_0.bias", "hidden_1.kernel", "hidden_1.bias",
                     "hidden_2.kernel", "hidden_2.bias"]
    for layer, fan_in in zip(mlp.layers(), (OBS, 256, 256)):
        k = layer.kernel.detach()
        limit = (3.0 / fan_in) ** 0.5
        assert k.shape[0] == fan_in
        assert float(k.abs().max()) <= limit
        if k.numel() > 1000:
            assert float(k.abs().max()) > 0.98 * limit
            assert abs(float(k.mean())) < 0.05 * limit
            # uniform on [-l, l]: variance l^2 / 3
            assert abs(float(k.var()) / (limit * limit / 3) - 1) < 0.05
        assert torch.equal(layer.bias, torch.zeros_like(layer.bias))


def test_load_flax_params_is_a_straight_copy():
    _, jp, _ = _jax_networks()
    nets, _ = _port_networks()
    for i, layer in enumerate(nets.policy_network.mlp.layers()):
        np.testing.assert_array_equal(layer.kernel.detach().numpy(),
                                      np.asarray(jp["params"][f"hidden_{i}"]["kernel"]))
        np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                      np.asarray(jp["params"][f"hidden_{i}"]["bias"]))


def test_distribution_matches_jax_on_shared_noise():
    rs = np.random.RandomState(2)
    logits = rs.normal(size=(32, 2 * ACT)).astype(np.float32)
    raw = rs.normal(size=(32, ACT)).astype(np.float32)
    jd = jax_distribution.NormalTanhDistribution(ACT)
    td = distribution.NormalTanhDistribution(ACT)
    t = torch.tensor
    close = lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    close(td.log_prob(t(logits), t(raw)), jd.log_prob(logits, raw))
    close(td.mode(t(logits)), jd.mode(logits))
    close(td.postprocess(t(raw)), jd.postprocess(raw))
    # the port's draws, handed to the JAX formulas
    seed = 7
    noise = torch.randn((32, ACT), generator=torch.Generator().manual_seed(seed)).numpy()
    jdist = jd.create_dist(logits)
    sample = noise * np.asarray(jdist.scale) + np.asarray(jdist.loc)
    close(td.sample_no_postprocessing(t(logits), torch.Generator().manual_seed(seed)), sample)
    want_entropy = jnp.sum(jdist.entropy()
                           + jax_distribution.TanhBijector().forward_log_det_jacobian(sample),
                           axis=-1)
    close(td.entropy(t(logits), torch.Generator().manual_seed(seed)), want_entropy)


def test_normalizer_update_and_normalize_match_jax():
    rs = np.random.RandomState(3)
    batches = [rs.normal(2.0, 3.0, size=(4, 3, 6)).astype(np.float32) for _ in range(2)]
    weights = rs.uniform(0, 1, (4, 3)).astype(np.float32)
    jstate = jax_rs.init_state(jax_rs.ArraySpec((6,), jnp.float32))
    tstate = running_statistics.init_state((6,), device="cpu")
    for b in batches:
        jstate = jax_rs.update(jstate, b)
        tstate = running_statistics.update(tstate, torch.tensor(b))
    jstate = jax_rs.update(jstate, batches[0], weights=weights)
    tstate = running_statistics.update(tstate, torch.tensor(batches[0]),
                                       weights=torch.tensor(weights))
    for name in ("count", "mean", "std", "summed_variance"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        running_statistics.normalize(torch.tensor(batches[1]), tstate).numpy(),
        np.asarray(jax_rs.normalize(batches[1], jstate)), rtol=1e-5, atol=1e-5)


def _gae_inputs(t=7, b=11, seed=4):
    rs = np.random.RandomState(seed)
    f = lambda x: x.astype(np.float32)
    truncation = f(rs.uniform(size=(t, b)) < 0.1)
    termination = f((rs.uniform(size=(t, b)) < 0.15) * (1 - truncation))
    return (truncation, termination, f(rs.normal(size=(t, b))), f(rs.normal(size=(t, b))),
            f(rs.normal(size=(b,))))


def test_compute_gae_matches_jax():
    inputs = _gae_inputs()
    kw = dict(lambda_=0.95, discount=0.97)
    want = jax.jit(functools.partial(jax_losses.compute_gae, **kw))(*inputs)
    values = torch.tensor(inputs[3], requires_grad=True)
    tin = [torch.tensor(x) for x in inputs]
    got = losses.compute_gae(tin[0], tin[1], tin[2], values, tin[4], **kw)
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _ppo_batch(nets, params, normalizer, b=16, t=5, seed=5):
    """A [B, T] Transition (numpy) whose behaviour log-probs are near the
    policy's own, so that the clipped surrogate sees ratios on both sides."""
    rs = np.random.RandomState(seed)
    f = lambda x: np.asarray(x, dtype=np.float32)
    obs = f(rs.normal(size=(b, t, OBS)))
    raw = f(rs.normal(size=(b, t, ACT)))
    with torch.no_grad():
        logits = nets.policy_network(normalizer, params.policy, torch.tensor(obs))
        log_prob = nets.parametric_action_distribution.log_prob(logits, torch.tensor(raw))
    done = f(rs.uniform(size=(b, t)) < 0.1)
    return types.Transition(
        observation=obs, action=np.tanh(raw), reward=f(rs.normal(size=(b, t))),
        discount=1 - done, next_observation=f(rs.normal(size=(b, t, OBS))),
        extras={"policy_extras": {"log_prob": f(log_prob.numpy() + rs.normal(size=(b, t)) * 0.3),
                                  "raw_action": raw},
                "state_extras": {"truncation": f(done * (rs.uniform(size=(b, t)) < 0.5))}})


def test_ppo_loss_and_grads_match_jax():
    loss_kw = dict(entropy_cost=0.0, discounting=0.97, reward_scaling=10.0, gae_lambda=0.95,
                   clipping_epsilon=0.3, normalize_advantage=True)
    jn, tn = _normalizer()
    nets, params = _port_networks()
    data = _ppo_batch(nets, params, tn)
    jnets, jp, jv = _jax_networks()

    def jax_loss(p):
        return jax_losses.compute_ppo_loss(p, jn, data, jax.random.PRNGKey(0),
                                           ppo_network=jnets, **loss_kw)

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax_losses.PPONetworkParams(policy=jp, value=jv))
    tdata = types.tree_map(torch.tensor, data)
    loss, metrics = losses.compute_ppo_loss(params, tn, tdata, torch.Generator().manual_seed(0),
                                            ppo_network=nets, **loss_kw)
    loss.backward()
    for name in ("total_loss", "policy_loss", "v_loss", "entropy_loss"):
        np.testing.assert_allclose(float(metrics[name].detach()), float(jmetrics[name]),
                                   rtol=2e-5, atol=2e-5, err_msg=name)
    for side, tparams, jg in (("policy", params.policy, jgrads.policy),
                              ("value", params.value, jgrads.value)):
        for name, p in tparams.items():
            layer, leaf = name.split(".")
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg["params"][layer][leaf]),
                                       err_msg=f"{side} {name}", **GRAD_TOL)


def test_adam_step_matches_optax():
    rs = np.random.RandomState(6)
    params = {"a": rs.normal(size=(5, 3)).astype(np.float32),
              "b": rs.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rs.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    opt = optax.adam(3e-4)
    jparams, state = params, opt.init(params)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    # loss = sum(p * G) has gradient G
    step = gradients.gradient_update_fn(
        lambda p, g: sum((p[k] * g[k]).sum() for k in p),
        gradients.adam(list(tparams.values()), 3e-4))
    for g in grads:
        updates, state = opt.update(g, state)
        jparams = optax.apply_updates(jparams, updates)
        step(tparams, {k: torch.tensor(v) for k, v in g.items()})
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-6)


def test_fast_env_matches_jax():
    n, steps = 6, 5
    acts = np.random.RandomState(7).uniform(-1, 1, (steps, n, 1)).astype(np.float32)
    jenv = jax_envs._envs["fast"]()
    jstep = jax.jit(jax.vmap(jenv.step))
    jstate = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), n))
    env = envs.create("fast", episode_length=None, auto_reset=False, batch_size=n, device="cpu")
    state = env.reset(torch.Generator().manual_seed(0))
    for a in acts:
        jstate = jstep(jstate, a)
        state = env.step(state, torch.tensor(a))
        np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state.reward.numpy(), np.asarray(jstate.reward),
                                   rtol=1e-6, atol=1e-7)
    assert env.observation_size == 2 and env.action_size == 1


def test_ppo_presets_are_a_copy():
    assert defaults.DEFAULT_PPO_PARAMS == jax_defaults.DEFAULT_PPO_PARAMS
    assert defaults.get_ppo_params("ant", num_timesteps=5) == jax_defaults.get_ppo_params(
        "ant", num_timesteps=5)


def test_wrap_for_training_and_evaluator_on_fast():
    """The v1 training stack, and an Evaluator episode of a constant +1
    policy: reward sum_{t=1..128} 0.02^2 t (t + 1) / 2 = 143.104."""
    env = wrappers.wrap_for_training(envs.Fast(batch_size=4, device="cpu"), episode_length=128)
    layers = []
    while isinstance(env, wrappers.base.Wrapper):
        layers.append(type(env).__name__)
        env = env.env
    assert layers == ["AutoResetWrapper", "VmapWrapper", "EpisodeWrapper"]
    eval_env = wrappers.wrap_for_training(envs.Fast(batch_size=4, device="cpu"),
                                          episode_length=128)
    policy = lambda obs, gen: (torch.ones((obs.shape[0], 1)), {})
    evaluator = acting.Evaluator(eval_env, lambda params: policy, num_eval_envs=4,
                                 episode_length=128, action_repeat=1,
                                 generator=torch.Generator().manual_seed(0))
    metrics = evaluator.run_evaluation(None, {"training/x": 1.0})
    assert metrics["eval/episode_reward"] == pytest.approx(143.104, rel=1e-5)
    assert metrics["eval/avg_episode_length"] == 128 and metrics["training/x"] == 1.0


def test_generate_unroll_stacks_time_first():
    env = wrappers.wrap_for_training(envs.Fast(batch_size=3, device="cpu"), episode_length=4)
    state = env.reset(torch.Generator().manual_seed(0))
    policy = lambda obs, gen: (torch.rand((obs.shape[0], 1), generator=gen) * 2 - 1,
                               {"raw_action": torch.zeros((obs.shape[0], 1))})
    state, data = acting.generate_unroll(env, state, policy, torch.Generator().manual_seed(1),
                                         unroll_length=6, extra_fields=("truncation",))
    assert data.observation.shape == (6, 3, 2) and data.reward.shape == (6, 3)
    assert data.extras["policy_extras"]["raw_action"].shape == (6, 3, 1)
    # episodes of 4 steps: truncated at step 4, then auto-reset, so that the
    # next observation is always the next step's observation
    np.testing.assert_array_equal(data.extras["state_extras"]["truncation"][:, 0].numpy(),
                                  [0, 0, 0, 1, 0, 0])
    torch.testing.assert_close(data.next_observation[:-1], data.observation[1:], rtol=0, atol=0)


def _train_fast(seed, **kw):
    args = dict(num_timesteps=2**15, episode_length=128, num_envs=64, learning_rate=3e-4,
                entropy_cost=1e-2, discounting=0.95, unroll_length=5, batch_size=64,
                num_minibatches=8, num_updates_per_batch=4, num_evals=3, reward_scaling=10.0,
                normalize_observations=True, seed=seed, device="cpu")
    args.update(kw)
    return ppo.train("fast", **args)


def test_ppo_learns_fast_env():
    """tests/test_ppo.py's gate at its hyperparameters, median over seeds 0-2."""
    rewards = [_train_fast(seed)[2]["eval/episode_reward"] for seed in (0, 1, 2)]
    assert np.median(rewards) > 135, rewards


def test_ppo_params_roundtrip_and_fused_flag():
    seen = []
    fused_mlp.enable(False)
    make_policy, params, metrics = _train_fast(
        0, num_timesteps=128, num_envs=8, unroll_length=4, batch_size=8, num_minibatches=2,
        num_updates_per_batch=1, num_evals=1, use_fused_kernel=True,
        progress_fn=lambda step, m: seen.append(fused_mlp.enabled()))
    assert seen == [True] and not fused_mlp.enabled()
    assert np.isfinite(metrics["training/total_loss"])
    params2 = pickle.loads(pickle.dumps(params))
    obs = torch.zeros((1, 2))
    act1, _ = make_policy(params, deterministic=True)(obs, None)
    act2, _ = make_policy(params2, deterministic=True)(obs, None)
    torch.testing.assert_close(act1, act2, rtol=0, atol=0)
