"""brax_torch's SAC networks against the JAX package's, on the CPU.

`networks.make_q_network` (twin critics over the concatenated observation
and action) and the SAC policy are fed the same numpy inputs and the same
JAX-initialised parameters.  Two modes:

- fused off: both plain f32; values and gradients (with respect to the
  critics' params and the action) within rtol 1e-5 (atol 1e-6 of the
  largest entry, for the entries that cancel to near 0);
- fused on: the JAX package's Pallas op in interpret mode (as
  tests/test_fused_mlp.py runs it on the CPU) against the port's plain
  bf16 version, held to tests/test_torch_fused_mlp.py's rule (BF16_REL of
  the largest value) and, for the gradients, the relu kink rule: both
  sides round the same values to bf16, so an activation may round to a
  neighbouring bf16 number and move the next layer's pre-activation by up
  to ~1e-3; the gradients are held on the rows whose pre-activations all
  lie further than KINK from 0, where relu' cannot flip.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from brax_tpu.training import fused_mlp as jax_fused
from brax_torch.training import fused_mlp, networks, running_statistics
from brax_torch.training.agents.sac import networks as sac_networks

from tests import sac_parity as sp
from tests.torch_parity import one_torch_thread  # noqa: F401

BF16_REL = 1e-2
KINK = 1e-3
ROWS = 96


def _inputs(obs_size, action_size, rows=ROWS, seed=3):
    rs = np.random.RandomState(seed)
    obs = rs.normal(size=(rows, obs_size)).astype(np.float32)
    act = rs.uniform(-1, 1, (rows, action_size)).astype(np.float32)
    g = rs.normal(size=(rows, 2)).astype(np.float32) / rows
    return obs, act, g


@functools.lru_cache(maxsize=None)
def _jax_q_vjp(obs_size, action_size, fused):
    """(norm, q params, obs, act, g) -> (q, dq params, d act), each call
    (and so each trace, at any row count) under the JAX fused_mlp flag as
    given."""
    nets = sp.jax_networks(obs_size, action_size)[0]

    def f(norm, q, obs, act, g):
        y, vjp = jax.vjp(lambda q, a: nets.q_network.apply(norm, q, obs, a), q, act)
        return (y,) + vjp(g)

    jitted = jax.jit(f)

    def fn(*args):
        prev = jax_fused.enabled()
        jax_fused.enable(fused)
        try:
            return jitted(*args)
        finally:
            jax_fused.enable(prev)

    return fn


def _port_q_vjp(obs_size, action_size, fused, obs, act, g):
    nets, _, q = sp.port_networks_from_jax(obs_size, action_size)
    tn = sp.normalizer(obs_size)[1]
    ta = torch.tensor(act, requires_grad=True)
    with fused_mlp.enabled_as(fused):
        y = nets.q_network(tn, q, torch.tensor(obs), ta)
        grads = torch.autograd.grad(y, [ta, *q.values()], torch.tensor(g))
    return y.detach().numpy(), grads[0].numpy(), dict(zip(q, (t.numpy() for t in grads[1:])))


def _clear_rows(obs_size, action_size, obs, act):
    """Rows whose f32 pre-activations (both critics, every hidden layer)
    all lie further than KINK from 0."""
    nets, _, q = sp.port_networks_from_jax(obs_size, action_size)
    x = torch.cat([running_statistics.normalize(torch.tensor(obs),
                                                sp.normalizer(obs_size)[1]),
                   torch.tensor(act)], dim=-1)
    clear = torch.ones(x.shape[0], dtype=torch.bool)
    with torch.no_grad():
        for c in range(nets.q_network.module.n_critics):
            h = x
            for i in range(2):
                z = h @ q[f"MLP_{c}.hidden_{i}.kernel"] + q[f"MLP_{c}.hidden_{i}.bias"]
                clear &= z.abs().amin(dim=1) > KINK
                h = torch.relu(z)
    return clear.numpy()


@pytest.mark.parametrize("env", sorted(sp.SHAPES))
def test_q_network_matches_jax_f32(env):
    obs_size, action_size = sp.SHAPES[env]
    obs, act, g = _inputs(obs_size, action_size)
    norm, (_, _, jq) = sp.normalizer(obs_size)[0], sp.jax_networks(obs_size, action_size)
    want_y, want_dq, want_da = _jax_q_vjp(obs_size, action_size, False)(norm, jq, obs, act, g)
    y, da, dq = _port_q_vjp(obs_size, action_size, False, obs, act, g)
    assert y.shape == (ROWS, 2)
    close = lambda got, want, msg: np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=msg)
    close(y, want_y, "q")
    close(da, want_da, "d action")
    for name, got in dq.items():
        close(got, sp.flax_leaf(want_dq, name), name)


@pytest.mark.parametrize("env", sorted(sp.SHAPES))
def test_q_network_fused_route_matches_jax_pallas(env):
    obs_size, action_size = sp.SHAPES[env]
    obs, act, g = _inputs(obs_size, action_size)
    norm, (_, _, jq) = sp.normalizer(obs_size)[0], sp.jax_networks(obs_size, action_size)
    jax_fn = _jax_q_vjp(obs_size, action_size, True)
    bf16_close = lambda got, want, msg: np.testing.assert_array_less(
        np.abs(got - np.asarray(want)).max(), BF16_REL * np.abs(np.asarray(want)).max() + 1e-30,
        err_msg=msg)
    want_y = jax_fn(norm, jq, obs, act, g)[0]
    calls = []
    real = fused_mlp.dense_chain
    fused_mlp.dense_chain = lambda *a, **k: calls.append(a[0].shape) or real(*a, **k)
    try:
        y = _port_q_vjp(obs_size, action_size, True, obs, act, g)[0]
    finally:
        fused_mlp.dense_chain = real
    # one chain per critic over the obs and action together
    assert calls == [(ROWS, obs_size + action_size)] * 2
    bf16_close(y, want_y, "q (every row)")
    clear = _clear_rows(obs_size, action_size, obs, act)
    assert clear.sum() >= ROWS // 4, clear.sum()
    obs, act, g = obs[clear], act[clear], g[clear]
    _, want_dq, want_da = jax_fn(norm, jq, obs, act, g)
    _, da, dq = _port_q_vjp(obs_size, action_size, True, obs, act, g)
    bf16_close(da, want_da, "d action")
    for name, got in dq.items():
        bf16_close(got, sp.flax_leaf(want_dq, name), name)


def test_load_flax_params_carries_the_q_form():
    obs_size, action_size = sp.SHAPES["humanoid"]
    _, _, jq = sp.jax_networks(obs_size, action_size)
    _, _, q = sp.port_networks_from_jax(obs_size, action_size)
    assert sorted(q) == sorted(f"MLP_{c}.hidden_{i}.{leaf}" for c in range(2) for i in range(3)
                               for leaf in ("kernel", "bias"))
    for name, t in q.items():
        np.testing.assert_array_equal(t.detach().numpy(), sp.flax_leaf(jq, name))
    one = networks.make_q_network(obs_size, action_size, n_critics=1, device="cpu")
    with pytest.raises(ValueError, match="critics"):
        networks.load_flax_params(one.module, jq)


def test_q_network_init_and_shapes():
    net = networks.make_q_network(18, 6, hidden_layer_sizes=(32, 32), device="cpu")
    params = net.init(torch.Generator().manual_seed(0))
    assert params["MLP_0.hidden_0.kernel"].shape == (24, 32)
    assert params["MLP_1.hidden_2.kernel"].shape == (32, 1)
    for name, t in params.items():
        if name.endswith("bias"):
            assert not t.detach().any()
        else:
            limit = (3.0 / t.shape[0]) ** 0.5
            top = float(t.detach().abs().max())
            assert 0.5 * limit < top <= limit
    assert not torch.equal(params["MLP_0.hidden_0.kernel"], params["MLP_1.hidden_0.kernel"])
    q = net(None, params, torch.zeros((5, 3, 18)), torch.zeros((5, 3, 6)))
    assert q.shape == (5, 3, 2)


@pytest.mark.parametrize("env", sorted(sp.SHAPES))
def test_sac_policy_and_inference_match_jax(env):
    obs_size, action_size = sp.SHAPES[env]
    nets, policy, _ = sp.port_networks_from_jax(obs_size, action_size)
    jnets, jp, _ = sp.jax_networks(obs_size, action_size)
    jn, tn = sp.normalizer(obs_size)
    obs = _inputs(obs_size, action_size)[0]
    logits_want = np.asarray(jax.jit(jnets.policy_network.apply)(jn, jp, obs))
    with torch.no_grad():
        logits = nets.policy_network(tn, policy, torch.tensor(obs)).numpy()
        assert logits.shape == (ROWS, 2 * action_size)
        np.testing.assert_allclose(logits, logits_want, rtol=2e-5, atol=2e-5)
        make_policy = sac_networks.make_inference_fn(nets)
        mode, extras = make_policy((tn, policy), deterministic=True)(torch.tensor(obs), None)
        assert extras == {}
        np.testing.assert_allclose(
            mode.numpy(), np.asarray(jnets.parametric_action_distribution.mode(logits_want)),
            rtol=2e-5, atol=2e-5)
        action, _ = make_policy((tn, policy))(torch.tensor(obs), torch.Generator().manual_seed(4))
    noise = sp.draws(4, (ROWS, action_size), 1)[0]
    dist = jnets.parametric_action_distribution.create_dist(logits_want)
    want = np.tanh(noise * np.asarray(dist.scale) + np.asarray(dist.loc))
    np.testing.assert_allclose(action.numpy(), want, rtol=2e-5, atol=2e-5)
