"""brax_torch.training.fused_mlp's plain versions against the JAX package's
`dense_chain` (its Pallas kernels in interpret mode, as
tests/test_fused_mlp.py runs them on the CPU).

Inputs and the output cotangent are made with numpy from a seed and handed
to both; each JAX case is jitted once.  f32 mode is held to
tests/test_fused_mlp.py's tolerances.  bf16 mode rounds the same values to
bf16 on both sides, so the two differ only where f32 sums taken in another
order round a value to a neighbouring bf16 number; it is held to
BF16_REL: max |port - jax| <= BF16_REL * max |jax| per output.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.training import fused_mlp as jax_fused
from brax_torch.training import fused_mlp

from tests.torch_parity import one_torch_thread  # noqa: F401

# the largest seen in these cases is 2.8e-3 (the 256-wide value chain)
BF16_REL = 1e-2
# tests/test_fused_mlp.py's shape cases, 137 rows and its 3-D batch:
# (leading dims, d0, sizes, activation)
CASES = [
    ((137,), 87, (256,) * 5 + (1,), "swish"),
    ((137,), 87, (32,) * 4 + (16,), "swish"),
    ((137,), 87, (64, 64, 8), "relu"),
    ((137,), 87, (40, 3), "tanh"),
    ((5, 33), 29, (64, 7), "swish"),
]


def _inputs(lead, d0, sizes, seed=0):
    rs = np.random.RandomState(seed)
    dims = [d0, *sizes]
    x = rs.normal(size=lead + (d0,)).astype(np.float32)
    ws = [(rs.uniform(-1, 1, (a, b)) * np.sqrt(3.0 / a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rs.normal(size=(b,)).astype(np.float32) * 0.1 for b in dims[1:]]
    g = rs.normal(size=lead + (dims[-1],)).astype(np.float32)
    return x, ws, bs, g


@functools.lru_cache(maxsize=None)
def _jax_vjp(activation, bf16):
    """(x, ws, bs, g) -> (y, dx, dws, dbs) through the JAX dense_chain."""
    mm = jnp.bfloat16 if bf16 else jnp.float32

    def f(x, ws, bs, g):
        fn = lambda x, ws, bs: jax_fused.dense_chain(x, ws, bs, activation=activation,
                                                     matmul_dtype=mm, interpret=True)
        y, vjp = jax.vjp(fn, x, ws, bs)
        return (y,) + vjp(g)

    return jax.jit(f)


def _port_vjp(x, ws, bs, g, activation, bf16):
    xt = torch.tensor(x, requires_grad=True)
    wt = [torch.tensor(w, requires_grad=True) for w in ws]
    bt = [torch.tensor(b, requires_grad=True) for b in bs]
    y = fused_mlp.dense_chain_plain(xt, wt, bt, activation=activation,
                                    matmul_dtype=torch.bfloat16 if bf16 else torch.float32)
    y.backward(torch.tensor(g))
    num = lambda t: t.detach().numpy()
    return num(y), num(xt.grad), [num(w.grad) for w in wt], [num(b.grad) for b in bt]


def _compare(lead, d0, sizes, activation, bf16):
    x, ws, bs, g = _inputs(lead, d0, sizes)
    want = _jax_vjp(activation, bf16)(x, ws, bs, g)
    y, dx, dws, dbs = _port_vjp(x, ws, bs, g, activation, bf16)
    assert y.shape == lead + (sizes[-1],)
    pairs = [("y", y, want[0]), ("dx", dx, want[1])]
    pairs += [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, want[2]))]
    pairs += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, want[3]))]
    for name, got, ref in pairs:
        ref = np.asarray(ref)
        if not bf16:
            tol = dict(rtol=2e-5, atol=2e-5) if name == "y" else dict(rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(got, ref, err_msg=name, **tol)
        else:
            err = np.abs(got - ref).max()
            assert err <= BF16_REL * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("lead,d0,sizes,activation", CASES)
def test_dense_chain_plain_matches_jax_f32(lead, d0, sizes, activation):
    _compare(lead, d0, sizes, activation, bf16=False)


@pytest.mark.parametrize("lead,d0,sizes,activation", CASES)
def test_dense_chain_plain_matches_jax_bf16(lead, d0, sizes, activation):
    """The default (bf16) mode, the recipe's value and policy chains first."""
    _compare(lead, d0, sizes, activation, bf16=True)


@pytest.mark.parametrize("activation", ["swish", "relu", "tanh"])
def test_bwd_plain_is_the_gradient_of_fwd_plain(activation):
    """chain_bwd_plain (the backward kernel's plain version) equals autograd
    through chain_fwd_plain in f32, for each activation."""
    x, ws, bs, g = _inputs((50,), 21, (40, 40, 3), seed=3)
    xt = torch.tensor(x, requires_grad=True)
    wt = [torch.tensor(w, requires_grad=True) for w in ws]
    bt = [torch.tensor(b, requires_grad=True) for b in bs]
    y = fused_mlp.chain_fwd_plain(xt, wt, bt, activation, bf16=False)
    y.backward(torch.tensor(g))
    dx, dws, dbs = fused_mlp.chain_bwd_plain(
        xt.detach(), [w.detach() for w in wt], [b.detach() for b in bt], torch.tensor(g),
        activation, bf16=False)
    torch.testing.assert_close(dx, xt.grad, rtol=2e-5, atol=2e-6)
    for a, b in zip(dws + dbs, [w.grad for w in wt] + [b.grad for b in bt]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    x, ws, bs, g = _inputs((9,), 5, (6, 2))
    t = torch.tensor
    before = (fused_mlp.chain_fwd.launches, fused_mlp.chain_bwd.launches)
    xt = t(x, requires_grad=True)
    y = fused_mlp.dense_chain(xt, [t(w) for w in ws], [t(b) for b in bs])
    y.backward(t(g))
    assert (fused_mlp.chain_fwd.launches, fused_mlp.chain_bwd.launches) == before
    y_plain = fused_mlp.dense_chain_plain(t(x), [t(w) for w in ws], [t(b) for b in bs])
    torch.testing.assert_close(y, y_plain, rtol=0, atol=0)


def test_bf16_mode_rounds_the_matmul_inputs():
    """bf16 mode equals f32 mode on inputs that are bf16 numbers already, and
    differs from it on inputs that are not."""
    x, ws, bs, _ = _inputs((16,), 8, (8, 4))
    rnd = lambda a: torch.tensor(a).to(torch.bfloat16).to(torch.float32)
    one_layer = lambda x, w, bf16: fused_mlp.chain_fwd_plain(x, [w], [torch.zeros(8)], bf16=bf16)
    torch.testing.assert_close(one_layer(rnd(x), rnd(ws[0]), True),
                               one_layer(rnd(x), rnd(ws[0]), False), rtol=0, atol=0)
    assert not torch.equal(one_layer(torch.tensor(x), torch.tensor(ws[0]), True),
                           one_layer(torch.tensor(x), torch.tensor(ws[0]), False))


def test_enable_flag():
    prev = fused_mlp.enabled()
    try:
        fused_mlp.enable(True)
        assert fused_mlp.enabled()
        fused_mlp.enable(False)
        assert not fused_mlp.enabled()
    finally:
        fused_mlp.enable(prev)


def test_activation_names():
    F = torch.nn.functional
    assert fused_mlp.activation_name(F.silu) == "swish"
    assert fused_mlp.activation_name(torch.relu) == "relu"
    assert fused_mlp.activation_name(torch.tanh) == "tanh"
    assert fused_mlp.activation_name(F.gelu) is None
