"""The launch-overhead probe's plain versions against the JAX tool's kernel
bodies.

`tools/probe_pallas_overhead.py` builds its kernels inside `main()`, so the
bodies `copy_k` (:49-50) and `chain_k` (:75-82) are written out here as
they stand there and run through `pl.pallas_call(..., interpret=True)` on
the CPU, without the TPU memory-space specs (whole-array blocks, as the
tool's VMEM specs give on the TPU).  The chain runs at K = 3 on [64, 256]
h; its tolerance is the fused MLP's bf16 rule, max |err| <= 1e-2 max
|plain|: both round the same values to bf16, but sum in other orders.
The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from brax_torch.tools import probe_overhead as probe

from tests.torch_parity import one_torch_thread  # noqa: F401

BF16_REL = 1e-2


def copy_k(x_ref, o_ref):
    o_ref[:] = x_ref[:] + 1.0


def chain_k(k, x_ref, w_ref, o_ref):
    h = x_ref[:]
    for _ in range(k):
        h = jnp.dot(h.astype(jnp.bfloat16), w_ref[:].astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
    o_ref[:] = h


def test_copy_plus_one_matches_copy_k():
    x = np.random.RandomState(0).randn(*probe.TILE).astype(np.float32)
    want = pl.pallas_call(copy_k, out_shape=jax.ShapeDtypeStruct(probe.TILE, jnp.float32),
                          interpret=True)(x)
    got = probe.copy_plus_one(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3])
def test_dot_chain_matches_chain_k(k):
    rs = np.random.RandomState(k)
    x = rs.randn(64, probe.WIDTH).astype(np.float32)
    w = (0.05 * rs.randn(probe.WIDTH, probe.WIDTH)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        functools.partial(chain_k, k), out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(x, w))
    got = probe.dot_chain(torch.from_numpy(x), torch.from_numpy(w), k).numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()
    assert np.abs(got - want).mean() <= 1e-3 * np.abs(want).mean()


def test_wrappers_take_the_plain_versions_on_cpu():
    x, w = probe.inputs(32, device="cpu")
    before = probe.dot_chain.launches, probe.copy_plus_one.launches
    torch.testing.assert_close(probe.dot_chain(x, w, 2), probe.dot_chain_plain(x, w, 2))
    torch.testing.assert_close(probe.copy_plus_one(x), x + 1)
    assert (probe.dot_chain.launches, probe.copy_plus_one.launches) == before
    assert x.shape == (32, probe.WIDTH) and bool((x == 1).all())
