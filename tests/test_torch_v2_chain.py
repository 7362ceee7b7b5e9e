"""The generalized kernel's chain entry, `build_tiled_chain_fn`, on the CPU.

The port's chain carries (q, qd, M^-1) in the kernel's (fields, N) layout
from step to step; on CPU tensors each step runs `gen_step_plain` on that
layout.  It is held against the JAX package's generalized pipeline (the
jnp `pipeline.step`, vmapped and jitted once in tests/torch_parity.py: the
JAX chain's own first call, `build_tiled_chain_fn(..., interpret=True)` at
128 envs, takes ~50 s on this CPU) at the tolerances of
tests/test_v2_generalized_kernel.py's chain test (q 1e-5, qd and M^-1
1e-3), and against the port's chained `gen_step` bit for bit.  On the card
tests/test_torch_cuda.py holds the launch route the same way.
"""

import dataclasses

import numpy as np
import pytest
import torch

from brax_torch.v2 import mjcf
from brax_torch.v2.envs import assets
from brax_torch.v2.generalized import kernels

from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def sys():
    return mjcf.loads(assets.ant_xml(), device="cpu")


def _soa(x):
    x = torch.as_tensor(np.asarray(x))
    return x.reshape(x.shape[0], -1).t().contiguous()


def _mirrored(minv):
    """M^-1 with its upper triangle mirrored, as the kernel carries it."""
    minv = np.array(minv)
    upper = np.triu(np.ones(minv.shape[1:], dtype=bool))
    return np.where(upper, minv, np.swapaxes(minv, 1, 2))


def test_chain_matches_jax_pipeline(sys):
    """Two chained 1-frame steps from the JAX pipeline's state in contact:
    each step's q and qd against the JAX pipeline.step's, and the M^-1 the
    step used against the JAX State's inverse at the step's start."""
    q, qd, act = tp.v2_inputs()
    s0, s1 = tp.jax_v2_states()
    s2 = tp.jax_v2_step()(s1, act)
    n = q.shape[0]
    step_t, _ = kernels.build_tiled_chain_fn(sys, 1, n)
    carry = (_soa(q), _soa(qd), _soa(_mirrored(s0.mass_mx_inv)))
    for nxt, start in ((s1, s0), (s2, s1)):
        carry, _ = step_t(carry, _soa(act))
        for got, want, tol in ((carry[0], nxt.q, 1e-5), (carry[1], nxt.qd, 1e-3),
                               (carry[2], start.mass_mx_inv, 1e-3)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.t().reshape(want.shape).numpy(), want, atol=tol,
                                       rtol=tol)


def test_chain_equals_chained_gen_step_bit_for_bit(sys):
    """Three chained 2-frame steps: every output of the chain is the chained
    `gen_step`'s (the batch-first route) on the chain's layout, bit for
    bit, and no kernel is launched on the CPU."""
    q, qd, act = (x[:4] for x in tp.v2_inputs(seed=3))
    s0, _ = tp.jax_v2_states(seed=3)
    minv = _mirrored(s0.mass_mx_inv)[:4]
    n = 4
    step_t, schema = kernels.build_tiled_chain_fn(sys, 2, n)
    carry = (_soa(q), _soa(qd), _soa(minv))
    state = [torch.from_numpy(np.asarray(x)) for x in (q, qd, minv)]
    a = torch.from_numpy(act)
    before = kernels.gen_step_soa.launches
    for _ in range(3):
        carry, outs = step_t(carry, _soa(act))
        out = kernels.gen_step(sys, *state, a, 2)
        state = [out["q"], out["qd"], out["minv"]]
        assert [k for k, _ in schema] == list(outs) == list(out)
        for k, v in out.items():
            assert torch.equal(outs[k], _soa(v)), k
    for c, s in zip(carry, state):
        assert torch.equal(c, _soa(s))
    assert kernels.gen_step_soa.launches == before


def test_chain_schema_and_batch(sys):
    """The schema lists each output's per-env shape (out_shapes); a carry of
    another width than the chain's raises."""
    step_t, schema = kernels.build_tiled_chain_fn(sys, 1, 8)
    assert dict(schema) == kernels.out_shapes(sys)
    assert schema[:3] == [("q", (15,)), ("qd", (14,)), ("minv", (14, 14))]
    carry = (torch.zeros(15, 4), torch.zeros(14, 4), torch.zeros(196, 4))
    with pytest.raises(ValueError, match="built for 8 envs"):
        step_t(carry, torch.zeros(8, 4))


def test_chain_refuses_an_unsupported_system(sys):
    """A System the kernel does not cover raises NotImplementedError when
    the chain is built, naming the feature; nothing falls back."""
    other = dataclasses.replace(sys, actuator_types="mp" * 4)
    with pytest.raises(NotImplementedError, match="actuator types"):
        kernels.build_tiled_chain_fn(other, 1, 8)
