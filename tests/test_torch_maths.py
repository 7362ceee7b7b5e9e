"""brax_torch.maths against brax_tpu.maths on shared random numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brax_tpu import maths as jm
from brax_tpu.sim import lowering
from brax_torch import maths as tm

from tests.torch_parity import one_torch_thread  # noqa: F401

ATOL = 1e-6


def _vecs(seed, n=64, width=3, scale=1.0):
    return np.random.RandomState(seed).uniform(-scale, scale, (n, width)).astype(np.float32)


def _quats(seed, n=64):
    q = _vecs(seed, n, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _close(port_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), atol=atol, rtol=0)


CASES = {
    "vdot": (lambda m, a, b: m.vdot(a, b), ("v", "v")),
    "dot1": (lambda m, a, b: m.dot1(a, b), ("v", "v")),
    "cross": (lambda m, a, b: m.cross(a, b), ("v", "v")),
    "safe_norm": (lambda m, a: m.safe_norm(a), ("v",)),
    "rotate": (lambda m, a, q: m.rotate(a, q), ("v", "q")),
    "inv_rotate": (lambda m, a, q: m.inv_rotate(a, q), ("v", "q")),
    "euler_to_quat": (lambda m, a: m.euler_to_quat(a * 180), ("v",)),
    "quat_mul": (lambda m, p, q: m.quat_mul(p, q), ("q", "q")),
    "vec_quat_mul": (lambda m, a, q: m.vec_quat_mul(a, q), ("v", "q")),
    "quat_inv": (lambda m, q: m.quat_inv(q), ("q",)),
    "normalize": (lambda m, a: m.normalize(a), ("v",)),
    "signed_angle": (lambda m, a, b, c: m.signed_angle(a, b, c), ("v", "v", "v")),
    "safe_arccos": (lambda m, a: m.safe_arccos(a[..., 0] * 0.99), ("v",)),
    "quat_to_3x3": (lambda m, q: m.quat_to_3x3(q), ("q",)),
    "quat_rot_axis": (lambda m, a, b: m.quat_rot_axis(a, b[..., 0] * 3), ("v", "v")),
    "normalize_with_norm_x": (lambda m, a: m.normalize_with_norm(a)[0], ("v",)),
    "normalize_with_norm_n": (lambda m, a: m.normalize_with_norm(a)[1], ("v",)),
    "orthogonals_p": (lambda m, a: m.orthogonals(m.normalize(a))[0], ("v",)),
    "orthogonals_q": (lambda m, a: m.orthogonals(m.normalize(a))[1], ("v",)),
    "from_to": (lambda m, a, b: m.from_to(m.normalize(a), m.normalize(b)), ("v", "v")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    fn, kinds = CASES[name]
    args = [(_vecs if k == "v" else _quats)(seed) for seed, k in enumerate(kinds)]
    args[0][0] = 0.0  # a zero row exercises the safe-norm branches
    if kinds[0] == "q":
        args[0][0, 0] = 1.0
    # the JAX side runs in kernel mode, where arctan2 is the minimax polynomial
    with lowering.kernel_mode():
        ref = fn(jm, *[jnp.asarray(a) for a in args])
    _close(fn(tm, *[torch.from_numpy(a) for a in args]), ref)


def test_arctan2_branch_edges():
    """x = 0, y = 0, |y/x| > 1 and every quadrant, against the JAX polynomial."""
    edge = [0.0, -0.0, 1.0, -1.0, 3.0, -3.0, 0.25, -0.25, 1e-8, -1e-8, 1e3]
    y, x = np.meshgrid(np.array(edge, np.float32), np.array(edge, np.float32))
    y, x = y.ravel(), x.ravel()
    with lowering.kernel_mode():
        ref = jm.arctan2(jnp.asarray(y), jnp.asarray(x))
    out = tm.arctan2(torch.from_numpy(y), torch.from_numpy(x))
    _close(out, ref)
    # away from signed zeros (where both JAX paths differ from numpy's
    # convention on purpose) the polynomial is within its stated error
    neg_zero = lambda v: (v == 0) & np.signbit(v)
    keep = ~neg_zero(x) & ~neg_zero(y)
    np.testing.assert_allclose(out.numpy()[keep], np.arctan2(y, x)[keep], atol=1e-6)


def test_safe_norm_zero_threshold():
    x = np.array([[1e-9, -1e-9, 0.0], [2e-8, 0.0, 0.0], [3.0, 4.0, 0.0]], np.float32)
    out = tm.safe_norm(torch.from_numpy(x))
    _close(out, jm.safe_norm(jnp.asarray(x)))
    assert out[0] == 0.0 and out[1] > 0.0


def test_inv_approximate_matches_jax():
    """Newton-Schulz from a warm start near the inverse, and from a start so
    far off that the scaled-transpose fallback takes over."""
    import jax

    rs = np.random.RandomState(0)
    b = rs.randn(8, 14, 14).astype(np.float32)
    a = (b @ b.transpose(0, 2, 1) + 14 * np.eye(14)).astype(np.float32)
    warm = np.linalg.inv(a + 0.05 * np.eye(14)).astype(np.float32)
    warm[4:] *= 3.0  # residual norm above 1: the fallback start
    with jax.default_matmul_precision("highest"):
        ref = jax.vmap(lambda x, y: jm.inv_approximate(x, y, maxiter=4))(a, warm)
    out = tm.inv_approximate(torch.from_numpy(a), torch.from_numpy(warm), maxiter=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out[:4].numpy(), np.linalg.inv(a[:4]), atol=1e-5)
