"""brax_torch.training.spectral_norm against the JAX package's SNDense
(brax_tpu/training/spectral_norm.py) on the CPU: the mirror of
tests/test_io_and_interop.py::test_spectral_norm_dense, and three calls from
the flax kernel, bias and power-iteration vector carried across, each
call's output, updated vector and sigma held to 1e-5 relative."""

import numpy as np
import pytest
import torch

from brax_torch.training.spectral_norm import SNDense, load_flax_sn_dense

from tests.torch_parity import one_torch_thread  # noqa: F401

RTOL = 1e-5


def test_spectral_norm_dense():
    """tests/test_io_and_interop.py:141 on the port's layer."""
    gen = torch.Generator().manual_seed(0)
    layer = SNDense(4, 8, device="cpu", generator=gen)
    y = layer(torch.ones((3, 4)))
    assert y.shape == (3, 8)
    # kernel spectral norm ~<= 1 after normalization: outputs stay bounded
    big = layer(100 * torch.eye(4)).detach()
    s = torch.linalg.svdvals(big / 100.0)
    assert float(s[0]) < 1.5


@pytest.mark.parametrize("n_steps", [1, 3])
def test_sn_dense_matches_jax_over_three_calls(n_steps):
    import jax
    import jax.numpy as jnp
    from brax_tpu.training import spectral_norm as jax_sn

    d_in, features = 6, 5
    jax_layer = jax_sn.SNDense(features=features, n_steps=n_steps)
    rs = np.random.RandomState(0)
    xs = [rs.randn(4, d_in).astype(np.float32) for _ in range(3)]
    variables = jax_layer.init({"params": jax.random.PRNGKey(0),
                                "sing_vec": jax.random.PRNGKey(1)}, xs[0])
    # a nonzero bias, so that the carried bias is checked too
    variables = {"params": {"kernel": variables["params"]["kernel"],
                            "bias": jnp.asarray(rs.randn(features).astype(np.float32))},
                 "sing_vec": variables["sing_vec"]}

    layer = load_flax_sn_dense(SNDense(d_in, features, n_steps=n_steps, device="cpu"),
                               variables)
    kernel = variables["params"]["kernel"]
    for x in xs:
        # sigma from JAX's own normalisation, on the vector the call starts from
        u = variables["sing_vec"]["u0"]
        for _ in range(n_steps):
            v = jax_sn._l2_normalize(u @ kernel.T, eps=1e-4)
            u = jax_sn._l2_normalize(v @ kernel, eps=1e-4)
        jax_sigma = float((v @ kernel @ u.T)[0, 0])
        _, port_sigma = layer.power_iteration()

        y_jax, updates = jax_layer.apply(variables, jnp.asarray(x), mutable=["sing_vec"])
        variables = {"params": variables["params"], "sing_vec": updates["sing_vec"]}
        y = layer(torch.from_numpy(x))

        np.testing.assert_allclose(float(port_sigma.detach()), jax_sigma, rtol=RTOL)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax), rtol=RTOL,
                                   atol=RTOL * float(np.abs(y_jax).max()))
        np.testing.assert_allclose(layer.u0.numpy(), np.asarray(updates["sing_vec"]["u0"]),
                                   rtol=RTOL, atol=RTOL)


def test_sn_dense_gradient_holds_the_vector_fixed():
    """The kernel's gradient passes through sigma with u and v held fixed,
    as the JAX layer's stop_gradient does: the same gradient as jax.grad."""
    import jax
    import jax.numpy as jnp
    from brax_tpu.training import spectral_norm as jax_sn

    jax_layer = jax_sn.SNDense(features=3)
    x = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    variables = jax_layer.init({"params": jax.random.PRNGKey(2),
                                "sing_vec": jax.random.PRNGKey(3)}, x)

    def loss(params):
        y, _ = jax_layer.apply({"params": params, "sing_vec": variables["sing_vec"]},
                               jnp.asarray(x), mutable=["sing_vec"])
        return jnp.sum(y ** 2)

    grad = jax.grad(loss)(variables["params"])
    layer = load_flax_sn_dense(SNDense(4, 3, device="cpu"), variables)
    (layer(torch.from_numpy(x)) ** 2).sum().backward()
    np.testing.assert_allclose(layer.kernel.grad.numpy(), np.asarray(grad["kernel"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(grad["bias"]),
                               rtol=1e-4, atol=1e-5)
