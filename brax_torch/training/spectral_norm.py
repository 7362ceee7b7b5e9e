"""Spectral-normalized dense layer (power iteration).

Counterpart of `brax_tpu/training/spectral_norm.py` (flax `SNDense`), for
discriminator networks.  The kernel [d_in, features] is divided by its
largest singular value, estimated by `n_steps` of power iteration from the
persistent vector `u0` (1, features), a buffer that each call replaces with
the iteration's result, as the JAX layer applied with
`mutable=["sing_vec"]` does.  The iteration is the JAX one (v from u, then
u from v, each l2-normalized with `eps` inside the root; sigma = v K u^T;
the kernel over sigma + eps), which
`torch.nn.utils.parametrizations.spectral_norm` does not follow.
`load_flax_sn_dense` carries the flax params and state across.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

Tensor = torch.Tensor


def _l2_normalize(x: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SNDense(nn.Module):
    """x @ (kernel / (sigma + eps)) + bias, sigma by power iteration."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 eps: float = 1e-4, n_steps: int = 1, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eps = eps
        self.n_steps = n_steps
        # flax's lecun_normal: a normal truncated at 2 std, variance 1 / fan_in
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        kernel = torch.empty((in_features, features), device=device)
        nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std, generator=generator)
        self.kernel = nn.Parameter(kernel)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros((features,), device=device))
        else:
            self.register_parameter("bias", None)
        self.register_buffer(
            "u0", torch.randn((1, features), generator=generator, device=device))

    def power_iteration(self):
        """(u, sigma): `n_steps` of power iteration from `u0` (u0 itself
        unchanged), sigma = v K u^T, differentiable in the kernel with u and
        v held fixed."""
        kernel_2d = self.kernel.reshape(-1, self.kernel.shape[-1])
        with torch.no_grad():
            u0 = self.u0
            for _ in range(self.n_steps):
                v0 = _l2_normalize(u0 @ kernel_2d.t(), self.eps)
                u0 = _l2_normalize(v0 @ kernel_2d, self.eps)
        return u0, ((v0 @ kernel_2d) @ u0.t())[0, 0]

    def forward(self, inputs: Tensor) -> Tensor:
        u0, sigma = self.power_iteration()
        with torch.no_grad():
            self.u0.copy_(u0)
        y = inputs @ (self.kernel / (sigma + self.eps))
        if self.bias is not None:
            y = y + self.bias
        return y


@torch.no_grad()
def load_flax_sn_dense(layer: SNDense, variables: Mapping[str, Any]) -> SNDense:
    """Fills `layer` from flax SNDense variables {"params": {"kernel",
    "bias"}, "sing_vec": {"u0"}} given as arrays: a straight copy, the
    layouts being the same."""
    tensor = lambda x: torch.tensor(np.array(x, dtype=np.float32), device=layer.kernel.device)
    params = variables["params"]
    layer.kernel.copy_(tensor(params["kernel"]))
    if layer.bias is not None:
        layer.bias.copy_(tensor(params["bias"]))
    layer.u0.copy_(tensor(variables["sing_vec"]["u0"]))
    return layer
