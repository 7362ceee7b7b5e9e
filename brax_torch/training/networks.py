"""Policy and value networks.

Counterpart of `brax_tpu/training/networks.py`.  `MLP` keeps flax's layout:
layers `hidden_0..hidden_{k-1}`, each with a `kernel` of shape
[d_in, d_out] and a `bias`, so that the fused kernel reads the weights
without a transpose and `load_flax_params` is a straight copy.  Kernels
start lecun-uniform, U(+-sqrt(3 / fan_in)), and biases at zero, as flax
initialises them; the recipes' learning rates are tuned for that.

A network is called with its parameters as a mapping (name -> tensor, the
names of `named_parameters()`), so that a trainer can hold the parameters
it optimises apart from the module, as the JAX package holds its params.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from brax_torch.training import fused_mlp, types

Tensor = torch.Tensor
ActivationFn = Callable[[Tensor], Tensor]


class Dense(nn.Module):
    """One layer: x @ kernel + bias, kernel [d_in, d_out]."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, device="cuda"):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((d_in, d_out), device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros((d_out,), device=device))
        else:
            self.register_parameter("bias", None)


class MLP(nn.Module):
    """Plain MLP."""

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        activation: ActivationFn = F.relu,
        activate_final: bool = False,
        bias: bool = True,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.layer_sizes = list(layer_sizes)
        self.activation = activation
        self.activate_final = activate_final
        self.bias = bias
        d_in = in_size
        for i, d_out in enumerate(self.layer_sizes):
            self.add_module(f"hidden_{i}", Dense(d_in, d_out, bias, device))
            d_in = d_out
        self.reset_parameters(generator)

    def layers(self):
        return [getattr(self, f"hidden_{i}") for i in range(len(self.layer_sizes))]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """lecun_uniform kernels, zero biases."""
        for layer in self.layers():
            limit = math.sqrt(3.0 / layer.kernel.shape[0])
            u = torch.rand(layer.kernel.shape, generator=generator, device=layer.kernel.device)
            layer.kernel.copy_(u * (2 * limit) - limit)
            if layer.bias is not None:
                layer.bias.zero_()

    def forward(self, x: Tensor, params: Optional[Mapping[str, Tensor]] = None) -> Tensor:
        return _mlp_apply(self, dict(self.named_parameters()) if params is None else params, x)


def _mlp_apply(mlp: MLP, params: Mapping[str, Tensor], x: Tensor) -> Tensor:
    """MLP apply, routed through the fused kernels when fused_mlp is enabled,
    the activation is one of the kernel's, the last layer is linear and the
    layers have biases (the JAX package's predicate)."""
    n = len(mlp.layer_sizes)
    kernels = [params[f"hidden_{i}.kernel"] for i in range(n)]
    act_name = fused_mlp.activation_name(mlp.activation)
    if fused_mlp.enabled() and act_name is not None and not mlp.activate_final and mlp.bias:
        biases = [params[f"hidden_{i}.bias"] for i in range(n)]
        return fused_mlp.dense_chain(x, kernels, biases, activation=act_name)
    hidden = x
    for i, kernel in enumerate(kernels):
        hidden = hidden @ kernel
        if mlp.bias:
            hidden = hidden + params[f"hidden_{i}.bias"]
        if i != n - 1 or mlp.activate_final:
            hidden = mlp.activation(hidden)
    return hidden


@torch.no_grad()
def load_flax_params(mlp: MLP, params) -> MLP:
    """Fills `mlp` from flax MLP params {"params": {"hidden_i": {"kernel",
    "bias"}}} given as arrays: a straight copy, the layouts being the same."""
    layers = params["params"]
    if sorted(layers) != sorted(f"hidden_{i}" for i in range(len(mlp.layer_sizes))):
        raise ValueError(f"flax layers {sorted(layers)} do not match {len(mlp.layer_sizes)} layers")
    for i, layer in enumerate(mlp.layers()):
        src = layers[f"hidden_{i}"]
        layer.kernel.copy_(torch.tensor(np.array(src["kernel"], dtype=np.float32)))
        if layer.bias is not None:
            layer.bias.copy_(torch.tensor(np.array(src["bias"], dtype=np.float32)))
    return mlp


class FeedForwardNetwork(nn.Module):
    """obs -> preprocess -> MLP, called as net(processor_params, params, obs)."""

    def __init__(self, mlp: MLP, preprocess_observations_fn: types.PreprocessObservationFn,
                 squeeze: bool = False):
        super().__init__()
        self.mlp = mlp
        self.preprocess_observations_fn = preprocess_observations_fn
        self.squeeze = squeeze

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Re-draws the MLP's parameters and returns them by name."""
        self.mlp.reset_parameters(generator)
        return dict(self.mlp.named_parameters())

    def forward(self, processor_params, params: Mapping[str, Tensor], obs: Tensor) -> Tensor:
        out = self.mlp(self.preprocess_observations_fn(obs, processor_params), params)
        return out.squeeze(-1) if self.squeeze else out


def make_policy_network(
    param_size: int,
    obs_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (256, 256),
    activation: ActivationFn = F.relu,
    device="cuda",
) -> FeedForwardNetwork:
    """Policy network: obs -> distribution parameters."""
    mlp = MLP(obs_size, list(hidden_layer_sizes) + [param_size], activation=activation,
              device=device)
    return FeedForwardNetwork(mlp, preprocess_observations_fn)


def make_value_network(
    obs_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (256, 256),
    activation: ActivationFn = F.relu,
    device="cuda",
) -> FeedForwardNetwork:
    """Value network: obs -> scalar."""
    mlp = MLP(obs_size, list(hidden_layer_sizes) + [1], activation=activation, device=device)
    return FeedForwardNetwork(mlp, preprocess_observations_fn, squeeze=True)
