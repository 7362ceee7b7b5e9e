"""Policy, value and Q networks.

Counterpart of `brax_tpu/training/networks.py`.  `MLP` keeps flax's layout:
layers `hidden_0..hidden_{k-1}`, each with a `kernel` of shape
[d_in, d_out] and a `bias`, so that the fused kernel reads the weights
without a transpose and `load_flax_params` is a straight copy.  Kernels
start lecun-uniform, U(+-sqrt(3 / fan_in)), and biases at zero, as flax
initialises them; the recipes' learning rates are tuned for that.

A network is called with its parameters as a mapping (name -> tensor, the
names of `named_parameters()`), so that a trainer can hold the parameters
it optimises apart from the module, as the JAX package holds its params.
The Q network's critics are the submodules `MLP_0`, `MLP_1`, ... (flax's
auto-names), so its parameters are named `MLP_i.hidden_j.kernel`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence

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


def _mlp_apply(mlp: MLP, params: Mapping[str, Tensor], x: Tensor, prefix: str = "") -> Tensor:
    """MLP apply, routed through the fused kernels when fused_mlp is enabled,
    the activation is one of the kernel's, the last layer is linear and the
    layers have biases (the JAX package's predicate).  The layers' params
    are named `{prefix}hidden_{i}.kernel` / `.bias`."""
    n = len(mlp.layer_sizes)
    kernels = [params[f"{prefix}hidden_{i}.kernel"] for i in range(n)]
    act_name = fused_mlp.activation_name(mlp.activation)
    if fused_mlp.enabled() and act_name is not None and not mlp.activate_final and mlp.bias:
        biases = [params[f"{prefix}hidden_{i}.bias"] for i in range(n)]
        return fused_mlp.dense_chain(x, kernels, biases, activation=act_name)
    hidden = x
    for i, kernel in enumerate(kernels):
        hidden = hidden @ kernel
        if mlp.bias:
            hidden = hidden + params[f"{prefix}hidden_{i}.bias"]
        if i != n - 1 or mlp.activate_final:
            hidden = mlp.activation(hidden)
    return hidden


@torch.no_grad()
def load_flax_params(mlp, params):
    """Fills `mlp` from flax MLP params {"params": {"hidden_i": {"kernel",
    "bias"}}} given as arrays: a straight copy, the layouts being the same.
    A `QModule` takes the Q network's {"params": {"MLP_i": {"hidden_j":
    ...}}}, each critic filled from its own."""
    if isinstance(mlp, QModule):
        critics = params["params"]
        if sorted(critics) != sorted(f"MLP_{i}" for i in range(mlp.n_critics)):
            raise ValueError(f"flax critics {sorted(critics)} do not match {mlp.n_critics}")
        for i in range(mlp.n_critics):
            load_flax_params(getattr(mlp, f"MLP_{i}"), {"params": critics[f"MLP_{i}"]})
        return mlp
    layers = params["params"]
    if sorted(layers) != sorted(f"hidden_{i}" for i in range(len(mlp.layer_sizes))):
        raise ValueError(f"flax layers {sorted(layers)} do not match {len(mlp.layer_sizes)} layers")
    for i, layer in enumerate(mlp.layers()):
        src = layers[f"hidden_{i}"]
        layer.kernel.copy_(torch.tensor(np.array(src["kernel"], dtype=np.float32)))
        if layer.bias is not None:
            layer.bias.copy_(torch.tensor(np.array(src["bias"], dtype=np.float32)))
    return mlp


def flax_param_dict(params, device="cpu") -> Dict[str, Tensor]:
    """flax MLP params {"params": {"hidden_i": {"kernel", "bias"}}} (or a Q
    network's {"params": {"MLP_i": {"hidden_j": ...}}}), given as arrays,
    as the port's name -> tensor mapping (`hidden_i.kernel`,
    `MLP_i.hidden_j.bias`: the names of `named_parameters()`), copies on
    `device`; the layouts are the same.  Anything else (a discriminator's
    {"empty": 0}) maps leaf by leaf, and a bare array (an ARS policy's
    (obs, act) matrix) is its tensor."""
    tensor = lambda x: torch.tensor(np.array(x, dtype=np.float32), device=device)
    if not isinstance(params, Mapping):
        return tensor(params)
    if "params" not in params:
        return {k: tensor(v) for k, v in params.items()}
    out = {}

    def walk(tree, prefix):
        for name, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, f"{prefix}{name}.")
            else:
                out[f"{prefix}{name}"] = tensor(sub)

    walk(params["params"], "")
    return out


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


class QModule(nn.Module):
    """`n_critics` MLPs (`MLP_0`, ...) over the concatenated observation
    and action, each ending in one unit."""

    def __init__(self, in_size: int, hidden_layer_sizes: Sequence[int], activation: ActivationFn,
                 n_critics: int, device="cuda"):
        super().__init__()
        self.n_critics = n_critics
        for i in range(n_critics):
            self.add_module(f"MLP_{i}", MLP(in_size, list(hidden_layer_sizes) + [1],
                                            activation=activation, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.n_critics):
            getattr(self, f"MLP_{i}").reset_parameters(generator)


class QNetwork(nn.Module):
    """(obs, action) -> [..., n_critics], called as
    net(processor_params, params, obs, actions)."""

    def __init__(self, module: QModule, preprocess_observations_fn: types.PreprocessObservationFn):
        super().__init__()
        self.module = module
        self.preprocess_observations_fn = preprocess_observations_fn

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Re-draws the critics' parameters and returns them by name."""
        self.module.reset_parameters(generator)
        return dict(self.module.named_parameters())

    def forward(self, processor_params, params: Mapping[str, Tensor], obs: Tensor,
                actions: Tensor) -> Tensor:
        """Each critic over cat([obs, actions]): one fused chain per critic
        where the fused kernels are on (the gradient flows through dx into
        obs and actions, as SAC's actor loss needs), else the plain MLP."""
        hidden = torch.cat([self.preprocess_observations_fn(obs, processor_params), actions],
                           dim=-1)
        return torch.cat([_mlp_apply(getattr(self.module, f"MLP_{i}"), params, hidden,
                                     prefix=f"MLP_{i}.")
                          for i in range(self.module.n_critics)], dim=-1)


def make_q_network(
    obs_size: int,
    action_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (256, 256),
    activation: ActivationFn = F.relu,
    n_critics: int = 2,
    device="cuda",
) -> QNetwork:
    """Twin-critic Q network: (obs, action) -> (n_critics,) values."""
    module = QModule(obs_size + action_size, hidden_layer_sizes, activation, n_critics,
                     device=device)
    return QNetwork(module, preprocess_observations_fn)
