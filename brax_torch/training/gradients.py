"""Gradient update factory over a torch optimizer, one device.

Counterpart of `brax_tpu/training/gradients.py`: there is no cross-device
`pmean`.  The optimizer updates the parameters it holds in place.  A
gradient step is `loss_and_grads` then `apply_gradients`, the JAX
function's two halves: `torch.autograd.grad` over the loss function's
first argument alone (a tensor, or dicts and NamedTuples of them), so a
loss that reaches another network (SAC's three do) leaves no `.grad`
there and runs no backward for it; then the optimizer's step from those
gradients.  `gradient_update_fn` joins the two, as PPO takes its steps.
`adam(params, learning_rate)` is `optax.adam` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0): torch's Adam computes the same update,
lr * m / (1 - b1^t) / (sqrt(v) / sqrt(1 - b2^t) + eps).
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from brax_torch.training import types

# a tensor, or nested dicts and NamedTuples of tensors
Params = Any


def adam(params, learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _leaves(params: Params) -> List[torch.Tensor]:
    leaves = []
    types.tree_map(leaves.append, params)
    return leaves


def loss_and_grads(loss_fn: Callable, params: Params, *args, has_aux: bool = False, **kwargs):
    """(out, d loss / d params) of out = loss_fn(params, *args): out is the
    loss, or (loss, aux) with `has_aux`, its loss detached; the gradients
    have params' structure.  The gradient of the first argument only,
    leaving no `.grad` anywhere."""
    out = loss_fn(params, *args, **kwargs)
    loss = out[0] if has_aux else out
    grads = iter(torch.autograd.grad(loss, _leaves(params)))
    out = (loss.detach(), *out[1:]) if has_aux else loss.detach()
    return out, types.tree_map(lambda _: next(grads), params)


def apply_gradients(optimizer: torch.optim.Optimizer, params: Params, grads: Params) -> None:
    """One step of `optimizer` (which holds `params`) from `grads`."""
    tensors = _leaves(params)
    for p, g in zip(tensors, _leaves(grads)):
        p.grad = g
    optimizer.step()
    for p in tensors:
        p.grad = None


def gradient_update_fn(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                       has_aux: bool = False):
    """Returns f(params, *args) -> loss (or (loss, aux)): one gradient step
    of `optimizer`, which holds `params`, on loss_fn(params, *args)."""

    def f(params, *args, **kwargs):
        out, grads = loss_and_grads(loss_fn, params, *args, has_aux=has_aux, **kwargs)
        apply_gradients(optimizer, params, grads)
        return out

    return f
