"""Gradient update factory over a torch optimizer, one device.

Counterpart of `brax_tpu/training/gradients.py`: there is no cross-device
`pmean`.  The optimizer updates the parameters it holds in place.
`adam(params, learning_rate)` is `optax.adam` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0): torch's Adam computes the same update,
lr * m / (1 - b1^t) / (sqrt(v) / sqrt(1 - b2^t) + eps).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def adam(params: Iterable[torch.Tensor], learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def gradient_update_fn(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                       has_aux: bool = False):
    """Returns f(*args) -> loss (or (loss, aux)): one gradient step of
    `optimizer` on loss_fn(*args), whose first argument holds the params."""

    def f(*args, **kwargs):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(*args, **kwargs)
        loss = out[0] if has_aux else out
        loss.backward()
        optimizer.step()
        return out

    return f
