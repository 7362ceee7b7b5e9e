"""Welford running statistics for observation normalisation, one device.

Counterpart of `brax_tpu/training/running_statistics.py` for a single
(non-nested) tensor of observations; there is no cross-device `psum`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


@dataclass
class RunningStatisticsState:
    """Running (mean, std) of the data, with Welford's count and summed variance."""

    count: Tensor
    mean: Tensor
    std: Tensor
    summed_variance: Tensor

    @classmethod
    def from_numpy(cls, count, mean, std, summed_variance, device="cuda"
                   ) -> "RunningStatisticsState":
        """A state holding the given arrays' numbers, as float32 on `device`."""
        t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
        return cls(count=t(count), mean=t(mean), std=t(std),
                   summed_variance=t(summed_variance))


def init_state(shape: Sequence[int], device="cuda") -> RunningStatisticsState:
    zeros = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    return RunningStatisticsState(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=zeros,
        std=torch.ones_like(zeros),
        summed_variance=zeros.clone(),
    )


def update(
    state: RunningStatisticsState,
    batch: Tensor,
    *,
    weights: Optional[Tensor] = None,
    std_min_value: float = 1e-6,
    std_max_value: float = 1e6,
) -> RunningStatisticsState:
    """Batched Welford update over every leading dim of `batch`."""
    n_batch_dims = batch.dim() - state.mean.dim()
    batch_dims = tuple(batch.shape[:n_batch_dims])
    if tuple(batch.shape[n_batch_dims:]) != tuple(state.mean.shape):
        raise ValueError(f"{tuple(batch.shape)} does not end with {tuple(state.mean.shape)}")
    if weights is not None and tuple(weights.shape) != batch_dims:
        raise ValueError(f"{tuple(weights.shape)} != {batch_dims}")
    batch_axis = tuple(range(n_batch_dims))
    if weights is None:
        step_increment = float(np.prod(batch_dims))
    else:
        step_increment = torch.sum(weights)
    count = state.count + step_increment

    diff_to_old_mean = batch - state.mean
    if weights is not None:
        diff_to_old_mean = diff_to_old_mean * weights.reshape(
            weights.shape + (1,) * (batch.dim() - weights.dim()))
    mean = state.mean + torch.sum(diff_to_old_mean, dim=batch_axis) / count
    diff_to_new_mean = batch - mean
    summed_variance = state.summed_variance + torch.sum(
        diff_to_old_mean * diff_to_new_mean, dim=batch_axis)

    std = torch.sqrt(torch.clamp(summed_variance, min=0) / count)
    std = torch.clamp(std, std_min_value, std_max_value)
    return RunningStatisticsState(count=count, mean=mean, std=std,
                                  summed_variance=summed_variance)


def normalize(batch: Tensor, mean_std: RunningStatisticsState,
              max_abs_value: Optional[float] = None) -> Tensor:
    """Normalizes data using running statistics.  The gradient passes to
    `batch`; the statistics, which require no grad, are constants to it, as
    in JAX (APG differentiates through the observations)."""
    if not batch.is_floating_point():
        return batch
    data = (batch - mean_std.mean) / mean_std.std
    if max_abs_value is not None:
        data = torch.clamp(data, -max_abs_value, max_abs_value)
    return data

