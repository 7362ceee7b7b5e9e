"""Replay buffers on the device.

Counterpart of `brax_tpu/training/replay_buffers.py` up to its shard
helpers, on one device: a buffer is a flat 2-D float32 ring
`data[(max_replay_size, dim)]` with an insert cursor and a count.  A sample
is a tree of tensors (a `Transition`) with the batch leading; it is
flattened per row in the order of JAX's `ravel_pytree`: NamedTuple fields
in order, dict keys sorted, each leaf's trailing dims row-major.  For
humanoid's SAC Transition that is observation 240, action 17, reward,
discount, next_observation 240, then `extras` (an empty "policy_extras",
then "state_extras"' truncation): 500 floats a row.

The cursors are Python ints, so that inserting and sampling never wait for
the device.  `UniformSamplingQueue` draws its indices from a
`torch.Generator` kept in the state, on the buffer's device;
`sample_at(state, idx)` is the step after the draw, so that a test can give
two buffers the same indices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Generic, List, Tuple, TypeVar

import numpy as np
import torch

Tensor = torch.Tensor
Sample = TypeVar("Sample")


@dataclasses.dataclass
class ReplayBufferState:
    """Ring buffer contents and cursors."""

    data: Tensor  # (max_size, sample_dim), float32
    current_position: int
    current_size: int
    generator: torch.Generator


def _leaves(tree) -> List[Any]:
    """The leaves of nested dicts and tuples, in `ravel_pytree`'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _rebuild(tree, leaves):
    """`tree` with its leaves taken in order from the iterator `leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return type(tree)(*[_rebuild(x, leaves) for x in tree])
    return next(leaves)


class QueueBase(Generic[Sample]):
    """Limited-size FIFO ring over flattened samples."""

    def __init__(self, max_replay_size: int, dummy_data_sample: Sample, sample_batch_size: int,
                 device="cuda"):
        self._dummy = dummy_data_sample
        self._shapes = [tuple(np.shape(leaf)) for leaf in _leaves(dummy_data_sample)]
        self._sizes = [int(np.prod(s)) for s in self._shapes]
        self._data_shape = (max_replay_size, sum(self._sizes))
        self._sample_batch_size = sample_batch_size
        self._device = torch.device(device)

    def init(self, generator: torch.Generator) -> ReplayBufferState:
        """An empty buffer; `generator` (on the buffer's device) draws the
        uniform sampler's indices."""
        return ReplayBufferState(
            data=torch.zeros(self._data_shape, dtype=torch.float32, device=self._device),
            current_position=0, current_size=0, generator=generator)

    def flatten(self, samples: Sample) -> Tensor:
        """A batch of samples [n, ...] as rows [n, dim]."""
        leaves = _leaves(samples)
        n = leaves[0].shape[0]
        return torch.cat([leaf.reshape(n, -1).to(torch.float32) for leaf in leaves], dim=1)

    def unflatten(self, flat: Tensor) -> Sample:
        """Rows [n, dim] as a batch of samples [n, ...]."""
        n = flat.shape[0]
        parts = torch.split(flat, self._sizes, dim=1)
        return _rebuild(self._dummy, iter(p.reshape((n,) + s) for p, s in zip(parts, self._shapes)))

    def insert(self, state: ReplayBufferState, samples: Sample) -> ReplayBufferState:
        """Appends a batch of samples, evicting the oldest on overflow.
        Where the batch would run past the end, the ring is first rolled
        so that it fits after the cursor, as the JAX buffer rolls it."""
        update = self.flatten(samples)
        data = state.data
        n, size = update.shape[0], data.shape[0]
        if n > size:
            raise ValueError(f"batch of {n} samples exceeds max replay size {size}")
        position = state.current_position
        roll = min(0, size - position - n)
        if roll:
            data = torch.roll(data, roll, dims=0)
        position += roll
        data[position:position + n] = update
        return dataclasses.replace(state, data=data, current_position=(position + n) % size,
                                   current_size=min(state.current_size + n, size))

    def sample(self, state: ReplayBufferState) -> Tuple[ReplayBufferState, Sample]:
        raise NotImplementedError


class Queue(QueueBase[Sample], Generic[Sample]):
    """FIFO sampling: the oldest `sample_batch_size` samples, then dequeued.
    Rows past the newest come back as zeros."""

    def sample(self, state: ReplayBufferState) -> Tuple[ReplayBufferState, Sample]:
        first = state.current_position - state.current_size
        idx = torch.arange(self._sample_batch_size, device=state.data.device) + first
        flat = state.data[idx.remainder(state.data.shape[0])]
        flat = flat * (idx < state.current_position).unsqueeze(1)
        taken = min(self._sample_batch_size, state.current_size)
        return (dataclasses.replace(state, current_size=state.current_size - taken),
                self.unflatten(flat))


class UniformSamplingQueue(QueueBase[Sample], Generic[Sample]):
    """Uniform sampling with replacement over the live window
    [position - size, position), wrapped."""

    def indices(self, state: ReplayBufferState) -> Tensor:
        """The next sample's row indices, drawn from the state's generator."""
        return torch.randint(state.current_position - state.current_size,
                             state.current_position, (self._sample_batch_size,),
                             generator=state.generator, device=state.data.device)

    def sample_at(self, state: ReplayBufferState, idx: Tensor) -> Sample:
        """The samples at rows `idx` (wrapped)."""
        return self.unflatten(state.data[idx.remainder(state.data.shape[0])])

    def sample(self, state: ReplayBufferState) -> Tuple[ReplayBufferState, Sample]:
        return state, self.sample_at(state, self.indices(state))
