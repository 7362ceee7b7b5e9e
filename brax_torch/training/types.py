"""Shared training types, batch-first.

Counterpart of `brax_tpu/training/types.py`.  A `Transition` holds tensors
whose leading dims are the batch (and time, once unrolls are stacked);
`extras` is a nested dict of such tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Tuple

import torch

Tensor = torch.Tensor
Params = Any
Metrics = Mapping[str, Any]
Observation = Tensor
Action = Tensor
Extra = Mapping[str, Any]
PolicyParams = Any
PreprocessorParams = Any


class Transition(NamedTuple):
    """Container for a SARS'-style transition."""

    observation: Tensor
    action: Tensor
    reward: Tensor
    discount: Tensor
    next_observation: Tensor
    extras: Dict[str, Any] = {}


Policy = Callable[[Observation, torch.Generator], Tuple[Action, Extra]]
PreprocessObservationFn = Callable[[Observation, PreprocessorParams], Tensor]


def identity_observation_preprocessor(observation: Observation,
                                      preprocessor_params: PreprocessorParams):
    del preprocessor_params
    return observation


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts and NamedTuples (a Transition)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*[tree_map(fn, *xs) for xs in zip(tree, *rest)])
    return fn(tree, *rest)


def tree_stack(trees, dim: int = 0):
    """Stacks a list of same-shaped trees along a new dim."""
    return tree_map(lambda *xs: torch.stack(xs, dim=dim), *trees)
