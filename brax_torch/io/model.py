"""Policy parameter save/load.

Counterpart of `brax_tpu/io/model.py`: a pickle of the params' nested
structure.  Every tensor is moved to the CPU and detached before it is
pickled, so that a file written on the card loads on a machine without
one; `load_params` returns the same structure, its tensors on the CPU
(`to_device` moves them on).
"""

import dataclasses
import pickle
from typing import Any

import torch

from brax_torch.io import file


def to_device(tree: Any, device) -> Any:
    """`tree` with every tensor detached and on `device`; dicts, lists,
    tuples, namedtuples and dataclasses keep their types."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: to_device(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return type(tree)((k, to_device(v, device)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def save_params(path: str, params: Any):
    """Saves parameters (pickle), their tensors moved to the CPU."""
    with file.File(path, "wb") as fout:
        fout.write(pickle.dumps(to_device(params, "cpu")))


def load_params(path: str) -> Any:
    """Loads parameters (pickle)."""
    with file.File(path, "rb") as fin:
        return pickle.loads(fin.read())
