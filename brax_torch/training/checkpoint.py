"""Full-state training checkpoints for the PPO and SAC trainers.

Counterpart of the JAX trainers' orbax checkpoints
(`brax_tpu/training/agents/ppo/train.py:383-409,508-515`,
`sac/train.py:408-430,528-540`): after each evaluation a trainer given
`checkpoint_dir` writes its whole learner state with `torch.save` into
`<checkpoint_dir>/step_<env steps, 12 digits>`, and a run given the same
directory resumes from its newest `step_*`; `restore_checkpoint_path`
names a checkpoint to resume from instead.

A checkpoint is a dict of plain containers and CPU tensors, loaded with
`torch.load(weights_only=True)`: the env-step counter, the parameters
({group: {name: tensor}}), the optimizers' `state_dict`s, the observation
normaliser's four tensors and the trainer's `torch.Generator` states.
Restoring copies them into the trainer's own tensors, optimizers and
generators, bit for bit, and leaves in `last_restored` a snapshot of that
state taken right after the copy, for a check of a resume to compare with
the checkpoint.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from brax_torch.io import model
from brax_torch.training import running_statistics

Tensor = torch.Tensor

# `state(...)` of the learner right after the newest restore in this process
last_restored: Optional[Dict[str, Any]] = None


def restore_path(checkpoint_dir: Optional[str],
                 restore_checkpoint_path: Optional[str]) -> Optional[str]:
    """`restore_checkpoint_path` if given, else the newest `step_*` in
    `checkpoint_dir`, else None."""
    if restore_checkpoint_path or not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return restore_checkpoint_path
    steps = sorted(d for d in os.listdir(checkpoint_dir) if d.startswith("step_"))
    return os.path.join(os.path.abspath(checkpoint_dir), steps[-1]) if steps else None


def state(env_steps: int, params: Mapping[str, Mapping[str, Tensor]],
          optimizers: Mapping[str, torch.optim.Optimizer],
          normalizer: running_statistics.RunningStatisticsState,
          generators: Mapping[str, torch.Generator]) -> Dict[str, Any]:
    """A snapshot of a learner's state, its tensors copied to the CPU."""
    cpu = lambda t: t.detach().to("cpu", copy=True)
    return {
        "env_steps": int(env_steps),
        "params": {group: {k: cpu(v) for k, v in p.items()} for group, p in params.items()},
        "optimizers": {name: model.to_device(copy.deepcopy(opt.state_dict()), "cpu")
                       for name, opt in optimizers.items()},
        "normalizer": {f.name: cpu(getattr(normalizer, f.name))
                       for f in dataclasses.fields(normalizer)},
        "generators": {name: g.get_state() for name, g in generators.items()},
    }


def save(checkpoint_dir: str, snapshot: Dict[str, Any]) -> str:
    """Writes `snapshot` to `<checkpoint_dir>/step_<env steps:012d>`."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(checkpoint_dir), f"step_{snapshot['env_steps']:012d}")
    tmp = path + ".tmp"
    torch.save(snapshot, tmp)
    os.replace(tmp, path)
    return path


def load(path: str) -> Dict[str, Any]:
    """A checkpoint, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def restore(snapshot: Mapping[str, Any], params: Mapping[str, Mapping[str, Tensor]],
            optimizers: Mapping[str, torch.optim.Optimizer],
            generators: Mapping[str, torch.Generator], device
            ) -> Tuple[running_statistics.RunningStatisticsState, int]:
    """Copies a checkpoint into `params`' tensors (in place), the
    optimizers and the generators, and a snapshot of them into
    `last_restored`; returns (normaliser, env steps)."""
    global last_restored
    for group, p in params.items():
        saved = snapshot["params"][group]
        if sorted(saved) != sorted(p):
            raise ValueError(f"checkpoint params {group!r}: {sorted(saved)} != {sorted(p)}")
        for k, v in p.items():
            v.copy_(saved[k])
    for name, opt in optimizers.items():
        opt.load_state_dict(snapshot["optimizers"][name])
    for name, g in generators.items():
        g.set_state(snapshot["generators"][name])
    normalizer = running_statistics.RunningStatisticsState(
        **{k: v.to(device) for k, v in snapshot["normalizer"].items()})
    env_steps = int(snapshot["env_steps"])
    last_restored = state(env_steps, params, optimizers, normalizer, generators)
    return normalizer, env_steps


def equal(a: Any, b: Any) -> bool:
    """Whether two checkpoints (or parts) hold the same values, tensors bit
    for bit (same dtype, shape and bytes)."""
    if isinstance(a, Tensor) or isinstance(b, Tensor):
        return (isinstance(a, Tensor) and isinstance(b, Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and bool((a.cpu().reshape(-1).view(torch.uint8)
                          == b.cpu().reshape(-1).view(torch.uint8)).all()))
    if isinstance(a, dict) and isinstance(b, dict):
        return sorted(a, key=str) == sorted(b, key=str) and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    return a == b
