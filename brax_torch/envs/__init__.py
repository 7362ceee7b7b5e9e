"""Environment registry.

Counterpart of `brax_tpu/envs/__init__.py`.  Only ant is ported (with the
fork's default of contact-force observations); the other environments are
queued in ROADMAP.md.
"""

from __future__ import annotations

import functools
from typing import Optional

from brax_torch.envs import wrappers
from brax_torch.envs.ant import Ant
from brax_torch.envs.base import Env, State, Wrapper

_envs = {
    "ant": functools.partial(Ant, use_contact_forces=True),
}


def create(
    env_name: str,
    episode_length: int = 1000,
    action_repeat: int = 1,
    auto_reset: bool = True,
    batch_size: Optional[int] = None,
    eval_metrics: bool = False,
    device="cuda",
    **kwargs,
) -> Env:
    """Creates a batched Env on `device` with the given wrapper stack."""
    if env_name not in _envs:
        raise NotImplementedError(
            f"env {env_name!r} is not ported yet; brax_torch has {sorted(_envs)} "
            "(see ROADMAP.md, queue A item 10)"
        )
    env = _envs[env_name](batch_size=batch_size or 1, device=device, **kwargs)
    if episode_length is not None:
        env = wrappers.EpisodeWrapper(env, episode_length, action_repeat)
    if batch_size:
        env = wrappers.VmapWrapper(env, batch_size)
    if auto_reset:
        env = wrappers.AutoResetWrapper(env)
    if eval_metrics:
        env = wrappers.EvalWrapper(env)
    return env
