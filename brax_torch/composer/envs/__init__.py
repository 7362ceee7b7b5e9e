"""Composer env-description registry.

Counterpart of `brax_tpu/composer/envs/__init__.py`: `ENV_DESCS` maps task
names to descs (dicts) or desc factories; single-agent tasks come from
sa_descs, N-agent tasks from ma_descs.  `create_env` builds any of them at
a batch size and device, batch-first.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from brax_torch.composer import desc_utils
from brax_torch.composer.envs import ma_descs, sa_descs
from brax_torch.composer.envs.ma_descs import create_desc

ENV_DESCS: Dict[str, Any] = {**sa_descs.ENV_DESCS, **ma_descs.ENV_DESCS}


def list_env():
    return sorted(ENV_DESCS)


def exists(env_name: str) -> bool:
    return env_name in ENV_DESCS


def create_env(
    task: str = "ant_run",
    desc_edits: Optional[Dict[str, Any]] = None,
    episode_length: Optional[int] = 1000,
    action_repeat: int = 1,
    batch_size=None,
    auto_reset: bool = True,
    device="cuda",
    **desc_kwargs,
):
    """Builds a wrapped environment from any registered desc (single- or
    multi-agent), with optional dotted-path desc_edits (the sweep
    mechanism)."""
    from brax_torch import composer

    entry = ENV_DESCS[task]
    desc = entry(**desc_kwargs) if callable(entry) else copy.deepcopy(entry)
    if desc_edits:
        desc = desc_utils.edit_desc(desc, desc_edits)
    return composer.create(
        components=desc["components"],
        edges=desc.get("edges") or None,
        agent_groups=desc.get("agent_groups") or None,
        global_options=desc.get("global_options") or None,
        episode_length=episode_length,
        action_repeat=action_repeat,
        batch_size=batch_size,
        auto_reset=auto_reset,
        device=device,
    )


def create_ma_env(task: str = "chase", episode_length=1000, action_repeat=1,
                  batch_size=None, auto_reset=True, device="cuda", **desc_kwargs):
    """Builds a multi-agent composed env from a registered task desc."""
    return create_env(
        task=task,
        episode_length=episode_length,
        action_repeat=action_repeat,
        batch_size=batch_size,
        auto_reset=auto_reset,
        device=device,
        **desc_kwargs,
    )
