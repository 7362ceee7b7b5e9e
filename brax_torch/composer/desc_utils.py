"""Desc-dictionary utilities: dotted-path edits for sweeps and variants.

A copy of `brax_tpu/composer/desc_utils.py` (the port imports nothing of
`brax_tpu`): `edit_desc` applies dotted-path assignments to a deep copy of
an env description, the mechanism behind the composer's task variants.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

BASIC_DESC_KEYS = ("components", "edges", "global_options", "agent_groups")


def edit_desc(env_desc: Dict[str, Any], desc_edits: Dict[str, Any]):
    """Returns a deep copy of env_desc with dotted-path assignments applied:
    {'components.agent1.reward_fns.goal.scale': 2.0} sets
    env_desc['components']['agent1']['reward_fns']['goal']['scale']."""
    env_desc = copy.deepcopy(env_desc)
    for key in BASIC_DESC_KEYS:
        env_desc.setdefault(key, {})
    for key_str, value in desc_edits.items():
        keys = key_str.split(".")
        d = env_desc
        for key in keys[:-1]:
            assert key in d, f"{key!r} not in {sorted(d)}"
            d = d[key]
        d[keys[-1]] = value
    return env_desc
