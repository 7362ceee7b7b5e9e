"""Registry of semantic observation indices per environment.

A copy of `brax_tpu/braxlines/obs_indices.py` (data, kept here so that the
port imports nothing of `brax_tpu`).  Skill-discovery (VGCRL/DIAYN) and
goal-reaching algorithms need to know which observation dimensions carry,
for example, the root velocity of a given env; `get_indices(env_name,
type)` looks them up.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# {indices_type: {env_name: (obs_indices, obs_scale)}}
OBS_INDICES: Dict[str, Dict[str, Tuple[Sequence[int], float]]] = {
    "vel": {
        # root x/y velocity dims of each env's observation vector
        # layouts: qpos = [z, rot, joint_angles], then qvel = [vel, ang, ...]
        "fast": ((0,), 5.0),
        "ant": ((13, 14), 10.0),  # 1 + 4 + 8 joint dofs
        "halfcheetah": ((9,), 10.0),  # 1 + 2 (planar rot) + 6 joint dofs
        "humanoid": ((22, 23), 10.0),  # 1 + 4 + 17 joint dofs
    },
}


def register_indices(
    env_name: str,
    indices_type: str,
    indices: Sequence[int],
    scale: float = 1.0,
):
    OBS_INDICES.setdefault(indices_type, {})[env_name] = (
        tuple(indices),
        scale,
    )


def get_indices(env_name: str, indices_type: str = "vel"):
    """Returns (obs_indices, obs_scale); raises KeyError with the known
    set if unregistered."""
    try:
        return OBS_INDICES[indices_type][env_name]
    except KeyError:
        known = sorted(OBS_INDICES.get(indices_type, {}))
        raise KeyError(
            f"no '{indices_type}' obs indices for {env_name}; known: {known}"
        ) from None
