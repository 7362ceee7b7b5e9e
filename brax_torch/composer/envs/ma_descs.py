"""Multi-agent task descriptions: follow / chase / sumo over N agents.

A copy of `brax_tpu/composer/envs/ma_descs.py`: `create_desc` places N
agents on a circle and adds a task's rewards and agent groups (follow,
chase, sumo with its ring of frozen, non-colliding capsule segments).
Descs are plain nested dicts.
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Dict, Optional, Sequence

import numpy as onp
import torch

MAX_DIST = 20.0
MIN_DIST = 0.5


def merge_desc(desc1: Dict[str, Any], desc2: Dict[str, Any]):
    """Recursively merge desc2 into desc1 (ref composer_utils.merge_desc):
    dicts merge, tuples/lists extend, scalars must not conflict."""
    for k, v in desc2.items():
        if k not in desc1:
            desc1[k] = v
        elif isinstance(v, dict):
            merge_desc(desc1[k], v)
        elif isinstance(v, (tuple, list)):
            desc1[k] += v
        else:
            raise NotImplementedError(f"invalid merge {k}: {desc1[k]} {v}")
    return desc1


def get_n_agents_desc(
    agents: Sequence[str],
    agents_params: Optional[Sequence[Optional[dict]]] = None,
    init_r: float = 2.0,
) -> Dict[str, Any]:
    """Places N agents evenly on a circle of radius init_r; every pair gets
    a relative root-vector observer."""
    angles = onp.linspace(0, 2 * onp.pi, len(agents) + 1)
    agents_params = agents_params or [None] * len(agents)
    components, edges = {}, {}
    for i, (angle, agent, params) in enumerate(
        zip(angles[:-1], agents, agents_params)
    ):
        pos = (float(onp.cos(angle)) * init_r, float(onp.sin(angle)) * init_r, 0.0)
        components[f"agent{i}"] = dict(component=agent, pos=pos)
        if params:
            components[f"agent{i}"]["component_params"] = dict(params)
    for k1, k2 in itertools.combinations(sorted(components), 2):
        edges[f"{k1}__{k2}"] = dict(
            extra_observers=[dict(observer_type="root_vec", indices=(0, 1))]
        )
    return dict(components=components, edges=edges)


def add_follow(env_desc: Dict[str, Any], leader_vel: float = 3.0):
    """agent0 holds a target velocity; the others stay close to it."""
    agents = sorted(env_desc["components"])
    leader, followers = agents[0], agents[1:]
    components = {
        leader: dict(
            reward_fns=dict(
                goal=dict(
                    reward_type="root_goal",
                    sdcomp="vel",
                    indices=(0, 1),
                    offset=leader_vel + 2,
                    target_goal=(leader_vel, 0.0),
                )
            )
        )
    }
    agent_groups = {leader: dict(reward_agents=(leader,))}
    edges = {}
    for agent in followers:
        k1, k2 = sorted([agent, leader])
        edges[f"{k1}__{k2}"] = dict(
            reward_fns=dict(
                dist=dict(
                    reward_type="root_dist",
                    max_dist=MAX_DIST,
                    offset=MAX_DIST + 1,
                )
            )
        )
        agent_groups[agent] = dict(reward_names=(f"dist__{k1}__{k2}",))
    return merge_desc(
        env_desc, dict(agent_groups=agent_groups, components=components, edges=edges)
    )


def _run_reward(scale: float = 1.0):
    # ref get_run_reward: norm_reward of root planar vel with scale=-s,
    # i.e. a speed bonus
    return dict(reward_type="norm_velocity", indices=(0, 1), scale=-scale)


def add_chase(env_desc: Dict[str, Any]):
    """agent0 is prey, the rest are predators; catching (dist < MIN_DIST)
    terminates with a large bonus/penalty; everyone gets a speed bonus."""
    agents = sorted(env_desc["components"])
    agent_groups = {agent: {"reward_names": ()} for agent in agents}
    components = {agent: {"reward_fns": {}} for agent in agents}
    edges = {}
    prey, predators = agents[0], agents[1:]
    for agent in predators:
        k1, k2 = sorted([agent, prey])
        edges[f"{k1}__{k2}"] = dict(
            reward_fns=dict(
                chase=dict(
                    reward_type="root_dist",
                    offset=MAX_DIST + 1,
                    min_dist=MIN_DIST,
                    done_bonus=1000 * MAX_DIST,
                ),
                escape=dict(
                    reward_type="root_dist",
                    scale=-1,
                    max_dist=MAX_DIST,
                    done_bonus=1000 * MAX_DIST,
                ),
            )
        )
        agent_groups[prey]["reward_names"] += (f"escape__{k1}__{k2}",)
        agent_groups[agent]["reward_names"] += (f"chase__{k1}__{k2}",)
    for agent in agents:
        components[agent]["reward_fns"]["run"] = _run_reward()
        agent_groups[agent]["reward_names"] += (f"run__{agent}",)
    return merge_desc(
        env_desc, dict(agent_groups=agent_groups, edges=edges, components=components)
    )


def get_ring_components(
    name: str = "ring",
    num_segments: int = 4,
    radius: float = 3.0,
    thickness: Optional[float] = None,
    offset: Optional[Sequence[float]] = None,
) -> Dict[str, Any]:
    """Frozen, non-colliding capsule segments approximating a ring."""
    from brax_torch import maths

    offset = onp.asarray(offset or (0.0, 0.0, 0.0))
    thickness = thickness or radius / 40.0
    components = {}
    angles = onp.linspace(0, 2 * onp.pi, num_segments + 1)
    for i, angle in enumerate(angles[:-1]):
        seg_len = radius * onp.tan(onp.pi / num_segments)
        quat = maths.euler_to_quat(
            torch.tensor([90.0, float(onp.degrees(angle)), 0.0], dtype=torch.float32)
        )
        components[f"{name}{i}"] = dict(
            component="singleton",
            component_params=dict(
                size=(thickness, seg_len * 2), collider_type="capsule", no_obs=True
            ),
            pos=tuple(
                offset
                + onp.array(
                    [radius * onp.cos(angle), radius * onp.sin(angle), -seg_len]
                )
            ),
            quat=tuple(quat.numpy()),
            quat_origin=(0.0, 0.0, float(seg_len)),
            frozen=True,
            collide=False,
        )
    return components


def add_sumo(
    env_desc: Dict[str, Any],
    centering_scale: float = 1.0,
    control_scale: float = 0.1,
    draw_scale: float = 0.0,
    knocking_scale: float = 1.0,
    opp_scale: float = 1.0,
    ring_size: float = 3.0,
    win_bonus: float = 1.0,
):
    """agent0 (yokozuna) vs the rest (komusubi): push the opponent out of
    the ring; leaving the ring terminates with win/lose bonuses."""
    agents = sorted(env_desc["components"])
    agent_groups = {agent: {"reward_names": ()} for agent in agents}
    components = {agent: {"reward_fns": {}} for agent in agents}
    edges = {}
    yokozuna, komusubis = agents[0], agents[1:]
    for agent in komusubis:
        k1, k2 = sorted([agent, yokozuna])
        # edge comps resolve alphabetically: which='a' selects min(k1,k2)
        yoko_side = "a" if yokozuna == k1 else "b"
        komu_side = "b" if yoko_side == "a" else "a"
        edges[f"{k1}__{k2}"] = dict(
            reward_fns=dict(
                komu_win=dict(
                    reward_type="exp_center_dist", which=yoko_side,
                    max_dist=ring_size, done_bonus=win_bonus,
                    scale=-knocking_scale,
                ),
                komu_lose=dict(
                    reward_type="exp_center_dist", which=komu_side,
                    max_dist=ring_size, done_bonus=-win_bonus,
                    scale=centering_scale,
                ),
                yoko_win=dict(
                    reward_type="exp_center_dist", which=komu_side,
                    max_dist=ring_size, done_bonus=win_bonus,
                    scale=-knocking_scale,
                ),
                yoko_lose=dict(
                    reward_type="exp_center_dist", which=yoko_side,
                    max_dist=ring_size, done_bonus=-win_bonus,
                    scale=centering_scale,
                ),
                komu_move=dict(
                    reward_type="direction", which=komu_side, scale=opp_scale
                ),
                yoko_move=dict(
                    reward_type="direction", which=yoko_side, scale=opp_scale
                ),
            )
        )
        e = f"{k1}__{k2}"
        agent_groups[agent]["reward_names"] += (
            f"komu_win__{e}", f"komu_lose__{e}", f"komu_move__{e}",
        )
        agent_groups[yokozuna]["reward_names"] += (
            f"yoko_win__{e}", f"yoko_lose__{e}", f"yoko_move__{e}",
        )
    for agent in agents:
        components[agent]["reward_fns"].update(
            control=dict(reward_type="control_penalty", scale=control_scale),
            draw=dict(reward_type="constant", value=-draw_scale),
        )
        agent_groups[agent]["reward_names"] += (
            f"control__{agent}", f"draw__{agent}",
        )
    components.update(get_ring_components(radius=ring_size, num_segments=20))
    return merge_desc(
        env_desc, dict(agent_groups=agent_groups, edges=edges, components=components)
    )


TASK_MAP = dict(follow=add_follow, chase=add_chase, sumo=add_sumo)


def create_desc(
    main_agent: str = "ant",
    other_agent: str = "ant",
    main_agent_params: Optional[dict] = None,
    other_agent_params: Optional[dict] = None,
    num_agents: int = 2,
    task: str = "follow",
    init_r: float = 2.0,
    **kwargs,
) -> Dict[str, Any]:
    """Builds an N-agent task desc (ref create_desc :322-341)."""
    if main_agent_params or other_agent_params:
        agents_params = [main_agent_params] + [other_agent_params] * (num_agents - 1)
    else:
        agents_params = None
    env_desc = get_n_agents_desc(
        agents=[main_agent] + [other_agent] * (num_agents - 1),
        agents_params=agents_params,
        init_r=init_r,
    )
    return TASK_MAP[task](env_desc=env_desc, **kwargs)


ENV_DESCS = {k: functools.partial(create_desc, task=k) for k in TASK_MAP}
