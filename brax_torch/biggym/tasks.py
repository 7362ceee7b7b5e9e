"""Goal-oriented task tracks over registered components.

Counterpart of `brax_tpu/biggym/tasks.py`.  Each task factory takes a
component name and returns an env constructor built on the port's composer,
called as make(batch_size=..., device=..., **composer.create's kwargs).  A
match task's env has one agent group per participant, so its reward is
(N, 2).
"""

from __future__ import annotations

from typing import Callable


def race(component: str) -> Callable:
    """Single-agent: run in +x as fast as possible."""

    def make(**kwargs):
        from brax_torch import composer

        return composer.create(
            components=dict(
                agent1=dict(
                    component=component,
                    reward_fns=dict(
                        race=dict(reward_type="forward_velocity", weight=1.0),
                        ctrl=dict(reward_type="ctrl_cost", weight=0.01),
                    ),
                ),
            ),
            **kwargs,
        )

    return make


def chase(component: str) -> Callable:
    """Symmetric two-agent: each is rewarded for closing distance."""

    def make(**kwargs):
        from brax_torch import composer

        return composer.create(
            components=dict(
                agent1=dict(component=component, pos=(0.0, 2.0, 0.0)),
                agent2=dict(component=component, pos=(0.0, -2.0, 0.0)),
            ),
            edges={
                "agent1__agent2": dict(
                    collide_type="root",
                    reward_fns=dict(chase=dict(reward_type="chase")),
                )
            },
            agent_groups=dict(
                agent1=dict(action_agents=("agent1",), reward_names=("chase__agent1__agent2",)),
                agent2=dict(action_agents=("agent2",), reward_names=("chase__agent1__agent2",)),
            ),
            **kwargs,
        )

    return make


def sumo(component: str) -> Callable:
    """Symmetric two-agent contact task: push the opponent away from center."""

    def make(**kwargs):
        from brax_torch import composer

        return composer.create(
            components=dict(
                agent1=dict(component=component, pos=(0.0, 1.5, 0.0)),
                agent2=dict(component=component, pos=(0.0, -1.5, 0.0)),
            ),
            edges={
                "agent1__agent2": dict(
                    collide_type="full",
                    reward_fns=dict(push=dict(reward_type="distance", weight=-1.0)),
                )
            },
            agent_groups=dict(
                agent1=dict(action_agents=("agent1",), reward_names=("push__agent1__agent2",)),
                agent2=dict(action_agents=("agent2",), reward_names=("push__agent1__agent2",)),
            ),
            **kwargs,
        )

    return make


def get_task_env_name(task_name: str, comp_name: str) -> str:
    return f"{task_name}_{comp_name}"


def get_match_env_name(task_name: str, comp1: str, comp2: str) -> str:
    """match_<task>__<c1>__<c2>."""
    return f"match_{task_name}__{comp1}__{comp2}"


def race_ma(component: str, opponent: str = "ant", opponent_params=None,
            **component_params) -> Callable:
    """Two agents racing side by side, each rewarded for its own +x speed."""

    def make(**kwargs):
        from brax_torch import composer

        return composer.create(
            components=dict(
                agent1=dict(
                    component=component,
                    component_params=component_params or {},
                    pos=(0.0, 1.5, 0.0),
                    reward_fns=dict(race=dict(reward_type="forward_velocity", weight=1.0)),
                ),
                agent2=dict(
                    component=opponent,
                    component_params=opponent_params or {},
                    pos=(0.0, -1.5, 0.0),
                    reward_fns=dict(race=dict(reward_type="forward_velocity", weight=1.0)),
                ),
            ),
            agent_groups=dict(
                agent1=dict(action_agents=("agent1",), reward_names=("race__agent1",)),
                agent2=dict(action_agents=("agent2",), reward_names=("race__agent2",)),
            ),
            **kwargs,
        )

    return make


def _ma_desc_task(task: str, main_first: bool) -> Callable:
    """A match factory backed by `composer.envs.ma_descs`: the contributed
    component against a chosen opponent, the component first
    (`main_first`) or second."""

    def factory(component: str, opponent: str = "ant", opponent_params=None,
                **component_params) -> Callable:
        def make(**kwargs):
            from brax_torch import composer
            from brax_torch.composer.envs import ma_descs

            main, other = (component, opponent) if main_first else (opponent, component)
            mp, op = ((component_params or None, opponent_params) if main_first
                      else (opponent_params, component_params or None))
            desc = ma_descs.create_desc(main_agent=main, other_agent=other,
                                        main_agent_params=mp, other_agent_params=op, task=task)
            return composer.create(**{**desc, **kwargs})

        return make

    return factory


# prey escapes; predator catches
onigokko_prey = _ma_desc_task("chase", main_first=True)
onigokko_predator = _ma_desc_task("chase", main_first=False)
sumo_match = _ma_desc_task("sumo", main_first=True)


TASKS = {
    "race": race,
    "chase": chase,
    "sumo": sumo,
}
# match tracks take (component, opponent=..., opponent_params=...)
MATCH_TASKS = {
    "race_ma": race_ma,
    "sumo": sumo_match,
    "onigokko_prey": onigokko_prey,
    "onigokko_predator": onigokko_predator,
}
SYMMETRIC_MA_TASKS = ("race_ma", "sumo")
ASYMMETRIC_MA_TASKS = ("onigokko_prey", "onigokko_predator")
