"""Environment registry.

Counterpart of `brax_tpu/envs/__init__.py`, with every env of the JAX
registry: ant (with the fork's default of contact-force observations), the
humanoids ("humanoid" is the fork's humanoid_new, as in the JAX registry;
"humanoid_legacy", "humanoidstandup"), halfcheetah and pusher (whose
scenes have two-way capsule-capsule contacts), hopper and walker2d,
inverted_pendulum, inverted_double_pendulum and swimmer (thruster forces),
reacherangle (angle actuators), reacher, grasp (angle actuators on
spherical joints, one-way capsule-capsule contacts against its frozen
palm), acrobot, ur5e, fetch (one-way box-plane contacts of its lower legs)
and the trainer test env fast.  `register` adds a factory under a name and
`create_fn` binds `create`'s arguments, as in the JAX registry.
`legacy_spring=True` switches ant, halfcheetah, humanoid_legacy,
humanoidstandup, inverted_pendulum, inverted_double_pendulum, reacher and
reacherangle to their legacy-spring scenes, as their JAX counterparts do;
the other envs take it and ignore it (humanoid, the fork's humanoid_new,
too).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

from brax_torch.envs import wrappers
from brax_torch.envs.acrobot import Acrobot
from brax_torch.envs.ant import Ant
from brax_torch.envs.base import Env, State, Wrapper
from brax_torch.envs.fast import Fast
from brax_torch.envs.fetch import Fetch
from brax_torch.envs.grasp import Grasp
from brax_torch.envs.halfcheetah import Halfcheetah
from brax_torch.envs.hopper import Hopper
from brax_torch.envs.humanoid import Humanoid, HumanoidLegacy
from brax_torch.envs.humanoid_standup import HumanoidStandup
from brax_torch.envs.inverted_double_pendulum import InvertedDoublePendulum
from brax_torch.envs.inverted_pendulum import InvertedPendulum
from brax_torch.envs.pusher import Pusher
from brax_torch.envs.reacher import Reacher
from brax_torch.envs.reacherangle import ReacherAngle
from brax_torch.envs.swimmer import Swimmer
from brax_torch.envs.ur5e import Ur5e
from brax_torch.envs.walker2d import Walker2d

_envs = {
    "acrobot": Acrobot,
    "ant": functools.partial(Ant, use_contact_forces=True),
    "fast": Fast,
    "fetch": Fetch,
    "grasp": Grasp,
    "halfcheetah": Halfcheetah,
    "hopper": Hopper,
    "humanoid": Humanoid,
    "humanoid_legacy": HumanoidLegacy,
    "humanoidstandup": HumanoidStandup,
    "inverted_double_pendulum": InvertedDoublePendulum,
    "inverted_pendulum": InvertedPendulum,
    "pusher": Pusher,
    "reacher": Reacher,
    "reacherangle": ReacherAngle,
    "swimmer": Swimmer,
    "ur5e": Ur5e,
    "walker2d": Walker2d,
}


def register(name: str, factory) -> None:
    """Adds an env factory, called as factory(batch_size=..., device=..., **kwargs)."""
    _envs[name] = factory


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
            f"env {env_name!r} is not registered; brax_torch has {sorted(_envs)}"
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


def create_fn(env_name: str, **kwargs) -> Callable[..., Env]:
    """`create` with env_name and kwargs bound."""
    return functools.partial(create, env_name, **kwargs)
