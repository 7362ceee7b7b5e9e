"""Environment registry.

Counterpart of `brax_tpu/envs/__init__.py`.  Ported so far: ant (with the
fork's default of contact-force observations), the humanoids ("humanoid" is
the fork's humanoid_new, as in the JAX registry; "humanoid_legacy",
"humanoidstandup"), halfcheetah and pusher (whose scenes have two-way
capsule-capsule contacts), inverted_pendulum, inverted_double_pendulum and
swimmer (thruster forces), reacherangle (angle actuators), reacher, grasp
(angle actuators on spherical joints, one-way capsule-capsule contacts
against its frozen palm), acrobot, ur5e and the trainer test env fast; the
other environments are queued in ROADMAP.md.
"""

from __future__ import annotations

import functools
from typing import Optional

from brax_torch.envs import wrappers
from brax_torch.envs.acrobot import Acrobot
from brax_torch.envs.ant import Ant
from brax_torch.envs.base import Env, State, Wrapper
from brax_torch.envs.fast import Fast
from brax_torch.envs.grasp import Grasp
from brax_torch.envs.halfcheetah import Halfcheetah
from brax_torch.envs.humanoid import Humanoid, HumanoidLegacy
from brax_torch.envs.humanoid_standup import HumanoidStandup
from brax_torch.envs.inverted_double_pendulum import InvertedDoublePendulum
from brax_torch.envs.inverted_pendulum import InvertedPendulum
from brax_torch.envs.pusher import Pusher
from brax_torch.envs.reacher import Reacher
from brax_torch.envs.reacherangle import ReacherAngle
from brax_torch.envs.swimmer import Swimmer
from brax_torch.envs.ur5e import Ur5e

_envs = {
    "acrobot": Acrobot,
    "ant": functools.partial(Ant, use_contact_forces=True),
    "fast": Fast,
    "grasp": Grasp,
    "halfcheetah": Halfcheetah,
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
            "(see ROADMAP.md, queue A items 4-5 and queue B item 1)"
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
