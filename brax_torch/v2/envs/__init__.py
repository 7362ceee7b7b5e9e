"""v2 environment registry (`brax_tpu/v2/envs/__init__.py`).

Ported: ant, halfcheetah, hopper, inverted_double_pendulum,
inverted_pendulum, reacher and walker2d.  humanoid raises: its System is
past what one thread per env of the generalized kernel holds (ROADMAP.md,
queue B item 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Type

from brax_torch.v2.envs import wrappers
from brax_torch.v2.envs.ant import Ant
from brax_torch.v2.envs.env import Env, PipelineEnv, State, Wrapper
from brax_torch.v2.envs.halfcheetah import Halfcheetah
from brax_torch.v2.envs.hopper import Hopper
from brax_torch.v2.envs.inverted_double_pendulum import InvertedDoublePendulum
from brax_torch.v2.envs.inverted_pendulum import InvertedPendulum
from brax_torch.v2.envs.reacher import Reacher
from brax_torch.v2.envs.walker2d import Walker2d

_envs: Dict[str, Type[PipelineEnv]] = {
    "ant": Ant,
    "halfcheetah": Halfcheetah,
    "hopper": Hopper,
    "inverted_double_pendulum": InvertedDoublePendulum,
    "inverted_pendulum": InvertedPendulum,
    "reacher": Reacher,
    "walker2d": Walker2d,
}

_NOT_PORTED = {
    "humanoid": "humanoid (nd 23, ~80 constraint rows) needs the generalized kernel's "
                "redesign first, one thread per env does not hold it (see ROADMAP.md, "
                "queue A item 11 and queue B item 3)",
}


def get_environment(env_name: str, **kwargs) -> Env:
    """The bare env `env_name`; kwargs go to its constructor (batch_size,
    device, use_kernel and the env's own)."""
    if env_name not in _envs:
        raise NotImplementedError(_NOT_PORTED.get(
            env_name, f"v2 env {env_name!r} is not ported; brax_torch.v2 has {sorted(_envs)}"))
    return _envs[env_name](**kwargs)


def register_environment(env_name: str, env_class: Type[PipelineEnv]) -> None:
    _envs[env_name] = env_class


def create(env_name: str, episode_length: int = 1000, action_repeat: int = 1,
           auto_reset: bool = True, batch_size: Optional[int] = None, device="cuda",
           use_kernel: bool = True, **kwargs) -> Env:
    """A batched v2 Env on `device` with the standard wrapper stack.

    use_kernel=True (the default) steps through `generalized.kernels.gen_step`
    (the CUDA kernel on a CUDA device, its plain version on the CPU); False
    runs `pipeline.step` per frame.
    """
    env = get_environment(env_name, batch_size=batch_size or 1, device=device,
                          use_kernel=use_kernel, **kwargs)
    if episode_length is not None:
        env = wrappers.EpisodeWrapper(env, episode_length, action_repeat)
    if batch_size:
        env = wrappers.VmapWrapper(env, batch_size)
    if auto_reset:
        env = wrappers.AutoResetWrapper(env)
    return env
