"""v2 environment registry (`brax_tpu/v2/envs/__init__.py`).

Ported so far: ant.  The other v2 envs are queued in ROADMAP.md (queue A
item 11).
"""

from __future__ import annotations

from typing import Optional

from brax_torch.v2.envs import wrappers
from brax_torch.v2.envs.ant import Ant
from brax_torch.v2.envs.env import Env, PipelineEnv, State, Wrapper

_envs = {"ant": Ant}


def create(env_name: str, episode_length: int = 1000, action_repeat: int = 1,
           auto_reset: bool = True, batch_size: Optional[int] = None, device="cuda",
           use_kernel: bool = True, **kwargs) -> Env:
    """A batched v2 Env on `device` with the standard wrapper stack.

    use_kernel=True (the default) steps through `generalized.kernels.gen_step`
    (the CUDA kernel on a CUDA device, its plain version on the CPU); False
    runs `pipeline.step` per frame.
    """
    if env_name not in _envs:
        raise NotImplementedError(
            f"v2 env {env_name!r} is not ported yet; brax_torch.v2 has {sorted(_envs)} "
            "(see ROADMAP.md, queue A item 11)")
    env = _envs[env_name](batch_size=batch_size or 1, device=device, use_kernel=use_kernel,
                          **kwargs)
    if episode_length is not None:
        env = wrappers.EpisodeWrapper(env, episode_length, action_repeat)
    if batch_size:
        env = wrappers.VmapWrapper(env, batch_size)
    if auto_reset:
        env = wrappers.AutoResetWrapper(env)
    return env
