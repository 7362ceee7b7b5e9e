"""Environment API: State, Env, Wrapper, batch-first.

Counterpart of `brax_tpu/envs/base.py`.  An env is built for a fixed batch
size and device; `reset(rng)` draws the whole batch from a `torch.Generator`
and `step(state, action)` steps it with one call.
"""

from __future__ import annotations

import abc
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from brax_torch.sim import builder, initial
from brax_torch.sim.config import Config
from brax_torch.sim.types import QP, Tensor


@dataclass
class State:
    """Environment state for training and inference; tensors lead with N."""

    qp: QP
    obs: Tensor
    reward: Tensor
    done: Tensor
    metrics: Dict[str, Tensor] = field(default_factory=dict)
    info: Dict[str, Any] = field(default_factory=dict)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


class Env(abc.ABC):
    """API for driving a batch of physics systems."""

    def __init__(self, config: Optional[Config], batch_size: int = 1, device="cuda"):
        self.batch_size = batch_size
        self.device = torch.device(device)
        if config is not None:
            self.sys, self.art = builder.build(config, device=self.device)

    @abc.abstractmethod
    def reset(self, rng: torch.Generator) -> State:
        """Resets every env of the batch to an initial state."""

    @abc.abstractmethod
    def step(self, state: State, action: Tensor) -> State:
        """Runs one timestep of every env's dynamics."""

    def default_qp(self, default_index: int = 0, joint_angle=None, joint_velocity=None) -> QP:
        return initial.default_qp(self.art, default_index, joint_angle, joint_velocity,
                                  device=self.device)

    def default_angle(self, default_index: int = 0) -> Tensor:
        return initial.default_angle(self.art, default_index, device=self.device)

    @property
    def observation_size(self) -> int:
        env = self.unwrapped
        rng = torch.Generator(device=env.device).manual_seed(0)
        return env.reset(rng).obs.shape[-1]

    @property
    def action_size(self) -> int:
        return self.sys.num_joint_dof + self.sys.num_forces_dof

    @property
    def unwrapped(self) -> "Env":
        return self


class Wrapper(Env):
    """Wraps an environment for modular transformations."""

    def __init__(self, env: Env):
        super().__init__(config=None, batch_size=env.batch_size, device=env.device)
        self.env = env

    def reset(self, rng: torch.Generator) -> State:
        return self.env.reset(rng)

    def step(self, state: State, action: Tensor) -> State:
        return self.env.step(state, action)

    @property
    def observation_size(self) -> int:
        return self.env.observation_size

    @property
    def action_size(self) -> int:
        return self.env.action_size

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped

    def __getattr__(self, name):
        if name in ("__setstate__", "env"):
            raise AttributeError(name)
        return getattr(self.env, name)
