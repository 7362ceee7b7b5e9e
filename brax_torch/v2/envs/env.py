"""Environment API over the v2 pipelines, batch-first.

Counterpart of `brax_tpu/v2/envs/env.py`.  A PipelineEnv steps its whole
env batch `n_frames` physics frames per `step`.  With the generalized
backend it takes one of two routes:

- the kernel route (`use_kernel=True`, the default), the counterpart of the
  JAX package with `generalized.kernels.enable(True)`: one call of
  `kernels.gen_step` for all frames, which launches the CUDA kernel on CUDA
  tensors and runs its plain version on CPU tensors; where autograd
  records the step, through `kernels.GenStep`, whose backward is that of
  the pipeline's steps (`kernels.kernel_step`);
- `use_kernel=False`: `pipeline.step` once per frame.

"spring" and "positional" are not ported yet and raise.
"""

from __future__ import annotations

import abc
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from brax_torch.v2.base import System, Tensor
from brax_torch.v2.generalized import kernels
from brax_torch.v2.generalized import pipeline as g_pipeline
from brax_torch.v2.generalized.base import State as PipelineState


@dataclass
class State:
    """Environment state for training and inference; tensors lead with N."""

    pipeline_state: PipelineState
    obs: Tensor
    reward: Tensor
    done: Tensor
    metrics: Dict[str, Tensor] = field(default_factory=dict)
    info: Dict[str, Any] = field(default_factory=dict)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


class Env(abc.ABC):
    """API for driving a batch of physics systems."""

    batch_size: int
    device: torch.device

    @abc.abstractmethod
    def reset(self, rng: torch.Generator) -> State:
        """Resets every env of the batch."""

    @abc.abstractmethod
    def step(self, state: State, action: Tensor) -> State:
        """Runs one timestep of every env."""

    @property
    def observation_size(self) -> int:
        env = self.unwrapped
        return env.reset(torch.Generator(device=env.device).manual_seed(0)).obs.shape[-1]

    @property
    @abc.abstractmethod
    def action_size(self) -> int:
        ...

    @property
    def unwrapped(self) -> "Env":
        return self


class PipelineEnv(Env):
    """Drives a v2 System through a physics pipeline."""

    def __init__(self, sys: System, backend: str = "generalized", n_frames: int = 1,
                 batch_size: int = 1, device="cuda", use_kernel: bool = True):
        if backend != "generalized":
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet; brax_torch.v2 has 'generalized' "
                "(see ROADMAP.md, queue A item 7)")
        self.device = torch.device(device)
        self.sys = sys.to(self.device)
        self.batch_size = batch_size
        self._n_frames = n_frames
        self._use_kernel = use_kernel
        if self._use_kernel:
            missing = kernels.unsupported_features(self.sys)
            if missing:
                raise NotImplementedError(
                    "the generalized kernel does not cover: " + ", ".join(missing)
                    + " (see ROADMAP.md, queue B item 2)")

    def pipeline_init(self, q: Tensor, qd: Tensor) -> PipelineState:
        return g_pipeline.init(self.sys, q, qd)

    def pipeline_step(self, pipeline_state: PipelineState, action: Tensor) -> PipelineState:
        """n_frames physics frames: one kernel call, or n_frames pipeline steps."""
        if self._use_kernel:
            return kernels.kernel_step(self.sys, pipeline_state, action, self._n_frames)
        for _ in range(self._n_frames):
            pipeline_state = g_pipeline.step(self.sys, pipeline_state, action)
        return pipeline_state

    @property
    def dt(self) -> Tensor:
        return self.sys.dt * self._n_frames

    @property
    def action_size(self) -> int:
        return self.sys.act_size()

    @property
    def backend(self) -> str:
        return "generalized"


class Wrapper(Env):
    """Wraps an environment for modular transformations."""

    def __init__(self, env: Env):
        self.env = env
        self.batch_size = env.batch_size
        self.device = env.device

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
