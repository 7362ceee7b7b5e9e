"""Discriminators for skill discovery and adversarial imitation.

Counterpart of `brax_tpu/braxlines/discriminators.py`, batch-first:

- `SkillDiscriminator`: a p(z) prior and a q(z|s) posterior for
  empowerment / mutual-information skill learning (VGCRL family, DIAYN);
- `IRLDiscriminator`: a binary classifier (target vs policy data) with the
  GAIL / AIRL / FAIRL reward transforms.

Each MLP is the port's `networks.MLP` (swish), called with its parameters
as a name -> tensor mapping (`init` returns them), so that the fused MLP
kernels run it where they are enabled, as they run the PPO networks.  The
distributions are written out (diagonal normal, categorical, bernoulli
log-probabilities), as the JAX module writes them.  Draws take an explicit
`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from brax_torch.training import networks

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def _normal_log_prob(mean, scale, x):
    var = scale ** 2
    return torch.sum(-0.5 * ((x - mean) ** 2) / var - torch.log(torch.as_tensor(scale))
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def _bernoulli_log_prob(logits, labels):
    """log p(y) for y in {0, 1} under sigmoid(logits)."""
    return -torch.logaddexp(torch.zeros_like(logits), torch.where(labels > 0.5, -logits, logits))


def _mlp(in_size: int, layer_sizes: Sequence[int], device) -> networks.MLP:
    return networks.MLP(in_size, list(layer_sizes), activation=F.silu, device=device)


def _fresh(mlp: networks.MLP, generator: Optional[torch.Generator]) -> Params:
    """A fresh draw of the MLP's parameters, as leaf tensors of their own."""
    mlp.reset_parameters(generator)
    return {k: v.detach().clone() for k, v in mlp.named_parameters()}


@dataclasses.dataclass
class SkillDiscriminator:
    """q(z | s[obs_indices]) with a uniform or categorical skill prior.

    Variants: fixed_gcrl and gcrl (q by indexing), cdiayn (q an MLP, a
    continuous uniform prior) and diayn (q an MLP, a categorical prior).
    """

    obs_indices: Sequence[int]
    obs_scale: float = 1.0
    z_size: int = 2
    q_fn: str = "mlp"  # 'indexing' | 'mlp'
    dist_q: str = "normal"  # 'normal' | 'categorical'
    dist_p: str = "uniform"  # 'uniform' | 'categorical'
    q_scale: float = 1.0
    hidden: Tuple[int, ...] = (32, 32)
    logits_clip_range: float = 10.0
    nonnegative_reward: bool = True
    device: str = "cuda"

    def __post_init__(self):
        if self.q_fn == "mlp":
            self._model = _mlp(len(self.obs_indices), tuple(self.hidden) + (self.z_size,),
                               self.device)
        else:
            assert len(self.obs_indices) == self.z_size
            self._model = None
        if self.nonnegative_reward and self.dist_q == "normal":
            # offset so that rewards are >= 0 within ~3 sigma
            z = torch.zeros(self.z_size)
            self._ll_offset = -float(_normal_log_prob(z, torch.ones(self.z_size) * self.q_scale,
                                                      torch.ones(self.z_size) * self.q_scale * 3))
        elif self.nonnegative_reward:
            self._ll_offset = self.logits_clip_range
        else:
            self._ll_offset = 0.0

    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        if self._model is None:
            return {"empty": torch.zeros((), device=self.device)}
        return _fresh(self._model, generator)

    def sample_p(self, generator: torch.Generator, n: int) -> Tensor:
        """n skills z from the prior, (n, z_size)."""
        device = generator.device
        if self.dist_p == "uniform":
            u = torch.rand((n, self.z_size), generator=generator, device=device)
            return u * (2 * self.obs_scale) - self.obs_scale
        idx = torch.randint(0, self.z_size, (n,), generator=generator, device=device)
        return F.one_hot(idx, self.z_size).to(torch.float32)

    def q_params(self, params: Params, obs: Tensor) -> Tensor:
        """The posterior's parameters from (unaugmented) observations."""
        indexed = obs[..., list(self.obs_indices)]
        if self._model is None:
            return indexed
        return self._model(indexed, params)

    def ll_q(self, params: Params, obs: Tensor, z: Tensor) -> Tensor:
        """log q(z | s)."""
        out = self.q_params(params, obs)
        if self.dist_q == "normal":
            return _normal_log_prob(out, self.q_scale, z)
        logits = torch.clamp(out, -self.logits_clip_range, self.logits_clip_range)
        return torch.sum(torch.log_softmax(logits, dim=-1) * z, dim=-1)

    def reward(self, params: Params, obs: Tensor, z: Tensor) -> Tensor:
        """The empowerment reward: log q(z|s), plus the offset."""
        return self.ll_q(params, obs, z) + self._ll_offset

    def loss(self, params: Params, obs: Tensor, z: Tensor) -> Tensor:
        """The discriminator's loss: -log q(z|s) on visited states."""
        return -torch.mean(self.ll_q(params, obs, z))


@dataclasses.dataclass
class IRLDiscriminator:
    """A binary classifier over target vs on-policy data, and its reward."""

    input_size: int
    reward_type: str = "gail"  # 'gail' | 'gail2' | 'airl' | 'fairl'
    arch: Tuple[int, ...] = (32, 32)
    obs_indices: Optional[Sequence[int]] = None
    include_action: bool = False
    logits_clip_range: float = 10.0
    nonnegative_reward: bool = True
    target_data: Optional[Tensor] = None  # (M, input_size)
    device: str = "cuda"

    def __post_init__(self):
        self._model = _mlp(self.input_size, tuple(self.arch) + (1,), self.device)

    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        return _fresh(self._model, generator)

    def obs_act2data(self, obs: Tensor, act: Tensor) -> Tensor:
        data = obs
        if self.obs_indices is not None:
            data = data[..., list(self.obs_indices)]
        if self.include_action:
            data = torch.cat([data, act], dim=-1)
        return data

    def logits(self, params: Params, data: Tensor) -> Tensor:
        out = self._model(data, params)[..., 0]
        return torch.clamp(out, -self.logits_clip_range, self.logits_clip_range)

    def reward(self, params: Params, data: Tensor) -> Tensor:
        """The IRL reward transform of D(s)."""
        logits = self.logits(params, data)
        if self.reward_type == "gail":
            r = -_bernoulli_log_prob(logits, torch.zeros_like(logits))
        elif self.reward_type == "gail2":
            r = _bernoulli_log_prob(logits, torch.ones_like(logits))
            if self.nonnegative_reward:
                r = r + self.logits_clip_range
        elif self.reward_type == "airl":
            r = logits
            if self.nonnegative_reward:
                r = r + self.logits_clip_range
        elif self.reward_type == "fairl":
            r = torch.exp(logits) * -logits
            if self.nonnegative_reward:
                r = r + self.logits_clip_range
        else:
            raise NotImplementedError(self.reward_type)
        return r

    def loss_at(self, params: Params, policy_data: Tensor, idx: Tensor) -> Tensor:
        """Binary cross-entropy, target 1 and policy 0, with the target rows
        `idx` (one per policy row)."""
        target = self.target_data[idx]
        logits_t = self.logits(params, target)
        logits_p = self.logits(params, policy_data)
        ll = _bernoulli_log_prob(logits_t, torch.ones_like(logits_t)).mean()
        ll = ll + _bernoulli_log_prob(logits_p, torch.zeros_like(logits_p)).mean()
        return -ll

    def loss(self, params: Params, policy_data: Tensor, generator: torch.Generator) -> Tensor:
        """`loss_at` with as many target rows as policy rows, drawn uniformly
        (balanced classes)."""
        assert self.target_data is not None
        idx = torch.randint(0, self.target_data.shape[0], (policy_data.shape[0],),
                            generator=generator, device=generator.device)
        return self.loss_at(params, policy_data, idx)
