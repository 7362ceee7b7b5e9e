"""Parametric action distributions.

Counterpart of `brax_tpu/training/distribution.py`, with its formulas kept as
written: `softplus(scale) + min_std`, and `2 * (log 2 - x - softplus(-2x))`
for the tanh log-det.  Sampling draws from a passed `torch.Generator`.
"""

from __future__ import annotations

import abc
import math

import torch
import torch.nn.functional as F


class ParametricDistribution(abc.ABC):
    """Abstract parametric (action) distribution."""

    def __init__(self, param_size, postprocessor, event_ndims, reparametrizable):
        self._param_size = param_size
        self._postprocessor = postprocessor
        self._event_ndims = event_ndims
        self._reparametrizable = reparametrizable
        assert event_ndims in (0, 1)

    @abc.abstractmethod
    def create_dist(self, parameters):
        """Creates distribution from parameters."""

    @property
    def param_size(self):
        return self._param_size

    @property
    def reparametrizable(self):
        return self._reparametrizable

    def postprocess(self, event):
        return self._postprocessor.forward(event)

    def inverse_postprocess(self, event):
        return self._postprocessor.inverse(event)

    def sample_no_postprocessing(self, parameters, generator: torch.Generator):
        return self.create_dist(parameters).sample(generator)

    def sample(self, parameters, generator: torch.Generator):
        return self.postprocess(self.sample_no_postprocessing(parameters, generator))

    def mode(self, parameters):
        return self.postprocess(self.create_dist(parameters).mode())

    def log_prob(self, parameters, actions):
        dist = self.create_dist(parameters)
        log_probs = dist.log_prob(actions)
        log_probs = log_probs - self._postprocessor.forward_log_det_jacobian(actions)
        if self._event_ndims == 1:
            log_probs = torch.sum(log_probs, dim=-1)
        return log_probs

    def entropy(self, parameters, generator: torch.Generator):
        dist = self.create_dist(parameters)
        entropy = dist.entropy()
        entropy = entropy + self._postprocessor.forward_log_det_jacobian(dist.sample(generator))
        if self._event_ndims == 1:
            entropy = torch.sum(entropy, dim=-1)
        return entropy


class NormalDistribution:
    """Diagonal normal distribution."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def sample(self, generator: torch.Generator):
        noise = torch.randn(self.loc.shape, generator=generator, device=self.loc.device,
                            dtype=self.loc.dtype)
        return noise * self.scale + self.loc

    def mode(self):
        return self.loc

    def log_prob(self, x):
        log_unnormalized = -0.5 * torch.square(x / self.scale - self.loc / self.scale)
        log_normalization = 0.5 * math.log(2.0 * math.pi) + torch.log(self.scale)
        return log_unnormalized - log_normalization

    def entropy(self):
        log_normalization = 0.5 * math.log(2.0 * math.pi) + torch.log(self.scale)
        entropy = 0.5 + log_normalization
        return entropy * torch.ones_like(self.loc)


class TanhBijector:
    """Tanh bijector."""

    def forward(self, x):
        return torch.tanh(x)

    def inverse(self, y):
        return torch.atanh(y)

    def forward_log_det_jacobian(self, x):
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class NormalTanhDistribution(ParametricDistribution):
    """Normal followed by tanh; log_probs computed on pre-tanh actions."""

    def __init__(self, event_size, min_std=0.001):
        super().__init__(
            param_size=2 * event_size,
            postprocessor=TanhBijector(),
            event_ndims=1,
            reparametrizable=True,
        )
        self._min_std = min_std

    def create_dist(self, parameters):
        loc, scale = torch.chunk(parameters, 2, dim=-1)
        scale = F.softplus(scale) + self._min_std
        return NormalDistribution(loc=loc, scale=scale)
