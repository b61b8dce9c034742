"""Hyperparameter priors (spearmint-style) on log-scale hyperparameters.

Counterpart of ``cornell_moe_tpu/models/priors.py`` (the priors
``DefaultPrior`` uses, and the lognormal prior of the PES driver).
``lnprob`` takes (..., D) and returns (...); ``sample_from_prior`` draws
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class TophatPrior:
    """Uniform on [min, max] in log space."""

    min: float = -2.0
    max: float = 3.0

    def lnprob(self, theta: torch.Tensor) -> torch.Tensor:
        inside = torch.all((theta >= self.min) & (theta <= self.max), dim=-1)
        return torch.where(inside, 0.0, float("-inf")).to(theta.dtype)

    def sample_from_prior(self, generator, n_samples, d=1, device=None,
                          dtype=torch.float64):
        u = torch.rand((n_samples, d), generator=generator, device=device,
                       dtype=dtype)
        return self.min + u * (self.max - self.min)


@dataclasses.dataclass(frozen=True)
class NormalPrior:
    """Gaussian in log space."""

    mean: float = 0.0
    sigma: float = 1.0

    def lnprob(self, theta: torch.Tensor) -> torch.Tensor:
        z = (theta - self.mean) / self.sigma
        return torch.sum(-0.5 * z * z - math.log(self.sigma)
                         - 0.5 * math.log(2.0 * math.pi), dim=-1)

    def sample_from_prior(self, generator, n_samples, d=1, device=None,
                          dtype=torch.float64):
        return self.mean + self.sigma * torch.randn(
            (n_samples, d), generator=generator, device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class HorseshoePrior:
    """Horseshoe as spearmint uses it: lnprob(theta) =
    log(log(1 + 3 (scale / theta)^2)) on the log-space value itself."""

    scale: float = 0.1

    def lnprob(self, theta: torch.Tensor) -> torch.Tensor:
        zero = theta == 0.0
        safe = torch.where(zero, 1.0, theta)
        val = torch.log(torch.log1p(3.0 * (self.scale / safe) ** 2))
        return torch.sum(torch.where(zero, float("inf"), val), dim=-1)

    def sample_from_prior(self, generator, n_samples, d=1, device=None,
                          dtype=torch.float64):
        lamda = torch.empty((n_samples, d), device=device, dtype=dtype
                            ).cauchy_(generator=generator).abs()
        g = torch.randn((n_samples, d), generator=generator, device=device,
                        dtype=dtype)
        return torch.log(torch.abs(g * lamda * self.scale))


@dataclasses.dataclass(frozen=True)
class LognormalPrior:
    """scipy.stats.lognorm.logpdf(theta, sigma, loc=mean): -inf where
    theta <= mean."""

    sigma: float = 1.0
    mean: float = 0.0

    def lnprob(self, theta: torch.Tensor) -> torch.Tensor:
        x = theta - self.mean
        pos = x > 0
        log_x = torch.log(torch.where(pos, x, 1.0))
        val = (-log_x - math.log(self.sigma) - 0.5 * math.log(2.0 * math.pi)
               - 0.5 * (log_x / self.sigma) ** 2)
        return torch.sum(torch.where(pos, val, float("-inf")), dim=-1)

    def sample_from_prior(self, generator, n_samples, d=1, device=None,
                          dtype=torch.float64):
        return torch.exp(self.sigma * torch.randn(
            (n_samples, d), generator=generator, device=device,
            dtype=dtype)) + self.mean


@dataclasses.dataclass(frozen=True)
class DefaultPrior:
    """Normal(0, 1) on the log amplitude theta[0], Tophat(-2, 3) on the log
    length scales theta[1:-num_noise], Horseshoe(0.1) on each log noise."""

    n_dims: int
    num_noise: int
    amp_prior: NormalPrior = NormalPrior()
    length_prior: TophatPrior = TophatPrior(min=-2.0, max=3.0)
    noise_prior: HorseshoePrior = HorseshoePrior(scale=0.1)

    def lnprob(self, theta: torch.Tensor) -> torch.Tensor:
        k = self.n_dims - self.num_noise
        return (self.amp_prior.lnprob(theta[..., 0:1])
                + self.length_prior.lnprob(theta[..., 1:k])
                + self.noise_prior.lnprob(theta[..., k:]))

    def sample_from_prior(self, generator, n_samples, device=None,
                          dtype=torch.float64) -> torch.Tensor:
        num_lengths = self.n_dims - self.num_noise - 1
        kw = dict(device=device, dtype=dtype)
        return torch.cat([
            self.amp_prior.sample_from_prior(generator, n_samples, 1, **kw),
            self.length_prior.sample_from_prior(generator, n_samples,
                                                num_lengths, **kw),
            self.noise_prior.sample_from_prior(generator, n_samples,
                                               self.num_noise, **kw)],
            dim=1)
