"""Gaussian-process posterior core (value channels).

Counterpart of ``cornell_moe_tpu/models/gp.py``.  The fitted GP is a
dataclass of tensors; an ensemble of S fitted GPs is the same dataclass
with a leading axis S on every tensor (the covariance's hyperparameters
are (S, 1 + d)).  Every posterior function below broadcasts over that axis,
where the JAX package vmaps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models.covariance import StationaryCovariance
from cornell_moe_tpu_torch.ops import linalg


@dataclasses.dataclass
class GaussianProcessState:
    """Fitted-GP state; optional leading ensemble axis on every tensor."""

    covariance: StationaryCovariance
    noise_variance: torch.Tensor        # (..., 1) value-channel noise
    points_sampled: torch.Tensor        # (..., n, dim)
    points_sampled_value: torch.Tensor  # (..., n, 1)
    chol_K: torch.Tensor                # (..., n, n) lower factor
    K_inv_y: torch.Tensor               # (..., n)
    mean: torch.Tensor                  # (...,) prior mean
    inv_chol_K: Optional[torch.Tensor] = None    # (..., n, n) L^-1
    point_noise: Optional[torch.Tensor] = None   # (..., n, 1)
    derivatives: Tuple[int, ...] = ()

    @property
    def dim(self) -> int:
        return self.points_sampled.shape[-1]

    @property
    def num_sampled(self) -> int:
        return self.points_sampled.shape[-2]

    @property
    def best_observed_value(self) -> torch.Tensor:
        return torch.min(self.points_sampled_value[..., 0], dim=-1).values

    def member(self, i: int) -> "GaussianProcessState":
        """Member ``i`` of an ensemble state (leading axis dropped)."""
        def take(t):
            return None if t is None else t[i]
        return dataclasses.replace(
            self, covariance=type(self.covariance)(
                hyperparameters=self.covariance.hyperparameters[i]),
            noise_variance=self.noise_variance[i],
            points_sampled=self.points_sampled[i],
            points_sampled_value=self.points_sampled_value[i],
            chol_K=self.chol_K[i], K_inv_y=self.K_inv_y[i],
            mean=self.mean[i], inv_chol_K=take(self.inv_chol_K),
            point_noise=take(self.point_noise))


def fit_gp(covariance: StationaryCovariance, noise_variance,
           points_sampled, points_sampled_value, derivatives=(),
           jitter=0.0, mean=None, precompute_inverse: bool = True,
           point_noise=None) -> GaussianProcessState:
    """Build the derived GP state (RecomputeDerivedVariables counterpart).

    The covariance's hyperparameters may carry batch axes (...): the
    result is then an ensemble state over them, with ``noise_variance``
    (..., 1) and ``jitter`` a float or a (...) tensor.  ``points_sampled``
    (n, dim) and ``points_sampled_value`` (n, 1) are shared; ``point_noise``
    (n, 1) is added per point on top of the channel noise (the
    shape-bucketing mechanism).  ``mean`` defaults to the empirical mean of
    the values.
    """
    cov_mod._value_only(derivatives)
    x = torch.as_tensor(points_sampled)
    y = torch.as_tensor(points_sampled_value, dtype=x.dtype, device=x.device)
    if y.dim() == 1:
        y = y[:, None]
    batch = covariance.hyperparameters.shape[:-1]
    noise = torch.as_tensor(noise_variance, dtype=x.dtype,
                            device=x.device).reshape(batch + (1,))
    if covariance.dim != x.shape[-1]:
        raise ValueError(
            f"covariance has {covariance.dim} length scales but points "
            f"have dim {x.shape[-1]}")
    n = x.shape[0]
    noise_vec = noise.expand(batch + (n,))
    if point_noise is not None:
        point_noise = torch.as_tensor(point_noise, dtype=x.dtype,
                                      device=x.device).reshape(n, 1)
        noise_vec = noise_vec + point_noise[:, 0]
    k = cov_mod.build_covariance_matrix_with_noise(covariance, x, (),
                                                   noise_vec)
    chol = linalg.cholesky(k, jitter=jitter)

    if mean is None:
        mean = torch.mean(y[:, 0])
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    k_inv_y = linalg.cho_solve(chol, (y[:, 0] - mean).expand(batch + (n,)))
    inv_chol = linalg.solve_triangular(
        chol, torch.eye(n, dtype=x.dtype, device=x.device).expand_as(chol),
        lower=True) if precompute_inverse else None

    def per_member(t):
        return t.expand(batch + t.shape)

    return GaussianProcessState(
        covariance=covariance, noise_variance=noise,
        points_sampled=per_member(x), points_sampled_value=per_member(y),
        chol_K=chol, K_inv_y=k_inv_y, mean=mean.expand(batch),
        inv_chol_K=inv_chol,
        point_noise=None if point_noise is None else per_member(point_noise))


def _mix_cov(state: GaussianProcessState, points_to_sample: torch.Tensor
             ) -> torch.Tensor:
    """K(X_train, X_star): (..., n, q)."""
    return cov_mod.build_block_covariance(
        state.covariance, state.points_sampled, (), points_to_sample, ())


def posterior_mean(state: GaussianProcessState, points_to_sample
                   ) -> torch.Tensor:
    """Posterior mean at points (..., q, d): returns (..., q, 1)."""
    kt = _mix_cov(state, points_to_sample)
    mu = (kt.transpose(-1, -2) @ state.K_inv_y[..., None])[..., 0]
    return (mu + state.mean[..., None])[..., None]


def posterior_covariance(state: GaussianProcessState, points_1,
                         points_2=None) -> torch.Tensor:
    """K(A,B) - K(A,X) K^-1 K(X,B), refined inverse-Cholesky path when the
    state carries L^-1."""
    b = points_1 if points_2 is None else points_2
    prior = cov_mod.build_block_covariance(state.covariance, points_1, (),
                                           b, ())
    ka = _mix_cov(state, points_1)
    kb = ka if points_2 is None else _mix_cov(state, b)

    def solve(rhs):
        if state.inv_chol_K is not None:
            return linalg.solve_lower_with_refinement(
                state.chol_K, state.inv_chol_K, rhs)
        return linalg.solve_triangular(state.chol_K, rhs, lower=True)

    va = solve(ka)
    vb = va if points_2 is None else solve(kb)
    return prior - va.transpose(-1, -2) @ vb


def posterior_variance(state: GaussianProcessState, points_to_sample
                       ) -> torch.Tensor:
    """Joint posterior covariance over points_to_sample."""
    return posterior_covariance(state, points_to_sample)
