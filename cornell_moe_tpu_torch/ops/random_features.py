"""Random Fourier feature GP sampling and approximate global-optima draws.

Counterpart of ``cornell_moe_tpu/ops/random_features.py`` (Bochner random
features and the posterior over the feature weights, Hernandez-Lobato et
al. 2014, section 2.1): one posterior GP sample is f(x) = phi(x) theta with
phi(x) = sqrt(2 alpha / F) cos(W x + b).  The spectral measure matches the
kernel: Gaussian for the squared exponential, multivariate t (a chi-square
mixture) for Matern 5/2.

Every function broadcasts over leading axes: an ensemble state (S members)
gives S samples, and draws with a leading axis P give P samples of one
state.  The random numbers of a sample (:class:`FeatureDraws`) come from an
explicit ``torch.Generator`` or are passed in, so that a test can feed the
JAX package's draws.  The Matern measure's u ~ chi2(5) is drawn as the sum
of five squared standard normals (2 nu = 5 is an integer), the same
distribution as the JAX package's 2 Gamma(5/2).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from cornell_moe_tpu_torch.models.covariance import MaternNu2p5
from cornell_moe_tpu_torch.models.gp import GaussianProcessState
from cornell_moe_tpu_torch.ops import linalg, optimizers, programs
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain

_MATERN_DOF = 5          # 2 nu for Matern nu = 5/2


class FeatureDraws(NamedTuple):
    """The random numbers of one sample (leading axes allowed)."""
    z: torch.Tensor             # (..., F, d) standard normals
    u: Optional[torch.Tensor]   # (..., F, 1) chi2(5) draws (Matern only)
    b: torch.Tensor             # (..., F) phases, uniform on [0, 2 pi)
    r: torch.Tensor             # (..., F) standard normals (the weights)


class RandomFeatureSample(NamedTuple):
    """Posterior GP samples in weight space: f(x) = phi(x) @ theta."""
    w: torch.Tensor        # (..., F, d) spectral frequencies
    b: torch.Tensor        # (..., F) phases
    theta: torch.Tensor    # (..., F) sampled weights
    scale: torch.Tensor    # (...) sqrt(2 alpha / F)


def draw_features(generator: torch.Generator, batch: tuple, n_features: int,
                  dim: int, matern: bool, device=None,
                  dtype=torch.float64) -> FeatureDraws:
    """Draws for samples of leading shape ``batch``."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    z = torch.randn(batch + (n_features, dim), **kw)
    u = torch.sum(torch.randn(batch + (n_features, 1, _MATERN_DOF), **kw)
                  ** 2, dim=-1) if matern else None
    b = 2.0 * math.pi * torch.rand(batch + (n_features,), **kw)
    r = torch.randn(batch + (n_features,), **kw)
    return FeatureDraws(z=z, u=u, b=b, r=r)


def _spectral_frequencies(draws: FeatureDraws, lengths: torch.Tensor
                          ) -> torch.Tensor:
    """W from the kernel's spectral measure, scaled by the lengths (...,
    d): Z / sqrt(u / 5) / l for Matern 5/2, Z / l otherwise."""
    z = draws.z
    if draws.u is not None:
        z = z / torch.sqrt(draws.u / _MATERN_DOF)
    return z / lengths[..., None, :]


def _phase(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor
           ) -> torch.Tensor:
    """W x + b at points x (..., P, d): (..., F, P)."""
    return w @ x.transpose(-1, -2) + b[..., None]


def sample_gp_with_random_features(generator: Optional[torch.Generator],
                                   state: GaussianProcessState,
                                   n_features: int,
                                   use_woodbury_if_faster: bool = True,
                                   draws: Optional[FeatureDraws] = None
                                   ) -> RandomFeatureSample:
    """Approximate GP posterior samples, one per member of ``state`` (or
    per leading index of ``draws``).

    The Bayesian linear model phi(x) theta with a unit Gaussian prior on
    theta conditions on the noise-whitened observations, derivative
    channels included; theta is then drawn from its posterior, through the
    Woodbury form when there are fewer observation channels than features.
    """
    cov = state.covariance
    if draws is None:
        draws = draw_features(generator, cov.alpha.shape, n_features,
                              state.dim, isinstance(cov, MaternNu2p5),
                              device=state.points_sampled.device,
                              dtype=state.points_sampled.dtype)
    scale = torch.sqrt(2.0 * cov.alpha / n_features)
    w = _spectral_frequencies(draws, cov.lengths)
    b, randomness = draws.b, draws.r
    if state.num_sampled == 0:
        return RandomFeatureSample(w=w, b=b, theta=randomness, scale=scale)

    x = state.points_sampled
    sd = torch.sqrt(state.noise_variance)                  # (..., 1 + m)
    arg = _phase(w, b, x)                                  # (..., F, n)
    sc = scale[..., None, None]
    rows = [sc * torch.cos(arg) / sd[..., 0, None, None]]
    for c, i in enumerate(state.derivatives):
        rows.append(-sc * torch.sin(arg) * w[..., i:i + 1] /
                    sd[..., 1 + c, None, None])
    phi = torch.cat(rows, dim=-1)                          # channel-major
    y = (state.points_sampled_value / sd[..., None, :]).transpose(-1, -2)
    y = y.reshape(y.shape[:-2] + (-1,))
    phi_t = phi.transpose(-1, -2)

    def mv(a, v):
        return (a @ v[..., None])[..., 0]

    n_ch = phi.shape[-1]
    eye = dict(dtype=phi.dtype, device=phi.device)
    if use_woodbury_if_faster and n_ch < n_features:
        # theta = r - Phi U diag(R) U^T Phi^T r + m_post
        woodbury = phi_t @ phi + torch.eye(n_ch, **eye)
        z = mv(phi, y)
        m_post = z - mv(phi, linalg.cho_solve(linalg.cholesky(woodbury),
                                              mv(phi_t, z)))
        d, u = torch.linalg.eigh(woodbury)
        r = 1.0 / (torch.sqrt(d) * (torch.sqrt(d) + 1.0))
        u_t = u.transpose(-1, -2)
        theta = randomness - mv(phi, mv(u, r * mv(u_t, mv(phi_t, randomness)))
                                ) + m_post
    else:
        a = phi @ phi_t + torch.eye(n_features, **eye)
        chol_a = linalg.cholesky(a)
        m_post = linalg.cho_solve(chol_a, mv(phi, y))
        # covariance A^-1: theta = m + L^-T r
        theta = m_post + linalg.solve_triangular(
            chol_a, randomness[..., None], lower=True, trans=True)[..., 0]
    return RandomFeatureSample(w=w, b=b, theta=theta, scale=scale)


def evaluate_random_feature_sample(sample: RandomFeatureSample,
                                   x: torch.Tensor) -> torch.Tensor:
    """f at points x (..., P, d): (..., P)."""
    rows = sample.scale[..., None, None] * torch.cos(
        _phase(sample.w, sample.b, x))
    return (sample.theta[..., None, :] @ rows)[..., 0, :]


def random_feature_gradient(sample: RandomFeatureSample, x: torch.Tensor
                            ) -> torch.Tensor:
    """grad f at one point per sample, x (..., d): (..., d) =
    -scale sum_k theta_k sin(w_k.x + b_k) w_k."""
    s = torch.sin(_phase(sample.w, sample.b, x[..., None, :])[..., 0])
    return -sample.scale[..., None] * (
        (sample.theta * s)[..., None, :] @ sample.w)[..., 0, :]


def random_feature_hessian(sample: RandomFeatureSample, x: torch.Tensor
                           ) -> torch.Tensor:
    """Hessian of f at one point per sample, x (..., d): (..., d, d) =
    -scale sum_k theta_k cos(w_k.x + b_k) w_k w_k^T."""
    c = sample.theta * torch.cos(
        _phase(sample.w, sample.b, x[..., None, :])[..., 0])
    return -sample.scale[..., None, None] * (
        sample.w.transpose(-1, -2) @ (c[..., None] * sample.w))


def global_optimization_of_gp_approximation(
        sample: RandomFeatureSample, domain, grid: torch.Tensor,
        params: optimizers.GradientDescentParameters = None,
        minimize: bool = True, program_cache=None) -> torch.Tensor:
    """Grid seed + gradient polish of each sampled function: (..., d).  The
    polish is kept only where it beats the best grid point.  With a
    ``program_cache`` (and ``programs.CAPTURE`` "auto") each GD step of the
    batch is one program over (x, the sample's tensors), replayed for
    every step of ``params``' schedule, the step size an input; ``domain``
    must then be a ``TensorProductDomain``."""
    if params is None:
        params = optimizers.GradientDescentParameters(
            num_multistarts=1, max_num_steps=80, max_num_restarts=2,
            gamma=0.7, pre_mult=0.2, max_relative_change=0.8)
    sign = -1.0 if minimize else 1.0

    def value(x):                              # (..., d) -> (...)
        return sign * evaluate_random_feature_sample(sample,
                                                     x[..., None, :])[..., 0]

    def vg(x):
        return value(x), sign * random_feature_gradient(sample, x)

    vals = sign * evaluate_random_feature_sample(sample, grid)   # (..., G)
    best = torch.max(vals, dim=-1)
    x0 = grid[best.indices]
    step_fn = None
    if program_cache is not None and programs.enabled():
        def step(x, rate, bounds, *fields):
            return optimizers.ascent_step(
                TensorProductDomain(bounds=bounds), params.max_relative_change,
                x, sign * random_feature_gradient(
                    RandomFeatureSample(*fields), x), rate)

        step_fn = program_cache.stepper(
            ("x_star_step", sign, params.max_relative_change) +
            programs.signature(sample), step, domain.bounds,
            *sample)
    x_opt = optimizers.gradient_ascent_batch(vg, domain, x0, params,
                                             step_fn=step_fn)
    take = (value(x_opt) > best.values)[..., None]
    return torch.where(take, x_opt, x0)


def sample_from_global_optima(generator: torch.Generator,
                              state: GaussianProcessState, domain,
                              grid: torch.Tensor, num_points: int,
                              n_features: int = 1000) -> torch.Tensor:
    """num_points approximate Thompson draws of argmin f for one (not
    ensemble) state: (num_points, d)."""
    draws = draw_features(generator, (num_points,), n_features, state.dim,
                          isinstance(state.covariance, MaternNu2p5),
                          device=state.points_sampled.device,
                          dtype=state.points_sampled.dtype)
    sample = sample_gp_with_random_features(None, state, n_features,
                                            draws=draws)
    return global_optimization_of_gp_approximation(sample, domain, grid)
