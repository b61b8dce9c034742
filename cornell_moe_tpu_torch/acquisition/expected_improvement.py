"""Expected Improvement: analytic 1,0-EI and Monte-Carlo q,p-EI.

Counterpart of ``cornell_moe_tpu/acquisition/expected_improvement.py``.
Objective is MINIMIZATION of f: EI = E[(best_so_far - min_j y_j)^+] over
the joint posterior of the union's values, with 1e-6 jitter on the union
variance before its Cholesky, and common random numbers (the normals are
drawn once per suggest call); the analytic form for q = 1, p = 0 guards the
standard deviation from below.  Gradients are ``torch.autograd`` of the
estimator.  A state that observes derivative channels (d-EI) works
unchanged: the posterior is over the union's value channels.

States may carry a leading ensemble axis S; the ``_mcmc`` forms average
over it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models import gp
from cornell_moe_tpu_torch.ops import linalg, optimizers
from cornell_moe_tpu_torch.ops.domains import RepeatedDomain


def draw_normals(generator: torch.Generator, num_mc: int, n: int,
                 device=None, dtype=torch.float64) -> torch.Tensor:
    """Plain MC normals (num_mc, n)."""
    return torch.randn((num_mc, n), generator=generator, device=device,
                       dtype=dtype)


def draw_antithetic_normals(generator: torch.Generator, num_mc: int, n: int,
                            device=None, dtype=torch.float64
                            ) -> torch.Tensor:
    """Antithetic pairs: z_{2k+1} = -z_{2k}."""
    half = (num_mc + 1) // 2
    z = torch.randn((half, n), generator=generator, device=device,
                    dtype=dtype)
    return torch.stack([z, -z], dim=1).reshape(2 * half, n)[:num_mc]


def _union(points_to_sample, points_being_sampled):
    if points_being_sampled is None or points_being_sampled.numel() == 0:
        return points_to_sample
    return torch.cat([points_to_sample, points_being_sampled], dim=-2)


def analytic_expected_improvement(state: gp.GaussianProcessState,
                                  point_to_sample: torch.Tensor,
                                  best_so_far) -> torch.Tensor:
    """Closed-form 1,0-EI at point_to_sample (..., 1, d): sigma (u Phi(u) +
    phi(u)), u = (best - mu) / sigma.  Returns (...) for a single GP."""
    pts = point_to_sample if point_to_sample.dim() > 1 else \
        point_to_sample[None]
    mu = gp.posterior_mean(state, pts)[..., 0, 0]
    var = gp.posterior_variance(state, pts)[..., 0, 0]
    sigma = torch.sqrt(torch.clamp(var, min=config.MINIMUM_STD_DEV**2))
    u = (best_so_far - mu) / sigma
    pdf = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return sigma * (u * torch.special.ndtr(u) + pdf)


def monte_carlo_expected_improvement(state: gp.GaussianProcessState,
                                     points_to_sample: torch.Tensor,
                                     points_being_sampled,
                                     best_so_far, normals: torch.Tensor
                                     ) -> torch.Tensor:
    """q,p-EI estimator at one union; normals (num_mc, q + p).  Returns
    the state's batch shape (a scalar for one GP)."""
    union = _union(points_to_sample, points_being_sampled)
    mu = gp.posterior_mean(state, union)[..., 0]             # (..., u)
    var = gp.posterior_variance(state, union)
    chol = linalg.cholesky_small(
        linalg.add_jitter(var, config.EI_VARIANCE_JITTER))
    samples = mu[..., None, :] + normals @ chol.transpose(-1, -2)
    best = torch.as_tensor(best_so_far, dtype=mu.dtype, device=mu.device)
    improvement = torch.clamp(
        best[..., None] - torch.min(samples, dim=-1).values, min=0.0)
    return torch.mean(improvement, dim=-1)


def monte_carlo_expected_improvement_mcmc(states, points_to_sample,
                                          points_being_sampled, best_so_far,
                                          normals) -> torch.Tensor:
    """Mean EI over the ensemble; ``best_so_far`` scalar or (S,)."""
    return torch.mean(monte_carlo_expected_improvement(
        states, points_to_sample, points_being_sampled, best_so_far,
        normals))


def _with_member_axes(cov, k: int):
    """The covariance with ``k`` unit axes inserted after its batch axes,
    so it broadcasts against point sets with k batch axes of their own."""
    h = cov.hyperparameters
    return type(cov)(hyperparameters=h.reshape(
        h.shape[:-1] + (1,) * k + h.shape[-1:]))


def monte_carlo_expected_improvement_batch(state, unions: torch.Tensor,
                                           best_so_far,
                                           normals: torch.Tensor
                                           ) -> torch.Tensor:
    """q,p-EI at B unions at once: (B, u, dim) -> (..., B) for a state with
    batch axes (...).  The B unions' kernel columns share wide matmuls."""
    b, u, dim = unions.shape
    k_xu = gp._mix_cov(state, unions.reshape(b * u, dim))   # (..., N, B*u)
    n = k_xu.shape[-2]
    batch = k_xu.shape[:-2]
    mu = (k_xu.transpose(-1, -2) @ state.K_inv_y[..., None])[..., 0]
    mu = mu.reshape(batch + (b, u)) + state.mean[..., None, None]
    if state.inv_chol_K is not None:
        va = linalg.solve_lower_with_refinement(
            state.chol_K, state.inv_chol_K, k_xu)
    else:
        va = linalg.solve_triangular(state.chol_K, k_xu, lower=True)
    va = va.reshape(batch + (n, b, u))
    prior = cov_mod.build_block_covariance(
        _with_member_axes(state.covariance, 1), unions, (), unions, ())
    var = prior - torch.einsum("...nbi,...nbj->...bij", va, va)
    chol = linalg.cholesky_small(linalg.add_jitter(
        linalg.symmetrize(var), config.EI_VARIANCE_JITTER))
    samples = mu[..., None, :] + torch.einsum("...bij,mj->...bmi", chol,
                                              normals)
    best = torch.as_tensor(best_so_far, dtype=mu.dtype, device=mu.device)
    improvement = torch.clamp(
        best[..., None, None] - torch.min(samples, dim=-1).values, min=0.0)
    return torch.mean(improvement, dim=-1)


def monte_carlo_expected_improvement_mcmc_batch(states, pts_batch,
                                                points_being_sampled,
                                                best_so_far, normals
                                                ) -> torch.Tensor:
    """Ensemble-averaged q,p-EI at B start blocks: (B, q, dim) -> (B,)."""
    if points_being_sampled is not None and points_being_sampled.numel():
        unions = torch.cat([pts_batch, points_being_sampled.expand(
            (pts_batch.shape[0],) + points_being_sampled.shape)], dim=1)
    else:
        unions = pts_batch
    return torch.mean(monte_carlo_expected_improvement_batch(
        states, unions, best_so_far, normals), dim=0)


def expected_improvement_mcmc_batch_value_and_grad(
        states, pts_batch, points_being_sampled, best_so_far, normals):
    """((B,), (B, q, dim)) ensemble q-EI values and per-start gradients:
    each start's value depends only on its own block, so the gradient of
    the sum is the per-start gradient."""
    with torch.enable_grad():
        p = pts_batch.detach().requires_grad_(True)
        vals = monte_carlo_expected_improvement_mcmc_batch(
            states, p, points_being_sampled, best_so_far, normals)
        (grads,) = torch.autograd.grad(vals.sum(), p)
    return vals.detach(), grads


def multistart_expected_improvement_mcmc_optimization(
        generator: torch.Generator, states, domain, num_to_sample: int,
        params: optimizers.GradientDescentParameters,
        points_being_sampled=None, best_so_far=None,
        num_mc_iterations: int = 1000, conv_tol: Optional[float] = None,
        chunk_size: Optional[int] = None) -> torch.Tensor:
    """q points maximizing ensemble-averaged q,p-EI by the lockstep-batched
    multistart; ``conv_tol`` gates each chunk on its max step norm.
    Returns (num_to_sample, dim)."""
    if best_so_far is None:
        best_so_far = states.best_observed_value
    p = 0 if points_being_sampled is None else points_being_sampled.shape[0]
    rep = RepeatedDomain(domain=domain, num_repeats=num_to_sample)
    starts = rep.generate_latin_hypercube_points(generator,
                                                 params.num_multistarts)
    normals = draw_normals(generator, num_mc_iterations, num_to_sample + p,
                           device=starts.device, dtype=starts.dtype)

    def bvg(pts_batch):
        return expected_improvement_mcmc_batch_value_and_grad(
            states, pts_batch, points_being_sampled, best_so_far, normals)

    return optimizers.multistart_optimize_batched(
        bvg, rep, starts, params, chunk_size=chunk_size,
        conv_tol=conv_tol).best_point


def multistart_expected_improvement_optimization(
        generator: torch.Generator, state, domain, num_to_sample: int,
        params: optimizers.GradientDescentParameters,
        points_being_sampled=None, best_so_far=None,
        num_mc_iterations: int = 1000, use_analytic: Optional[bool] = None,
        conv_tol: Optional[float] = None,
        chunk_size: Optional[int] = None) -> torch.Tensor:
    """q points maximizing one GP's q,p-EI (the closed form for q = 1,
    p = 0) by the lockstep-batched multistart, each start's value and
    gradient its own.  Returns (num_to_sample, dim)."""
    p = 0 if points_being_sampled is None else points_being_sampled.shape[0]
    if best_so_far is None:
        best_so_far = state.best_observed_value
    if use_analytic is None:
        use_analytic = num_to_sample == 1 and p == 0
    rep = RepeatedDomain(domain=domain, num_repeats=num_to_sample)
    starts = rep.generate_latin_hypercube_points(generator,
                                                 params.num_multistarts)
    if use_analytic:
        def value(pts_batch):
            return analytic_expected_improvement(state, pts_batch,
                                                 best_so_far)
    else:
        normals = draw_normals(generator, num_mc_iterations,
                               num_to_sample + p, device=starts.device,
                               dtype=starts.dtype)

        def value(pts_batch):
            unions = pts_batch if p == 0 else torch.cat(
                [pts_batch, points_being_sampled.expand(
                    (pts_batch.shape[0],) + points_being_sampled.shape)],
                dim=1)
            return monte_carlo_expected_improvement_batch(
                state, unions, best_so_far, normals)

    def bvg(pts_batch):
        with torch.enable_grad():
            x = pts_batch.detach().requires_grad_(True)
            vals = value(x)
            (grads,) = torch.autograd.grad(vals.sum(), x)
        return vals.detach(), grads

    return optimizers.multistart_optimize_batched(
        bvg, rep, starts, params, chunk_size=chunk_size,
        conv_tol=conv_tol).best_point
