"""Expected Improvement: analytic 1,0-EI, Monte-Carlo q,p-EI and the
heuristic q-EI policies (constant liar, kriging believer).

Counterpart of ``cornell_moe_tpu/acquisition/expected_improvement.py``.
Objective is MINIMIZATION of f: EI = E[(best_so_far - min_j y_j)^+] over
the joint posterior of the union's values, with 1e-6 jitter on the union
variance before its Cholesky, and common random numbers (the normals are
drawn once per suggest call); the analytic form for q = 1, p = 0 guards the
standard deviation from below.  Gradients are ``torch.autograd`` of the
estimator.  A state that observes derivative channels (d-EI) works
unchanged: the posterior is over the union's value channels.

States may carry a leading ensemble axis S; the ``_mcmc`` forms average
over it.  The single-GP forms (point lists, the multistart, heuristic q-EI)
take one member (``state.member(i)``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models import gp
from cornell_moe_tpu_torch.ops import linalg, optimizers, programs
from cornell_moe_tpu_torch.ops.domains import (RepeatedDomain,
                                               TensorProductDomain)
from cornell_moe_tpu_torch.parallel import sharding


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
    the state's batch shape (a scalar for one GP).  Where float32
    cancellation on a near-noiseless model leaves the union's variance
    indefinite, its Cholesky factor and so the estimate are NaN, as in the
    JAX package and the batched estimator: the multistarts drop such a
    start (``optimizers.select_best``)."""
    mu, var = _union_posterior(
        state, _union(points_to_sample, points_being_sampled))
    return _estimate_from_posterior(mu, var, best_so_far, normals)


def _union_posterior(state: gp.GaussianProcessState, union: torch.Tensor):
    """(mean (..., u), covariance (..., u, u)) of the union's values."""
    return gp.posterior_mean(state, union)[..., 0], \
        gp.posterior_variance(state, union)


def _estimate_from_posterior(mu: torch.Tensor, var: torch.Tensor,
                             best_so_far,
                             normals: torch.Tensor) -> torch.Tensor:
    """The q,p-EI estimate from the union's posterior: its variance
    factored with ``EI_VARIANCE_JITTER`` on the diagonal, NaN where that
    fails."""
    chol = linalg.cholesky_small(linalg.add_jitter(
        var, config.EI_VARIANCE_JITTER))
    samples = mu[..., None, :] + normals @ chol.transpose(-1, -2)
    best = torch.as_tensor(best_so_far, dtype=mu.dtype, device=mu.device)
    improvement = torch.clamp(
        best[..., None] - torch.min(samples, dim=-1).values, min=0.0)
    return torch.mean(improvement, dim=-1)


def expected_improvement_value_and_grad(state: gp.GaussianProcessState,
                                        points_to_sample: torch.Tensor,
                                        points_being_sampled, best_so_far,
                                        normals: torch.Tensor):
    """One GP's q,p-EI at points_to_sample (q, d) and its gradient with
    respect to them, by autograd."""
    with torch.enable_grad():
        x = points_to_sample.detach().requires_grad_(True)
        val = monte_carlo_expected_improvement(
            state, x, points_being_sampled, best_so_far, normals)
        (g,) = torch.autograd.grad(val, x)
    return val.detach(), g


def _batch_unions(pts_batch: torch.Tensor, points_being_sampled):
    """Start blocks (B, q, d) followed by the points being sampled."""
    if points_being_sampled is None or points_being_sampled.numel() == 0:
        return pts_batch
    return torch.cat([pts_batch, points_being_sampled.expand(
        (pts_batch.shape[0],) + points_being_sampled.shape)], dim=1)


def expected_improvement_batch_value_and_grad(
        state: gp.GaussianProcessState, pts_batch: torch.Tensor,
        points_being_sampled, best_so_far, normals: torch.Tensor):
    """((B,), (B, q, d)) one GP's q,p-EI values and per-start gradients at
    start blocks (B, q, d), by the batched estimator: each start's value
    depends only on its own block, so the gradient of the sum is the
    per-start gradient."""
    with torch.enable_grad():
        x = pts_batch.detach().requires_grad_(True)
        vals = monte_carlo_expected_improvement_batch(
            state, _batch_unions(x, points_being_sampled), best_so_far,
            normals)
        (grads,) = torch.autograd.grad(vals.sum(), x)
    return vals.detach(), grads


def evaluate_expected_improvement_at_point_list(
        state: gp.GaussianProcessState, points_list: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        points_being_sampled=None, best_so_far=None,
        num_mc_iterations: int = 1000, use_analytic: Optional[bool] = None,
        normals: Optional[torch.Tensor] = None,
        program_cache=None) -> torch.Tensor:
    """One GP's EI at each candidate block of ``points_list`` (P, q, d),
    or (P, d) for single points: (P,).  The closed form for q = 1, p = 0;
    otherwise the MC estimator on ``normals`` (num_mc, q + p), drawn from
    ``generator`` when not given, and from a generator seeded 0 when
    neither is (common random numbers across calls).  With a
    ``program_cache`` either form is one program."""
    pts = points_list if points_list.dim() == 3 else points_list[:, None, :]
    if best_so_far is None:
        best_so_far = state.best_observed_value
    q = pts.shape[1]
    p = 0 if points_being_sampled is None else points_being_sampled.shape[0]
    if use_analytic is None:
        use_analytic = q == 1 and p == 0
    tensors, layout = gp.state_tensors(state)
    best = torch.as_tensor(best_so_far, dtype=pts.dtype, device=pts.device)
    if use_analytic:
        return programs.run(
            program_cache, ("ei_score", "analytic", layout),
            lambda x, b, *ts: analytic_expected_improvement(
                gp.state_from_tensors(layout, ts), x, b),
            pts, best, *tensors)
    if normals is None:
        if generator is None:
            generator = torch.Generator(device=pts.device).manual_seed(0)
        normals = draw_normals(generator, num_mc_iterations, q + p,
                               device=pts.device, dtype=pts.dtype)
    being = None if p == 0 else points_being_sampled.expand(
        (pts.shape[0],) + points_being_sampled.shape)
    return programs.run(
        program_cache, ("ei_score", "monte_carlo", layout),
        lambda u, b, nrm, *ts: monte_carlo_expected_improvement(
            gp.state_from_tensors(layout, ts), u, None, b, nrm),
        _union(pts, being), best, normals, *tensors)


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
    mu, var = _batch_union_posterior(state, unions)
    return _estimate_batch(mu, var, best_so_far, normals)


def _batch_union_posterior(state, unions: torch.Tensor):
    """(mean (..., B, u), covariance (..., B, u, u)) of B unions' values."""
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
    return mu, prior - torch.einsum("...nbi,...nbj->...bij", va, va)


def _estimate_batch(mu: torch.Tensor, var: torch.Tensor, best_so_far,
                    normals: torch.Tensor) -> torch.Tensor:
    """The batched estimator's q,p-EI estimate from B unions' posteriors
    (..., B, u) and (..., B, u, u); NaN where a factor fails."""
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
    return torch.mean(monte_carlo_expected_improvement_batch(
        states, _batch_unions(pts_batch, points_being_sampled), best_so_far,
        normals), dim=0)


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
        use_batched: bool = True, chunk_size: Optional[int] = None,
        group=None, program_cache=None) -> torch.Tensor:
    """q points maximizing ensemble-averaged q,p-EI.  ``use_batched`` (the
    default): the lockstep-batched multistart, ``conv_tol`` gating each
    chunk on its max step norm; with a ``program_cache`` each GD step of a
    chunk (its value and gradient by autograd and the step) is one program
    per chunk shape (``ops.programs``), and the domain must then be a
    ``TensorProductDomain``.  Otherwise the per-start multistart over
    :func:`monte_carlo_expected_improvement_mcmc`'s value and gradient,
    eager, each start gated on its own.  A ``group`` shards the restart
    axis of either route over its ranks (``parallel.sharding``; each
    start's result is the unsharded run's).  Returns (num_to_sample,
    dim)."""
    if best_so_far is None:
        best_so_far = states.best_observed_value
    p = 0 if points_being_sampled is None else points_being_sampled.shape[0]
    rep = RepeatedDomain(domain=domain, num_repeats=num_to_sample)
    starts = rep.generate_latin_hypercube_points(generator,
                                                 params.num_multistarts)
    normals = draw_normals(generator, num_mc_iterations, num_to_sample + p,
                           device=starts.device, dtype=starts.dtype)

    if not use_batched:
        def vg(pts):
            with torch.enable_grad():
                x = pts.detach().requires_grad_(True)
                val = monte_carlo_expected_improvement_mcmc(
                    states, x, points_being_sampled, best_so_far, normals)
                (g,) = torch.autograd.grad(val, x)
            return val.detach(), g

        return sharding.sharded_multistart_optimize(
            vg, rep, starts, params, group, conv_tol=conv_tol).best_point

    bvg = _mcmc_batch_value_and_grad(states, points_being_sampled,
                                     best_so_far, normals)
    step_fn = None
    if program_cache is not None and programs.enabled():
        step_fn = _ei_step_program(
            program_cache, "qei_step", _mcmc_batch_value_and_grad, states,
            domain, num_to_sample, points_being_sampled, best_so_far,
            normals, params)
    return sharding.sharded_multistart_optimize_batched_gated(
        bvg, rep, starts, params, group, chunk_size=chunk_size,
        conv_tol=conv_tol, step_fn=step_fn).best_point


def _batch_value_and_grad(state, points_being_sampled, best_so_far,
                          normals: Optional[torch.Tensor]) -> Callable:
    """One GP's batched EI value and gradient over start blocks (B, q, d):
    the closed form when ``normals`` is None, else the batched MC
    estimator on them."""
    if normals is not None:
        return lambda x: expected_improvement_batch_value_and_grad(
            state, x, points_being_sampled, best_so_far, normals)

    def bvg(pts_batch):
        with torch.enable_grad():
            x = pts_batch.detach().requires_grad_(True)
            vals = analytic_expected_improvement(state, x, best_so_far)
            (grads,) = torch.autograd.grad(vals.sum(), x)
        return vals.detach(), grads
    return bvg


def _mcmc_batch_value_and_grad(states, points_being_sampled, best_so_far,
                               normals: torch.Tensor) -> Callable:
    """The ensemble-averaged batched q,p-EI value and gradient over start
    blocks (B, q, d)."""
    return lambda x: expected_improvement_mcmc_batch_value_and_grad(
        states, x, points_being_sampled, best_so_far, normals)


def _ei_step_program(program_cache, kind: str, value_and_grad_of: Callable,
                     state, domain, num_to_sample: int,
                     points_being_sampled, best_so_far, normals, params):
    """An EI multistart's GD step as a program: ``(x, rate) -> (x_new,
    dx)``, x a chunk of starts (B, q, dim), the gradient that of
    ``value_and_grad_of(state, points_being_sampled, best_so_far,
    normals)`` (:func:`_batch_value_and_grad` for one GP,
    :func:`_mcmc_batch_value_and_grad` for an ensemble); the state's
    tensors are inputs, so a refit inside the bucket replays it."""
    if not isinstance(domain, TensorProductDomain):
        raise TypeError(f"the {kind} program takes a TensorProductDomain, "
                        f"got {type(domain).__name__}")
    tensors, layout = gp.state_tensors(state)
    kw = dict(dtype=tensors[0].dtype, device=tensors[0].device)
    extra = tuple(t for t in (normals, points_being_sampled)
                  if t is not None)

    def step(x, rate, bounds, best, *rest):
        st = gp.state_from_tensors(layout, rest[:len(tensors)])
        more = list(rest[len(tensors):])
        nrm = None if normals is None else more.pop(0)
        being = more.pop(0) if more else None
        _, g = value_and_grad_of(st, being, best, nrm)(x)
        rep = RepeatedDomain(domain=TensorProductDomain(bounds=bounds),
                             num_repeats=num_to_sample)
        return optimizers.ascent_step(rep, params.max_relative_change, x, g,
                                      rate)

    key = (kind, tuple(t.shape for t in tensors), layout, normals is None,
           tuple(t.shape for t in extra), num_to_sample,
           params.max_relative_change, kw["dtype"], str(kw["device"]))
    return program_cache.stepper(key, step, domain.bounds,
                                 torch.as_tensor(best_so_far, **kw),
                                 *tensors, *extra)


def multistart_expected_improvement_optimization(
        generator: torch.Generator, state, domain, num_to_sample: int,
        params: optimizers.GradientDescentParameters,
        points_being_sampled=None, best_so_far=None,
        num_mc_iterations: int = 1000, num_random_search: int = 0,
        use_analytic: Optional[bool] = None,
        conv_tol: Optional[float] = None, use_batched: bool = True,
        chunk_size: Optional[int] = None, group=None,
        program_cache=None) -> torch.Tensor:
    """q points maximizing one GP's q,p-EI (the closed form for q = 1,
    p = 0).  ``use_batched``: the lockstep-batched multistart, each start's
    value and gradient its own and ``conv_tol`` gating each chunk on its
    max step norm; otherwise the per-start multistart, each start gated on
    its own.  ``num_random_search`` > 0 takes the per-start multistart with
    the brute-force fallback over that many Latin-hypercube blocks, drawn
    after the starts and the normals.  A ``group`` shards the batched
    route's restart axis over its ranks (``parallel.sharding``), as the JAX
    package's mesh does.  With a ``program_cache`` (and ``CAPTURE``
    "auto") each GD step of the batched route is one program per chunk
    shape; the domain must then be a ``TensorProductDomain``.  Returns
    (num_to_sample, dim)."""
    p = 0 if points_being_sampled is None else points_being_sampled.shape[0]
    if best_so_far is None:
        best_so_far = state.best_observed_value
    if use_analytic is None:
        use_analytic = num_to_sample == 1 and p == 0
    rep = RepeatedDomain(domain=domain, num_repeats=num_to_sample)
    starts = rep.generate_latin_hypercube_points(generator,
                                                 params.num_multistarts)
    normals = None if use_analytic else draw_normals(
        generator, num_mc_iterations, num_to_sample + p,
        device=starts.device, dtype=starts.dtype)
    bvg = _batch_value_and_grad(state, points_being_sampled, best_so_far,
                                normals)
    if use_analytic:
        def vg(pts):
            v, g = bvg(pts[None])
            return v[0], g[0]
    else:
        def vg(pts):
            return expected_improvement_value_and_grad(
                state, pts, points_being_sampled, best_so_far, normals)

    if num_random_search:
        search = rep.generate_latin_hypercube_points(generator,
                                                     num_random_search)
        result = optimizers.multistart_optimize_with_dumb_search_fallback(
            vg, rep, starts, search, params)
    elif use_batched:
        step_fn = None
        if program_cache is not None and programs.enabled():
            step_fn = _ei_step_program(
                program_cache, "ei_step", _batch_value_and_grad, state,
                domain, num_to_sample, points_being_sampled, best_so_far,
                normals, params)
        result = sharding.sharded_multistart_optimize_batched_gated(
            bvg, rep, starts, params, group, chunk_size=chunk_size,
            conv_tol=conv_tol, step_fn=step_fn)
    else:
        result = optimizers.multistart_optimize(vg, rep, starts, params,
                                                conv_tol=conv_tol)
    return result.best_point


# ---------------------------------------------------------------------------
# Heuristic batch policies (constant liar, kriging believer)
# ---------------------------------------------------------------------------

def constant_liar_estimate(state, point, lie_value,
                           lie_noise_variance: float = 0.0):
    """The constant liar's fantasy at a point: (lie_value, its noise)."""
    del state, point
    return lie_value, lie_noise_variance


def kriging_believer_estimate(state, point, std_deviation_coef: float = 0.0,
                              kriging_noise_variance: float = 0.0):
    """The kriging believer's fantasy at a point: (mu(x) + c sigma(x), its
    noise)."""
    pts = point.reshape(1, -1)
    mu = gp.posterior_mean(state, pts)[0, 0]
    if std_deviation_coef:
        var = gp.posterior_variance(state, pts)[0, 0]
        mu = mu + std_deviation_coef * torch.sqrt(torch.clamp(var, min=0.0))
    return mu, kriging_noise_variance


def heuristic_expected_improvement_optimization(
        generator: torch.Generator, state: gp.GaussianProcessState, domain,
        num_to_sample: int, params: optimizers.GradientDescentParameters,
        estimation_policy: Optional[Callable] = None, best_so_far=None,
        num_mc_iterations: int = 1000, program_cache=None) -> torch.Tensor:
    """q points picked one at a time (heuristic q-EI): each round maximizes
    one GP's 1,0-EI, fantasizes an observation there by
    ``estimation_policy(state, point) -> (value, noise)`` (the kriging
    believer by default) and refits.

    The fantasy slots are shape-stable: the training set is padded once
    with q rows at the domain's centre carrying PAD_NOISE, which keep the
    state's own ``point_noise``; each round fills one slot and refits with
    the prior mean fixed.  With a ``program_cache`` (and ``CAPTURE``
    "auto") the refit is one program over the padded data, built once and
    replayed q + 1 times (the JAX package's jitted ``refit``), and each
    round's multistart takes its GD steps through programs.  Returns
    (num_to_sample, dim)."""
    from cornell_moe_tpu_torch.models.mcmc import PAD_NOISE

    if best_so_far is None:
        best_so_far = state.best_observed_value
    if estimation_policy is None:
        estimation_policy = kriging_believer_estimate
    n0, q = state.num_sampled, num_to_sample
    x0 = state.points_sampled
    kw = dict(dtype=x0.dtype, device=x0.device)
    c = 1 + state.num_derivatives
    center = torch.mean(domain.bounds.to(**kw), dim=1)
    x_pad = torch.cat([x0, center.expand(q, -1)])
    y_pad = torch.cat([state.points_sampled_value,
                       torch.zeros((q, c), **kw)])
    pn = torch.zeros((n0 + q, c), **kw)
    pn[n0:] = PAD_NOISE
    if state.point_noise is not None:
        pn[:n0] = state.point_noise

    cov_type, ds = type(state.covariance), state.derivatives

    def factors(hypers, noise, xx, yy, p, mean):
        return gp.fit_factors(cov_type(hyperparameters=hypers), noise, xx, yy,
                              p, ds, mean=mean)

    def refit():
        fit = gp.fit_inputs(state.covariance, state.noise_variance, x_pad,
                            y_pad, ds, point_noise=pn)
        noise, xx, yy, p, _ = fit
        return gp.assemble_state(state.covariance, *fit, *programs.run(
            program_cache, ("heuristic_refit", cov_type, ds), factors,
            state.covariance.hyperparameters, noise, xx, yy, p, state.mean))

    cur = refit()
    chosen = []
    for i in range(q):
        pt = multistart_expected_improvement_optimization(
            generator, cur, domain, 1, params, best_so_far=best_so_far,
            num_mc_iterations=num_mc_iterations,
            program_cache=program_cache)
        value, fantasy_noise = estimation_policy(cur, pt)
        # the refitted state holds these tensors: fill copies
        x_pad, y_pad, pn = x_pad.clone(), y_pad.clone(), pn.clone()
        x_pad[n0 + i] = pt.reshape(-1)
        y_pad[n0 + i, 0] = value
        y_pad[n0 + i, 1:] = 0.0
        pn[n0 + i] = fantasy_noise
        cur = refit()
        chosen.append(pt.reshape(1, -1))
    return torch.cat(chosen)
