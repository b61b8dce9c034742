"""MCMC-averaged q-Knowledge-Gradient, d-KG and continuous-fidelity KG
(cf-KG), and posterior-mean optimization.

Counterpart of ``cornell_moe_tpu/acquisition/knowledge_gradient.py``.
Every function takes an ensemble state with a leading axis S and works on
all members at once, where the JAX package vmaps over them; the single-GP
surface (:func:`knowledge_gradient_value_and_grad`,
:func:`multistart_knowledge_gradient_optimization`,
:func:`posterior_mean_optimization`) takes one GP and runs it as an
ensemble of one.  A union is the points to sample followed by the points
being sampled: gradients flow to the former only, and the fidelity cost
counts the former only.  The state may observe derivative channels
(``state.derivatives``), and the fantasy observations at the union may
include the derivative channels ``derivatives_to_sample`` (d-KG): each
union point then carries 1 + ms channels, q_ch = q (1 + ms) in all.  With
``num_fidelity`` > 0 the last ``num_fidelity`` coordinates are fidelity
dims: the inner problem works on the first ``dim_opt = d - num_fidelity``
coordinates with the fidelity coordinates pinned to 1, and the ensemble KG
is divided by the union's cost (cf-KG).

Semantics (minimization):
  * KG(U) = E_z[ best_posterior - min_x mu'_z(x) ],
    best_posterior = min(best_so_far, min_j mu(U_j))
  * fantasy observations y_U = mu_U + C z, C = chol(PostCov(U) + noise),
    the noise per channel
  * the fantasized mean collapses to
        mu'_z(x) = mean + k(x, X) (K^-1 y - V z) + k(x, U) C^-T z,
        V = K^-1 K(X, U) C^-T
  * the inner minimization starts from the best point of the
    discretization (discrete_pts ++ union) and is GD-polished under the
    frozen (detached) fantasy model: gradients wrt U follow the envelope
    theorem.

Dispatch rule of the inner descent (:func:`descent_kernel_for`): CUDA,
float32, value channels on both sides and shapes the kernel takes
(``kernels.descent_shapes_supported``) run the whole descent in the
hand-written kernel ``ops.kernels.descent_run``.  Otherwise value channels
take the analytic moment gradient (:func:`_make_descent_grad_fn`), and
derivative channels and fidelity dims the autograd gradient of the summed
frozen fantasy mean (:func:`_make_fantasy_mean_grad_fn`), each driven by
``optimizers.gradient_ascent_batch``, as in the JAX package.  The per-step
route (:func:`_descent_grad_bvg`: one ``ops.kernels.descent_grad`` launch
per GD step, the steps taken by ``gradient_ascent_batch``) is the
counterpart of the JAX package's ``_pallas_descent_bvg``; as there, the
dispatch never selects it, and only its callers (the tests,
``chip_smoke.py``) reach it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.acquisition.expected_improvement import (
    _batch_unions, _union, _with_member_axes, draw_antithetic_normals)
from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.models.gp import GaussianProcessState
from cornell_moe_tpu_torch.ops import kernels, linalg, optimizers, programs
from cornell_moe_tpu_torch.ops.domains import (RepeatedDomain,
                                               TensorProductDomain)
from cornell_moe_tpu_torch.parallel import sharding


# ---------------------------------------------------------------------------
# Posterior mean as an optimizable objective
# ---------------------------------------------------------------------------

def _pin_fidelity(x_opt: torch.Tensor, num_fidelity: int) -> torch.Tensor:
    """Lift points (..., dim_opt) to full dim with the fidelity coordinates
    pinned to 1.0."""
    if num_fidelity == 0:
        return x_opt
    ones = torch.ones(x_opt.shape[:-1] + (num_fidelity,), dtype=x_opt.dtype,
                      device=x_opt.device)
    return torch.cat([x_opt, ones], dim=-1)


def fidelity_cost(union: torch.Tensor, num_to_sample: int,
                  num_fidelity: int) -> torch.Tensor:
    """cost = max_i prod(fidelity coords of point i), i over the first
    num_to_sample points of a union (q, d), or of each union of a batch
    (..., q, d): (...).  The product is
    a chain of multiplications over the fidelity columns (with one column,
    the column itself), so its gradient is the product of the other
    columns, as ``jnp.prod``'s, and reads nothing from the host (the
    backward of ``torch.prod`` looks for zeros there), which lets a CUDA
    graph hold cf-KG's outer step."""
    if num_fidelity == 0:
        return torch.ones(union.shape[:-2], dtype=union.dtype,
                          device=union.device)
    fid = union[..., :num_to_sample, union.shape[-1] - num_fidelity:]
    prod = fid[..., 0]
    for j in range(1, num_fidelity):
        prod = prod * fid[..., j]
    return torch.max(prod, dim=-1).values


def inner_domain(domain: TensorProductDomain, num_fidelity: int
                 ) -> TensorProductDomain:
    """The inner problem's domain: the first dim - num_fidelity
    coordinates."""
    return TensorProductDomain(bounds=domain.bounds[:domain.dim -
                                                    num_fidelity])


def posterior_mean_objective(state: GaussianProcessState,
                             x_opt: torch.Tensor, num_fidelity: int = 0
                             ) -> torch.Tensor:
    """-posterior_mean at the fidelity-pinned x (..., dim_opt) for a state
    with the same batch axes (maximized)."""
    x = _pin_fidelity(x_opt, num_fidelity)
    return -gp_mod.posterior_mean(state, x[..., None, :])[..., 0, 0]


def _posterior_mean_bvg(state: GaussianProcessState, num_fidelity: int):
    """x (..., k, dim_opt), k points per member -> (-mu (..., k), its
    gradient) by autograd."""
    def bvg(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            v = -gp_mod.posterior_mean(
                state, _pin_fidelity(xx, num_fidelity))[..., 0]
            (g,) = torch.autograd.grad(v.sum(), xx)
        return v.detach(), g
    return bvg


def compute_optimal_posterior_mean(
        state: GaussianProcessState, domain, initial_guesses: torch.Tensor,
        params: optimizers.GradientDescentParameters, num_fidelity: int = 0,
        top_k: int = 1, program_cache=None):
    """Per member, maximize -mu from the ``top_k`` best of its guesses
    (..., G, dim_opt) over the inner ``domain``, fidelity coordinates
    pinned to 1, and keep the best end (non-finite values lose).

    Returns (best_point (..., dim_opt), best_value = -mu there (...)).
    Each start's value depends only on its own point, so one batched GD
    over the members and their starts equals one GD per start, as the JAX
    package's multistart.  With a ``program_cache`` (and ``CAPTURE``
    "auto") each GD step is one program (the step size an input), replayed
    for every step of ``params``' schedule; the domain must then be a
    ``TensorProductDomain``.
    """
    vals = -gp_mod.posterior_mean(
        state, _pin_fidelity(initial_guesses, num_fidelity))[..., 0]
    idx = torch.topk(vals, min(top_k, initial_guesses.shape[-2]),
                     dim=-1).indices
    starts = torch.gather(initial_guesses, -2, idx[..., None].expand(
        idx.shape + (initial_guesses.shape[-1],)))
    bvg = _posterior_mean_bvg(state, num_fidelity)
    step_fn = None
    if program_cache is not None and programs.enabled():
        tensors, layout = gp_mod.state_tensors(state, gp_mod.MEAN_FIELDS)

        def step(x, rate, bounds, *ts):
            _, g = _posterior_mean_bvg(gp_mod.state_from_tensors(layout, ts),
                                       num_fidelity)(x)
            return optimizers.ascent_step(
                TensorProductDomain(bounds=bounds),
                params.max_relative_change, x, g, rate)

        step_fn = program_cache.stepper(
            ("posterior_mean_step", tuple(t.shape for t in tensors), layout,
             num_fidelity, params.max_relative_change, starts.dtype,
             str(starts.device)), step, domain.bounds, *tensors)
    x = optimizers.gradient_ascent_batch(bvg, domain, starts, params,
                                         step_fn=step_fn)
    vals = bvg(x)[0]
    best = torch.argmax(torch.where(torch.isfinite(vals), vals,
                                    float("-inf")), dim=-1)
    return torch.gather(x, -2, best[..., None, None].expand(
        best.shape + (1, x.shape[-1])))[..., 0, :], \
        torch.gather(vals, -1, best[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Fantasy model
# ---------------------------------------------------------------------------

def _channel_noise(state: GaussianProcessState, c: int) -> torch.Tensor:
    """Per-channel fantasy observation noise, (S, c): the state's channel
    noise, channels it does not observe taking the value channel's."""
    nv = state.noise_variance
    if nv.shape[-1] < c:
        nv = torch.cat([nv, nv[..., :1].expand(
            nv.shape[:-1] + (c - nv.shape[-1],))], dim=-1)
    return nv[..., :c]


def _noise_diag(state: GaussianProcessState, q: int, c: int
                ) -> torch.Tensor:
    """Fantasy observation noise over the union's channels: (S, q c)."""
    nv = _channel_noise(state, c)
    return nv.repeat((1,) * (nv.dim() - 1) + (q,))


def _build_fantasy_model(state: GaussianProcessState, union: torch.Tensor,
                         derivatives_to_sample: Sequence[int] = ()):
    """(mu_u (S, q_ch), chol_u (S, q_ch, q_ch), v (S, N, q_ch)) for one
    union (q, d)."""
    ds = cov_mod.channels(derivatives_to_sample)
    q = union.shape[0]
    mu_u = gp_mod.posterior_mean(state, union, ds)
    mu_u = mu_u.reshape(mu_u.shape[:-2] + (-1,))
    var_u = linalg.symmetrize(gp_mod.posterior_variance(state, union, ds))
    min_diag = torch.min(torch.diagonal(var_u, dim1=-2, dim2=-1), dim=-1)
    repair = torch.clamp(-1.5 * min_diag.values, min=0.0).detach()
    chol_u = linalg.cholesky(var_u + torch.diag_embed(
        _noise_diag(state, q, 1 + len(ds)) + repair[..., None]))
    k_xu = gp_mod._mix_cov(state, union, ds)
    if state.inv_chol_K is not None:
        w = linalg.cho_solve_with_refinement(state.chol_K, state.inv_chol_K,
                                             k_xu)
    else:
        w = linalg.cho_solve(state.chol_K, k_xu)
    v = linalg.solve_triangular(chol_u, w.transpose(-1, -2),
                                lower=True).transpose(-1, -2)
    return mu_u, chol_u, v


def _build_fantasy_model_batch(state: GaussianProcessState,
                               unions: torch.Tensor,
                               derivatives_to_sample: Sequence[int] = ()):
    """Batched fantasy precompute for unions (B, q, d).

    Returns (mu_u (S, B, q_ch), chol_u (S, B, q_ch, q_ch), v (S, B, N,
    q_ch), noise_eff (S, B, q_ch)), noise_eff being the diagonal shift
    (channel noise + the float32 repair) inside chol_u.  Its solve pair
    takes the bfloat16 route where ``config.kg_fantasy_lowp_enabled``
    says so (every program's key holds ``config.KG_FANTASY_LOWP``,
    ``programs.keyed_switch``).
    """
    ds = cov_mod.channels(derivatives_to_sample)
    b, q, dim = unions.shape
    c = 1 + len(ds)
    k_xu = gp_mod._mix_cov(state, unions.reshape(b * q, dim), ds)
    s, n = k_xu.shape[0], k_xu.shape[1]                     # (S,N,B*q_ch)
    mu_u = (k_xu.transpose(-1, -2) @ state.K_inv_y[..., None])[..., 0]
    mu_u = mu_u.reshape(s, b, q, c)
    mu_u = torch.cat([mu_u[..., :1] + state.mean[:, None, None, None],
                      mu_u[..., 1:]], dim=-1).reshape(s, b, q * c)
    lowp = state.inv_chol_K.to(torch.bfloat16) \
        if config.kg_fantasy_lowp_enabled(k_xu.dtype) else None
    va, w = linalg.fantasy_solves_rhs_grad_only(
        state.chol_K, state.inv_chol_K, k_xu, inv_chol_lowp=lowp)
    va = va.reshape(s, n, b, q * c)
    prior_u = cov_mod.build_block_covariance(
        _with_member_axes(state.covariance, 1), unions, ds, unions, ds)
    var_u = linalg.symmetrize(
        prior_u - torch.einsum("snbi,snbj->sbij", va, va))
    min_diag = torch.min(torch.diagonal(var_u, dim1=-2, dim2=-1), dim=-1)
    repair = torch.clamp(-1.5 * min_diag.values, min=0.0).detach()
    noise_eff = _noise_diag(state, q, c)[:, None, :] + repair[..., None]
    chol_u = linalg.cholesky_small(var_u + torch.diag_embed(noise_eff))
    w = w.reshape(s, n, b, q * c).permute(0, 2, 3, 1)       # (S,B,q_ch,N)
    v = linalg.solve_triangular_small(chol_u, w).transpose(-1, -2)
    return mu_u, chol_u, v, noise_eff


def _kernel_rows_flat(state: GaussianProcessState, x: torch.Tensor
                      ) -> torch.Tensor:
    """k(x, X_train) over the state's channels for x (S, P, d):
    (S, P, N)."""
    return cov_mod.build_block_covariance(state.covariance, x, (),
                                          state.points_sampled,
                                          state.derivatives)


def _union_rows(cov, x_full: torch.Tensor, unions: torch.Tensor,
                derivatives_to_sample: Sequence[int] = ()) -> torch.Tensor:
    """k(x, U_b) for x (S, B, M, d), unions (B, q, d): (S, B, M, q_ch)."""
    ds = cov_mod.channels(derivatives_to_sample)
    diff = x_full[..., :, None, :] - unions[:, None, :, :]   # (S,B,M,q,d)
    inv_l2 = 1.0 / cov.lengths[:, None, None, None, :] ** 2
    s = torch.sum(diff * diff * inv_l2, dim=-1)
    if not ds:
        return cov.f0(s)
    p = cov.p(s)
    t = diff * inv_l2
    rows = torch.stack([cov.f0(s)] + [p * t[..., c] for c in ds], dim=-1)
    return rows.reshape(rows.shape[:-2] + (-1,))


def _fantasy_mean_batch(state: GaussianProcessState, x: torch.Tensor,
                        unions: torch.Tensor, v: torch.Tensor,
                        betas: torch.Tensor, normals: torch.Tensor,
                        derivatives_to_sample: Sequence[int] = (),
                        num_fidelity: int = 0) -> torch.Tensor:
    """mu'_z at x (S, B, M, dim_opt), fidelity coordinates pinned to 1, for
    every (member, union, draw): (S, B, M).

    mu' = mean + k_x K^-1 y - (k_x V_b) z_m + k_xu beta_bm, one pass over
    the kernel rows against W = [K^-1 y | V].
    """
    x = _pin_fidelity(x, num_fidelity)
    s, b, m, d = x.shape
    k_rows = _kernel_rows_flat(state, x.reshape(s, b * m, d)).reshape(
        s, b, m, -1)
    kiy = state.K_inv_y[:, None, :, None].expand(s, b, -1, 1)
    out = k_rows @ torch.cat([kiy, v], dim=-1)              # (S,B,M,1+q_ch)
    t2 = torch.sum(out[..., 1:] * normals, dim=-1)
    t3 = torch.sum(_union_rows(state.covariance, x, unions,
                               derivatives_to_sample) * betas, dim=-1)
    return state.mean[:, None, None] + out[..., 0] - t2 + t3


# ---------------------------------------------------------------------------
# Inner descent: kernel path and plain path
# ---------------------------------------------------------------------------

# Kernel A's switch, as the JAX package's: "auto" takes the descent kernel
# where :func:`descent_kernel_for` allows it, "never" the plain route.  The
# KG programs read it when they are captured, so its value is part of every
# program's key (``programs.keyed_switch``).
DESCENT_PALLAS = "auto"
programs.keyed_switch("knowledge_gradient.DESCENT_PALLAS",
                      lambda: DESCENT_PALLAS)


def descent_kernel_for(device_type: str, dtype: torch.dtype,
                       kernel_name: str, derivatives: Sequence[int],
                       derivatives_to_sample: Sequence[int], d: int, q: int,
                       num_fidelity: int = 0) -> Optional[str]:
    """Kernel A's gate: the kernel's name when the inner descent goes
    through ``kernels.descent_run`` (CUDA, float32, a covariance it knows,
    no derivative channel observed or sampled, no fidelity dim, d
    dimensions and q union points it takes, ``DESCENT_PALLAS`` "auto"),
    else None for the plain route."""
    if not config.switch_on("knowledge_gradient.DESCENT_PALLAS",
                            DESCENT_PALLAS) or \
            device_type != "cuda" or dtype != torch.float32 or \
            kernel_name not in cov_mod.COVARIANCE_TYPES or \
            cov_mod.channels(derivatives) or \
            cov_mod.channels(derivatives_to_sample) or num_fidelity or \
            not kernels.descent_shapes_supported(d, q):
        return None
    return kernel_name


def _make_fantasy_mean_grad_fn(state: GaussianProcessState, unions_f, v_f,
                               betas_f, normals,
                               derivatives_to_sample: Sequence[int],
                               num_fidelity: int = 0):
    """Ascent direction of -mu' for x (S, B, M, dim_opt) by autograd of the
    summed frozen fantasy mean (each mu'_{sbm} depends on x_{sbm} alone):
    the inner descent over derivative channels or fidelity dims."""
    def bvg(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            mu = _fantasy_mean_batch(state, xx, unions_f, v_f, betas_f,
                                     normals, derivatives_to_sample,
                                     num_fidelity)
            (g,) = torch.autograd.grad(-mu.sum(), xx)
        return torch.zeros(x.shape[:3], dtype=x.dtype, device=x.device), g

    return bvg


def _pack_descent_inputs(state: GaussianProcessState, unions_f, v_f,
                         betas_f, normals):
    """Kernel operands in scaled coordinates with the amplitude folded in:
    (ws (S,d,N), wt (S,B,Wr,N), beta (S,B,q,M), z (q,M), us (S,B,q,d)),
    W = c [K^-1 y | V | (those) * ws_dd], c = p_scale * alpha."""
    cov = state.covariance
    lengths = cov.lengths                                   # (S, d)
    s, n, d = state.points_sampled.shape
    b, q = unions_f.shape[:2]
    c = (cov.p_scale * cov.alpha)[:, None, None, None]
    ws = (state.points_sampled / lengths[:, None, :]).transpose(-1, -2)
    u_rows = torch.cat([state.K_inv_y[:, None, None, :].expand(s, b, 1, n),
                        v_f.transpose(-1, -2)], dim=2)      # (S,B,1+q,N)
    moments = (u_rows[:, :, :, None, :] * ws[:, None, None]).reshape(
        s, b, (1 + q) * d, n)
    f32 = dict(dtype=torch.float32)
    wt = (c * torch.cat([u_rows, moments], dim=2)).to(**f32).contiguous()
    beta = (c * betas_f).transpose(-1, -2).to(**f32).contiguous()
    us = (unions_f[None] / lengths[:, None, None, :]).to(**f32).contiguous()
    return (ws.to(**f32).contiguous(), wt, beta,
            normals.T.to(**f32).contiguous(), us)


def _descent_full(state: GaussianProcessState, unions_f, v_f, betas_f,
                  normals, x0: torch.Tensor, domain, params,
                  kernel_name: str) -> torch.Tensor:
    """The whole inner descent through ``kernels.descent_run``; returns
    x_star (S, B, M, d)."""
    lengths = state.covariance.lengths
    ws, wt, beta, z, us = _pack_descent_inputs(state, unions_f, v_f,
                                               betas_f, normals)
    geom = torch.stack([domain.lower / lengths, domain.upper / lengths,
                        1.0 / lengths**2], dim=1).to(torch.float32)
    xs0 = (x0 / lengths[:, None, None, :]).transpose(-1, -2).to(
        torch.float32).contiguous()
    steps = int(params.max_num_steps)
    avg_n = max(int(params.num_steps_averaged), 0)
    if not 0 < avg_n <= steps:
        avg_n = 0
    xs = kernels.descent_run(
        xs0, ws, wt, beta, z, us, geom.contiguous(), kernel_name,
        steps=steps, restarts=max(int(params.max_num_restarts), 1),
        avg_n=avg_n, gamma=float(params.gamma),
        pre_mult=float(params.pre_mult),
        mrc=float(params.max_relative_change))
    return (xs.transpose(-1, -2) * lengths[:, None, None, :]).to(x0.dtype)


def _descent_grad_bvg(state: GaussianProcessState, unions_f, v_f, betas_f,
                      normals, kernel_name: str):
    """The inner descent's bvg through ``kernels.descent_grad``: x (S, B,
    M, d) -> (zeros (S, B, M), ascent direction of -mu' (S, B, M, d)), for
    ``optimizers.gradient_ascent_batch``.  One kernel launch per call."""
    lengths = state.covariance.lengths[:, None, None, :]    # (S,1,1,d)
    ops = _pack_descent_inputs(state, unions_f, v_f, betas_f, normals)

    def bvg(x):
        xs = (x / lengths).transpose(-1, -2).to(torch.float32).contiguous()
        g_sc = kernels.descent_grad(xs, *ops, kernel_name)
        g = g_sc.transpose(-1, -2).to(x.dtype) / lengths
        return torch.zeros(x.shape[:3], dtype=x.dtype, device=x.device), g

    return bvg


def _make_descent_grad_fn(state: GaussianProcessState, unions_f, v_f,
                          betas_f, normals):
    """Analytic ascent direction of -mu' for x (S, B, M, d).

    With w_eff = K^-1 y - V z_m:
        d mu'/dx_i = -sum_n p_n (x_i - X_ni)/l_i^2 w_eff_n
                     - sum_j p^u_j (x_i - U_ji)/l_i^2 beta_j,
    and the training sum contracts into moments of X against
    W = [K^-1 y | V | K^-1 y * X | V * X].
    """
    cov = state.covariance
    pts = state.points_sampled                              # (S, N, d)
    s, n, d = pts.shape
    b, q = unions_f.shape[:2]
    inv_l2 = (1.0 / cov.lengths**2)[:, None, None, :]       # (S,1,1,d)
    kiy = state.K_inv_y
    w = torch.cat([
        kiy[:, None, :, None].expand(s, b, n, 1), v_f,
        (kiy[:, :, None] * pts)[:, None].expand(s, b, n, d),
        (v_f[..., None] * pts[:, None, :, None, :]).reshape(s, b, n, q * d)],
        dim=-1)                                             # (S,B,N,Wr)
    ws = pts / cov.lengths[:, None, :]

    def bvg(x):
        m = x.shape[2]
        xs = x / cov.lengths[:, None, None, :]
        diff = xs[:, :, :, None, :] - ws[:, None, None, :, :]
        p = cov.p(torch.sum(diff * diff, dim=-1))           # (S,B,M,N)
        a = p @ w                                           # (S,B,M,Wr)
        a0 = a[..., :1 + q]
        ax = a[..., 1 + q:].reshape(s, b, m, 1 + q, d)
        s0 = a0[..., 0] - torch.sum(a0[..., 1:] * normals, dim=-1)
        sx = ax[..., 0, :] - torch.sum(ax[..., 1:, :] * normals[..., None],
                                       dim=-2)
        grad_train = -(x * s0[..., None] - sx) * inv_l2
        diff_u = x[..., None, :] - unions_f[None, :, None]  # (S,B,M,q,d)
        t_u = diff_u * inv_l2[..., None, :]
        p_u = cov.p(torch.sum(diff_u * t_u, dim=-1))        # (S,B,M,q)
        grad_union = -torch.sum((p_u * betas_f)[..., None] * t_u, dim=-2)
        return torch.zeros(x.shape[:3], dtype=x.dtype, device=x.device), \
            -(grad_train + grad_union)

    return bvg


# ---------------------------------------------------------------------------
# KG estimators
# ---------------------------------------------------------------------------

def knowledge_gradient(state: GaussianProcessState, union: torch.Tensor,
                       discrete_pts: torch.Tensor, normals: torch.Tensor,
                       domain, inner_params, best_so_far,
                       derivatives_to_sample: Sequence[int] = (),
                       num_fidelity: int = 0) -> torch.Tensor:
    """Per-union MC q-KG for every member: (S,).

    ``union`` (q, d); ``discrete_pts`` (S, n_d, dim_opt) inner seeds;
    ``normals`` (M, q_ch); ``best_so_far`` (S,); ``domain`` the inner
    (dim_opt) domain.
    """
    ds = cov_mod.channels(derivatives_to_sample)
    s = state.points_sampled.shape[0]
    q, d = union.shape
    dim_opt = d - num_fidelity
    mu_u, chol_u, v = _build_fantasy_model(state, union, ds)
    best_posterior = torch.minimum(
        best_so_far, torch.min(mu_u.reshape(s, q, -1)[..., 0], dim=-1).values)
    union_f = union.detach()
    starts = torch.cat([discrete_pts,
                        union_f[:, :dim_opt].expand(s, q, dim_opt)], dim=1)
    starts_full = _pin_fidelity(starts, num_fidelity)

    betas = linalg.solve_triangular(
        chol_u, normals.T.expand(s, -1, -1), lower=True,
        trans=True).transpose(-1, -2)                       # (S, M, q_ch)
    alphas = state.K_inv_y[:, None, :] - normals @ v.transpose(-1, -2)

    k_sx = _kernel_rows_flat(state, starts_full)            # (S, n_s, N)
    k_su = cov_mod.build_block_covariance(state.covariance, starts_full, (),
                                          union_f, ds)      # (S, n_s, q_ch)
    mu_starts = state.mean[:, None, None] + \
        k_sx @ alphas.detach().transpose(-1, -2) + \
        k_su @ betas.detach().transpose(-1, -2)             # (S, n_s, M)
    idx = torch.argmin(mu_starts, dim=1)                    # (S, M)
    x0 = torch.gather(starts, 1, idx[..., None].expand(-1, -1, dim_opt))

    def mu_fn(x, alpha, beta, u):
        x = _pin_fidelity(x, num_fidelity)
        k_x = _kernel_rows_flat(state, x)
        k_u = cov_mod.build_block_covariance(state.covariance, x, (), u, ds)
        return state.mean[:, None] + torch.sum(k_x * alpha, dim=-1) + \
            torch.sum(k_u * beta, dim=-1)                   # (S, M)

    alphas_f, betas_f = alphas.detach(), betas.detach()

    def bvg(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            val = -mu_fn(xx, alphas_f, betas_f, union_f)
            (g,) = torch.autograd.grad(val.sum(), xx)
        return val.detach(), g

    x_star = optimizers.gradient_ascent_batch(bvg, domain, x0,
                                              inner_params).detach()
    best_min = torch.minimum(mu_fn(x_star, alphas, betas, union),
                             mu_fn(x0, alphas, betas, union))
    return torch.mean(best_posterior[:, None] - best_min, dim=1)


def _num_to_sample(unions: torch.Tensor, num_to_sample: Optional[int]
                   ) -> int:
    """The points to sample of unions (..., q + p, d): the first
    ``num_to_sample``, every point when None."""
    return unions.shape[-2] if num_to_sample is None else num_to_sample


def knowledge_gradient_mcmc(states: GaussianProcessState, union, discrete_pts,
                            normals, domain, inner_params, best_so_far,
                            derivatives_to_sample: Sequence[int] = (),
                            num_fidelity: int = 0,
                            num_to_sample: Optional[int] = None
                            ) -> torch.Tensor:
    """Ensemble mean of :func:`knowledge_gradient` divided by the fidelity
    cost of the union's first ``num_to_sample`` points (the points to
    sample; all of them when None)."""
    kg = torch.mean(knowledge_gradient(states, union, discrete_pts, normals,
                                       domain, inner_params, best_so_far,
                                       derivatives_to_sample, num_fidelity))
    return kg / fidelity_cost(union, _num_to_sample(union, num_to_sample),
                              num_fidelity)


def evaluate_knowledge_gradient_at_point_list(
        state: GaussianProcessState, points_list: torch.Tensor,
        discrete_pts: torch.Tensor, normals: torch.Tensor, domain,
        inner_params, best_so_far,
        derivatives_to_sample: Sequence[int] = (),
        num_fidelity: int = 0) -> torch.Tensor:
    """Per-union KG (:func:`knowledge_gradient`) at each candidate block of
    ``points_list`` (P, q, d), or (P, d) for single points: (P, S), one
    value per block and member."""
    pts = points_list if points_list.dim() == 3 else points_list[:, None, :]
    return torch.stack([knowledge_gradient(
        state, u, discrete_pts, normals, domain, inner_params, best_so_far,
        derivatives_to_sample, num_fidelity) for u in pts])


def knowledge_gradient_batch(state: GaussianProcessState,
                             unions: torch.Tensor,
                             discrete_pts: torch.Tensor,
                             normals: torch.Tensor, domain, inner_params,
                             best_so_far, inner_x0=None,
                             derivatives_to_sample: Sequence[int] = (),
                             num_fidelity: int = 0,
                             warm_mode: str = "reseed",
                             return_x_star: bool = False):
    """KG at B unions (B, q, d) for every member: kg (S, B), and with
    ``return_x_star`` (kg, carried descent endpoints (S, B, M, dim_opt)).
    ``normals`` is (M, q_ch); ``discrete_pts`` (S, n_d, dim_opt);
    ``domain`` the inner (dim_opt) domain.  The one deliberate difference
    from the JAX package's function, which takes a single state (and is
    vmapped over an ensemble): the state here is an ensemble, and every
    output carries its member axis S.

    Cold (``inner_x0`` None): the descents start from the seeded argmins.
    Warm starts, from ``inner_x0``, come in two modes:

    * ``warm_mode="reseed"`` keeps the seeding over the discretized set (so
      the estimator is unchanged);
    * ``warm_mode="pure"`` skips it.  The guard is then the closed-form
      fantasy mean at the union points, mu'(U) = mu_U + C z - noise_eff
      beta (Sigma C^-T z with Sigma = C C^T - diag(noise_eff)), live in the
      unions; the union point that wins it is the reseed candidate.
      Value channels only, no fidelity dims.

    The returned endpoints re-seed any draw whose guard beat the descended
    endpoint.
    """
    ds = cov_mod.channels(derivatives_to_sample)
    s = state.points_sampled.shape[0]
    b, q, d = unions.shape
    dim_opt = d - num_fidelity
    pure = inner_x0 is not None and warm_mode == "pure"
    if pure and (state.derivatives or ds or num_fidelity):
        raise NotImplementedError(
            "pure warm-start KG requires value-only channels and no "
            "fidelity dims; use warm_mode='reseed' or the cold path")
    mu_u, chol_u, v, noise_eff = _build_fantasy_model_batch(state, unions,
                                                            ds)
    best_posterior = torch.minimum(
        best_so_far[:, None],
        torch.min(mu_u.reshape(s, b, q, -1)[..., 0], dim=-1).values)
    m, q_ch = normals.shape
    betas = linalg.solve_triangular_small(
        chol_u, normals.T.expand(s, b, q_ch, m), trans=True).transpose(-1, -2)

    unions_f = unions.detach()
    if pure:
        # the guard at the union points, closed form and live
        cz = torch.einsum("sbij,mj->sbim", chol_u, normals)  # (S,B,q,M)
        mu_union = mu_u[..., None] + cz - \
            noise_eff[..., None] * betas.transpose(-1, -2)
        mu_x0 = torch.min(mu_union, dim=2).values            # (S, B, M)
        idx = torch.argmin(mu_union.detach(), dim=2)         # (S, B, M)
        x0_seed = torch.gather(
            unions_f[None, :, :, :dim_opt].expand(s, b, q, dim_opt), 2,
            idx[..., None].expand(-1, -1, -1, dim_opt))
        x0 = inner_x0.detach()
    else:
        # seeding over the discretized set, factored through the q-dim
        # fantasy subspace, computed live (its minimum is the x0 guard)
        starts = torch.cat([discrete_pts[:, None].expand(s, b, -1, dim_opt),
                            unions_f[None, :, :, :dim_opt].expand(
                                s, b, q, dim_opt)], dim=2)
        n_s = starts.shape[2]
        starts_full = _pin_fidelity(starts, num_fidelity)
        k_sx = _kernel_rows_flat(state, starts_full.reshape(s, b * n_s, d)
                                 ).reshape(s, b, n_s, -1)
        k_su = _union_rows(state.covariance, starts_full, unions,
                           ds)                              # (S,B,n_s,q_ch)
        base = torch.einsum("sbpn,sn->sbp", k_sx, state.K_inv_y)
        ksv = k_sx @ v                                      # (S,B,n_s,q_ch)
        mu_starts = state.mean[:, None, None, None] + base[..., None] - \
            torch.sum(ksv[:, :, :, None, :] * normals, dim=-1) + \
            torch.sum(k_su[:, :, :, None, :] * betas[:, :, None], dim=-1)
        idx = torch.argmin(mu_starts.detach(), dim=2)       # (S, B, M)
        x0_seed = torch.gather(starts, 2,
                               idx[..., None].expand(-1, -1, -1, dim_opt))
        mu_x0 = torch.min(mu_starts, dim=2).values          # (S, B, M)
        x0 = x0_seed if inner_x0 is None else inner_x0.detach()

    v_f, betas_f = v.detach(), betas.detach()
    pts = state.points_sampled
    kernel_name = descent_kernel_for(pts.device.type, pts.dtype,
                                     state.covariance.name,
                                     state.derivatives, ds, d, q,
                                     num_fidelity)
    if kernel_name is not None:
        x_star = _descent_full(state, unions_f, v_f, betas_f, normals, x0,
                               domain, inner_params, kernel_name)
    else:
        if state.derivatives or ds or num_fidelity:
            bvg = _make_fantasy_mean_grad_fn(state, unions_f, v_f, betas_f,
                                             normals, ds, num_fidelity)
        else:
            bvg = _make_descent_grad_fn(state, unions_f, v_f, betas_f,
                                        normals)
        x_star = optimizers.gradient_ascent_batch(bvg, domain, x0,
                                                  inner_params)
    x_star = x_star.detach()

    mu_star = _fantasy_mean_batch(state, x_star, unions, v, betas, normals,
                                  ds, num_fidelity)
    kg = torch.mean(best_posterior[..., None] -
                    torch.minimum(mu_star, mu_x0), dim=-1)
    if not return_x_star:
        return kg
    won = (mu_star <= mu_x0).detach()[..., None]
    return kg, torch.where(won, x_star, x0_seed)


def knowledge_gradient_mcmc_batch(states, unions, discrete_pts, normals,
                                  domain, inner_params, best_so_far,
                                  inner_x0=None,
                                  derivatives_to_sample: Sequence[int] = (),
                                  num_fidelity: int = 0,
                                  warm_mode: str = "reseed",
                                  num_to_sample: Optional[int] = None,
                                  return_x_star: bool = False):
    """Ensemble-averaged batched KG divided by the fidelity cost of each
    union's first ``num_to_sample`` points (all when None), (B,); with
    ``return_x_star`` also the members' descent endpoints (S, B, M,
    dim_opt), as the JAX package's vmapped endpoints."""
    kg, x_star = knowledge_gradient_batch(
        states, unions, discrete_pts, normals, domain, inner_params,
        best_so_far, inner_x0, derivatives_to_sample, num_fidelity,
        warm_mode, return_x_star=True)
    costs = fidelity_cost(unions, _num_to_sample(unions, num_to_sample),
                          num_fidelity)
    kg = torch.mean(kg, dim=0) / costs
    return (kg, x_star) if return_x_star else kg


def knowledge_gradient_mcmc_batch_value_and_grad(
        states, unions, discrete_pts, normals, domain, inner_params,
        best_so_far, num_to_sample, num_fidelity: int = 0,
        derivatives_to_sample: Sequence[int] = ()):
    """((B,) values, (B, q, d) per-union gradients): the cold delegate of
    :func:`knowledge_gradient_mcmc_batch_vg_carry`, its carry dropped."""
    vals, grads, _ = knowledge_gradient_mcmc_batch_vg_carry(
        states, unions, discrete_pts, normals, domain, inner_params,
        best_so_far, derivatives_to_sample=derivatives_to_sample,
        num_fidelity=num_fidelity, num_to_sample=num_to_sample)
    return vals, grads


def knowledge_gradient_mcmc_batch_vg_carry(states, unions, discrete_pts,
                                           normals, domain, inner_params,
                                           best_so_far, inner_x0=None,
                                           derivatives_to_sample: Sequence[
                                               int] = (),
                                           num_fidelity: int = 0,
                                           warm_mode: str = "reseed",
                                           num_to_sample: Optional[int] = None
                                           ):
    """((B,) values, (B, q + p, d) gradients, endpoints (S, B, M,
    dim_opt)); the cost counts each union's first ``num_to_sample``
    points.

    Each union's value depends only on its own block, so the gradient of
    the sum is the per-union gradient.  It flows into the fidelity
    coordinates through the union and the cost.
    """
    with torch.enable_grad():
        u = unions.detach().requires_grad_(True)
        vals, x_star = knowledge_gradient_mcmc_batch(
            states, u, discrete_pts, normals, domain, inner_params,
            best_so_far, inner_x0, derivatives_to_sample, num_fidelity,
            warm_mode, num_to_sample, return_x_star=True)
        (grads,) = torch.autograd.grad(vals.sum(), u)
    return vals.detach(), grads, x_star


def multistart_knowledge_gradient_mcmc_optimization(
        generator: torch.Generator, states: GaussianProcessState, domain,
        num_to_sample: int, params: optimizers.GradientDescentParameters,
        inner_params: optimizers.GradientDescentParameters,
        discrete_pts: torch.Tensor, points_being_sampled=None,
        best_so_far=None, num_mc_iterations: int = 128,
        chunk_size: Optional[int] = None, conv_tol: Optional[float] = None,
        derivatives_to_sample: Sequence[int] = (),
        num_fidelity: int = 0, use_batched: bool = True,
        warm_start: bool = True, group=None,
        program_cache=None) -> torch.Tensor:
    """MCMC-averaged q-KG (d-KG with ``derivatives_to_sample``, cf-KG with
    ``num_fidelity``) suggestion; returns (num_to_sample, d).  The outer
    domain is all d coordinates (fidelity coordinates included), the inner
    one the first dim_opt.  ``points_being_sampled`` (p, d) follow every
    start block in its union (q + p points, the fantasy over all of them);
    the gradient moves the q points to sample alone, and the fidelity
    cost counts them alone.

    Three routes, as in the JAX package: ``warm_start`` (the default) runs
    the warm ("reseed") batched multistart, the inner descents starting
    from the previous outer step's argmins with one step instead of
    ``inner_params.max_num_steps``, gated by ``conv_tol``; ``use_batched``
    without ``warm_start`` the cold batched multistart (no gate); neither,
    the per-start multistart through :func:`knowledge_gradient_mcmc`.  A
    ``group`` (``torch.distributed``) shards the restart axis over its
    ranks (``parallel.sharding``); ``chunk_size`` equal to the per-rank
    shard makes the batched routes equal to an unsharded run with that
    chunking (the per-start route takes no chunking).  With a
    ``program_cache`` (and ``CAPTURE`` "auto") the batched routes' cold
    evaluations (kernel A's full descent among them) and each warm outer
    step (the warm estimator, A's one-step launch among it, its gradient
    and the step) are one program each per chunk shape (``ops.programs``);
    the domain must then be a ``TensorProductDomain``."""
    ds = cov_mod.channels(derivatives_to_sample)
    if best_so_far is None:
        best_so_far = states.best_observed_value
    being = None if points_being_sampled is None or \
        points_being_sampled.numel() == 0 else \
        points_being_sampled.reshape(-1, states.dim)
    p = 0 if being is None else being.shape[0]
    q = num_to_sample
    inner = inner_domain(domain, num_fidelity)
    rep = RepeatedDomain(domain=domain, num_repeats=q)
    starts = rep.generate_latin_hypercube_points(generator,
                                                 params.num_multistarts)
    normals = draw_antithetic_normals(generator, num_mc_iterations,
                                      (q + p) * (1 + len(ds)),
                                      device=starts.device,
                                      dtype=starts.dtype)

    inner_warm = dataclasses.replace(inner_params, max_num_steps=1,
                                     max_num_restarts=1,
                                     num_steps_averaged=0)

    def vg_carry(pts_batch, carry=None, inner_p=inner_params):
        vals, grads, xs = knowledge_gradient_mcmc_batch_vg_carry(
            states, _batch_unions(pts_batch, being), discrete_pts, normals,
            inner, inner_p, best_so_far, inner_x0=carry,
            derivatives_to_sample=ds, num_fidelity=num_fidelity,
            num_to_sample=q)
        return vals, grads[:, :q], xs

    bvg_cold, warm_step = vg_carry, None
    if program_cache is not None and programs.enabled():
        bvg_cold, warm_step = _kg_step_programs(
            program_cache, states, domain, q, being, discrete_pts, normals,
            inner_params, inner_warm, best_so_far, ds, num_fidelity, params)

    if use_batched and warm_start:
        res = sharding.sharded_multistart_optimize_batched_warm(
            bvg_cold, lambda x, carry: vg_carry(x, carry, inner_warm), rep,
            starts, params, group, chunk_size=chunk_size, conv_tol=conv_tol,
            warm_step=warm_step)
    elif use_batched:
        res = sharding.sharded_multistart_optimize_batched_gated(
            lambda u: bvg_cold(u)[:2], rep, starts, params, group,
            chunk_size=chunk_size)
    else:
        def vg(pts):
            with torch.enable_grad():
                x = pts.detach().requires_grad_(True)
                val = knowledge_gradient_mcmc(
                    states, _union(x, being), discrete_pts, normals, inner,
                    inner_params, best_so_far, ds, num_fidelity, q)
                (g,) = torch.autograd.grad(val, x)
            return val.detach(), g

        res = sharding.sharded_multistart_optimize(vg, rep, starts, params,
                                                   group)
    return res.best_point


def _kg_step_programs(program_cache, states, domain, q: int, being,
                      discrete_pts, normals, inner_params, inner_warm,
                      best_so_far, ds, num_fidelity: int, params):
    """The batched KG multistart's evaluations as programs, one per chunk
    shape: the cold ``bvg_cold(x) -> (values, gradients, carry)`` (kernel
    A's full descent among it) and the warm outer step ``warm_step(x,
    carry, rate) -> (x_new, dx, carry)`` (its one-step descent, the
    gradient and the step); x is a chunk of starts (B, q, d) and carry its
    inner endpoints (S, B, M, dim_opt)."""
    if not isinstance(domain, TensorProductDomain):
        raise TypeError("the KG step's program takes a TensorProductDomain, "
                        f"got {type(domain).__name__}")
    tensors, layout = gp_mod.state_tensors(states)
    extra = () if being is None else (being,)
    inputs = (domain.bounds, discrete_pts, normals,
              torch.as_tensor(best_so_far), *tensors, *extra)
    key = (tuple(t.shape for t in tensors), layout,
           tuple(discrete_pts.shape), tuple(normals.shape),
           tuple(t.shape for t in extra), q, ds, num_fidelity, normals.dtype,
           str(normals.device))

    def vg_carry(x, carry, inner_p, bounds, disc, nrm, best, *rest):
        vals, grads, xs = knowledge_gradient_mcmc_batch_vg_carry(
            gp_mod.state_from_tensors(layout, rest[:len(tensors)]),
            _batch_unions(x, rest[len(tensors)] if extra else None), disc,
            nrm, inner_domain(TensorProductDomain(bounds=bounds),
                              num_fidelity), inner_p, best, inner_x0=carry,
            derivatives_to_sample=ds, num_fidelity=num_fidelity,
            num_to_sample=q)
        return vals, grads[:, :q], xs

    def cold(x, *args):
        return vg_carry(x, None, inner_params, *args)

    def step(x, carry, rate, bounds, *args):
        _, grads, xs = vg_carry(x, carry, inner_warm, bounds, *args)
        x_new, dx = optimizers.ascent_step(
            RepeatedDomain(domain=TensorProductDomain(bounds=bounds),
                           num_repeats=q), params.max_relative_change, x,
            grads, rate)
        return x_new, dx, xs

    def bvg_cold(x):
        return program_cache.get(("kg_cold",) + key + (
            inner_params, tuple(x.shape)), cold)(x, *inputs)

    return bvg_cold, program_cache.stepper(
        ("kg_warm_step",) + key + (inner_warm, params.max_relative_change),
        step, *inputs)


def score_knowledge_gradient_mcmc(states: GaussianProcessState, union,
                                  discrete_pts, normals, domain,
                                  inner_params, best_so_far,
                                  derivatives_to_sample: Sequence[int] = (),
                                  num_fidelity: int = 0,
                                  program_cache=None) -> torch.Tensor:
    """:func:`knowledge_gradient_mcmc` at one union (q, d), every point of
    it to sample: the suggestion's VOI.  With a ``program_cache`` (and
    ``CAPTURE`` "auto") one program per shapes, its inner descents
    included; ``domain`` (the inner one) must then be a
    ``TensorProductDomain``."""
    ds = cov_mod.channels(derivatives_to_sample)
    tensors, layout = gp_mod.state_tensors(states)

    def score(u, bounds, disc, nrm, best, *ts):
        return knowledge_gradient_mcmc(
            gp_mod.state_from_tensors(layout, ts), u, disc, nrm,
            TensorProductDomain(bounds=bounds), inner_params, best, ds,
            num_fidelity)

    return programs.run(
        program_cache, ("kg_score", layout, inner_params, ds, num_fidelity),
        score, union, domain.bounds, discrete_pts, normals,
        torch.as_tensor(best_so_far), *tensors)


# ---------------------------------------------------------------------------
# The single-GP surface (the compat layer's): one GP as an ensemble of one,
# through the per-union route (no kernel), as in the JAX package
# ---------------------------------------------------------------------------

def knowledge_gradient_value_and_grad(
        state: GaussianProcessState, points_to_sample: torch.Tensor,
        points_being_sampled, discrete_pts: torch.Tensor,
        normals: torch.Tensor, domain,
        inner_params: optimizers.GradientDescentParameters, best_so_far,
        num_fidelity: int = 0, derivatives_to_sample: Sequence[int] = ()):
    """One GP's KG at the union points_to_sample (q, d) ++
    points_being_sampled (p, d), and its gradient with respect to
    points_to_sample (q, d), by autograd of :func:`knowledge_gradient`.
    ``discrete_pts`` (n_d, dim_opt) inner seeds; ``normals`` (M, q_ch);
    ``best_so_far`` a scalar; ``domain`` the inner (dim_opt) domain."""
    pts = torch.atleast_2d(points_to_sample)
    being = None if points_being_sampled is None else \
        torch.atleast_2d(points_being_sampled)
    best = torch.as_tensor(best_so_far, dtype=pts.dtype,
                           device=pts.device).reshape(1)
    with torch.enable_grad():
        x = pts.detach().requires_grad_(True)
        kg = knowledge_gradient(state.as_ensemble(), _union(x, being),
                                discrete_pts[None], normals, domain,
                                inner_params, best, derivatives_to_sample,
                                num_fidelity)[0]
        (g,) = torch.autograd.grad(kg, x)
    return kg.detach(), g


def multistart_knowledge_gradient_optimization(
        generator: torch.Generator, state: GaussianProcessState, domain,
        num_to_sample: int, params: optimizers.GradientDescentParameters,
        inner_params: optimizers.GradientDescentParameters,
        discrete_pts: torch.Tensor, points_being_sampled=None,
        best_so_far=None, num_mc_iterations: int = 128,
        num_fidelity: int = 0, derivatives_to_sample: Sequence[int] = (),
        chunk_size: Optional[int] = None) -> torch.Tensor:
    """One GP's q-KG suggestion (ComputeKGOptimalPointsToSample): the
    per-start multistart of :func:`knowledge_gradient_value_and_grad` from
    Latin-hypercube start blocks, then antithetic normals over the union's
    (q + p)(1 + ms) channels, both drawn from ``generator``.  Returns
    (num_to_sample, d)."""
    ds = cov_mod.channels(derivatives_to_sample)
    if best_so_far is None:
        best_so_far = state.best_observed_value
    p = 0 if points_being_sampled is None else \
        torch.atleast_2d(points_being_sampled).shape[0]
    rep = RepeatedDomain(domain=domain, num_repeats=num_to_sample)
    starts = rep.generate_latin_hypercube_points(generator,
                                                 params.num_multistarts)
    normals = draw_antithetic_normals(generator, num_mc_iterations,
                                      (num_to_sample + p) * (1 + len(ds)),
                                      device=starts.device,
                                      dtype=starts.dtype)
    inner = inner_domain(domain, num_fidelity)

    def vg(pts):
        return knowledge_gradient_value_and_grad(
            state, pts, points_being_sampled, discrete_pts, normals, inner,
            inner_params, best_so_far, num_fidelity, ds)

    return optimizers.multistart_optimize(vg, rep, starts, params,
                                          chunk_size=chunk_size).best_point


def posterior_mean_optimization(
        state: GaussianProcessState, domain,
        params: optimizers.GradientDescentParameters,
        initial_guesses: torch.Tensor, num_fidelity: int = 0,
        top_k: int = 1):
    """Argmin of one GP's posterior mean (the recommendation step):
    :func:`compute_optimal_posterior_mean` over the inner (first dim -
    num_fidelity coordinates) domain from the ``top_k`` best of
    ``initial_guesses`` (G, dim_opt), the GP as an ensemble of one.
    Returns (point (dim_opt,), -mu there)."""
    pt, val = compute_optimal_posterior_mean(
        state.as_ensemble(), inner_domain(domain, num_fidelity),
        initial_guesses[None], params, num_fidelity, top_k)
    return pt[0], val[0]
