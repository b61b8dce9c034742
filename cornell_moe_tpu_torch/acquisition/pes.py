"""Predictive Entropy Search (PES) for the squared-exponential kernel.

Counterpart of ``cornell_moe_tpu/acquisition/pes.py`` (Hernandez-Lobato,
Hoffman & Ghahramani 2014): condition the GP on "x* is a global minimum"
(zero gradient, a positive diagonal of the Hessian, f(x*) below every
observation) by Expectation Propagation, and score candidates by the
entropy reduction

    alpha(x) = 0.5 log(v_n(x) + noise) - 0.5 log(v_n(x | x* min) + noise)

averaged over hyperparameter sets.

Every function is batched over leading axes of the hyperparameter sets
(sigma (M,), lengths (M, d), noise (M,), x* (M, d)), where the JAX package
vmaps; the observations x_samples (n, d) and y (n,) are shared.  EP runs a
fixed 60-step damped schedule, one program per sweep (``ops.programs``).
Sets whose EP or factorizations fail give non-finite values, which
:func:`pes_acquisition_multi` drops by a NaN-mean.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import torch

from cornell_moe_tpu_torch.ops import linalg, programs


# ---------------------------------------------------------------------------
# Derivative-operator covariances
# ---------------------------------------------------------------------------

def _se_kernel(sigma, lengths):
    def k(a, b):
        d = (a - b) / lengths
        return sigma * torch.exp(-0.5 * torch.dot(d, d))
    return k


def derivative_tensor(kernel, order_u: int, order_v: int):
    """(u, v) -> the tensor of every partial derivative of k of order
    ``order_v`` in v and ``order_u`` in u, by nested forward-mode autodiff
    (``torch.func.jacfwd``): its axes are v's partials, then u's, so the
    entry d^{du}_u d^{dv}_v k(u, v) sits at index dv + du."""
    f = kernel
    for _ in range(order_v):
        f = torch.func.jacfwd(f, argnums=1)
    for _ in range(order_u):
        f = torch.func.jacfwd(f, argnums=0)
    return f


def cov_deriv(kernel, du: Sequence[int], dv: Sequence[int]):
    """(u, v) -> d^{du}_u d^{dv}_v k(u, v) for partial-index tuples: the
    entry ``dv + du`` of :func:`derivative_tensor`."""
    tensor = derivative_tensor(kernel, len(du), len(dv))
    index = tuple(int(i) for i in dv) + tuple(int(i) for i in du)

    def f(u, v):
        return tensor(u, v)[index]
    return f


def _offdiag_indices(d: int):
    return [(i, j) for i in range(d) for j in range(i + 1, d)]


class PESChannels(NamedTuple):
    """Joint covariance over [y_n, grad*, offdiagH*, diagH*, f*]."""
    K: torch.Tensor       # (..., n_ch, n_ch) joint prior covariance
    n: int                # observations
    d: int                # dimension
    n_off: int            # d(d-1)/2


def _noise_diagonal(sigma, noise, n: int, n_ch: int, like: torch.Tensor
                    ) -> torch.Tensor:
    """diag(noise on the n values and f*, 0 elsewhere) + sigma 1e-10 I."""
    noise = torch.as_tensor(noise, dtype=like.dtype, device=like.device)
    sigma = torch.as_tensor(sigma, dtype=like.dtype, device=like.device)
    batch = torch.broadcast_shapes(noise.shape, sigma.shape)
    nz = noise.expand(batch)[..., None]
    diag = torch.cat([nz.expand(batch + (n,)),
                      torch.zeros(batch + (n_ch - n - 1,), dtype=like.dtype,
                                  device=like.device), nz], dim=-1)
    eye = torch.eye(n_ch, dtype=like.dtype, device=like.device)
    return torch.diag_embed(diag) + sigma[..., None, None] * 1e-10 * eye


def _build_pes_covariance_autodiff(x_samples: torch.Tensor,
                                   x_min: torch.Tensor, sigma, lengths,
                                   noise) -> PESChannels:
    """Autodiff oracle of :func:`build_pes_covariance` for one set (test
    use only): every entry read from the derivative tensors of the SE
    kernel (:func:`derivative_tensor`)."""
    n, d = x_samples.shape
    off = _offdiag_indices(d)
    k = _se_kernel(sigma, lengths)
    # (point index, partial-index tuple); index n is x*
    ops = [(i, ()) for i in range(n)]
    ops += [(n, (i,)) for i in range(d)]
    ops += [(n, (i, j)) for (i, j) in off]
    ops += [(n, (i, i)) for i in range(d)]
    ops += [(n, ())]
    points = torch.cat([x_samples, x_min[None]])
    tensors = {}

    def entry(a, du, b, dv):
        key = (a, len(du), b, len(dv))
        if key not in tensors:
            tensors[key] = derivative_tensor(k, len(du), len(dv))(
                points[a], points[b])
        return tensors[key][dv + du]

    big_k = torch.stack([torch.stack([entry(a, du, b, dv)
                                      for (b, dv) in ops])
                         for (a, du) in ops])
    big_k = big_k + _noise_diagonal(sigma, noise, n, len(ops), big_k)
    return PESChannels(K=big_k, n=n, d=d, n_off=len(off))


def _columns(t: torch.Tensor, index) -> torch.Tensor:
    """``t[..., index]`` for a list of last-axis indices, as one
    concatenation of slices: indexing by a list copies the index to the
    device, which a CUDA graph's capture refuses."""
    return torch.cat([t[..., i:i + 1] for i in index], dim=-1)


def _se_blocks(xs: torch.Tensor, x_min: torch.Tensor, sigma: torch.Tensor,
               inv_l: torch.Tensor, off):
    """Covariances of f at points xs (..., P, d) with [grad*, offdiagH*,
    diagH*, f*] at x*, in the scaled differences w = (x - x*) / l:
    (grad (..., P, d), offd (..., P, n_off), diag (..., P, d), f (..., P,
    1))."""
    inv_l2 = inv_l * inv_l
    w = (xs - x_min[..., None, :]) * inv_l[..., None, :]
    gk = sigma[..., None] * torch.exp(-0.5 * torch.sum(w * w, dim=-1))
    grad = gk[..., None] * w * inv_l[..., None, :]
    if off:
        oi = [i for (i, j) in off]
        oj = [j for (i, j) in off]
        offd = gk[..., None] * _columns(w, oi) * _columns(w, oj) * \
            (_columns(inv_l, oi) * _columns(inv_l, oj))[..., None, :]
    else:
        offd = w[..., :0]
    diag = gk[..., None] * (w * w - 1.0) * inv_l2[..., None, :]
    return grad, offd, diag, gk[..., None]


def build_pes_covariance(x_samples: torch.Tensor, x_min: torch.Tensor,
                         sigma, lengths, noise) -> PESChannels:
    """Joint prior covariance over the PES conditioning channels, per set.

    Channel order [values at X_n (+ noise), grad(x*) (d), offdiag Hess(x*)
    (d(d-1)/2), diag Hess(x*) (d), f(x*) (+ noise)], with sigma 1e-10
    jitter.  Every SE derivative block is a closed form in the scaled
    differences (the JAX package's ``build_pes_covariance``).
    """
    n, d = x_samples.shape
    off = _offdiag_indices(d)
    n_off = len(off)
    kw = dict(dtype=x_samples.dtype, device=x_samples.device)
    sigma = torch.as_tensor(sigma, **kw)
    lengths = torch.as_tensor(lengths, **kw)
    inv_l = 1.0 / lengths
    inv_l2 = inv_l * inv_l
    batch = torch.broadcast_shapes(sigma.shape, lengths.shape[:-1],
                                   x_min.shape[:-1])

    dw = (x_samples[:, None, :] - x_samples[None, :, :]) * \
        inv_l[..., None, None, :]
    aa = sigma[..., None, None] * torch.exp(-0.5 * torch.sum(dw * dw, dim=-1))
    ab, ac, ad, ae = _se_blocks(x_samples, x_min, sigma, inv_l, off)

    def z(r, c):
        return torch.zeros(batch + (r, c), **kw)

    eye = torch.eye(d, **kw)
    bb = sigma[..., None, None] * torch.diag_embed(inv_l2)
    if off:
        oi = [i for (i, j) in off]
        oj = [j for (i, j) in off]
        cc = sigma[..., None, None] * torch.diag_embed(inv_l2[..., oi] *
                                                       inv_l2[..., oj])
    else:
        cc = z(0, 0)
    dd = sigma[..., None, None] * (inv_l2[..., :, None] *
                                   inv_l2[..., None, :]) * (1.0 + 2.0 * eye)
    de = (-sigma[..., None] * inv_l2)[..., None]
    ee = sigma.reshape(batch + (1, 1))

    def t(a):
        return a.transpose(-1, -2)

    def row(*blocks):
        return torch.cat([blk.expand(batch + blk.shape[-2:])
                          for blk in blocks], dim=-1)

    big_k = torch.cat([
        row(aa, ab, ac, ad, ae),
        row(t(ab), bb, z(d, n_off), z(d, d), z(d, 1)),
        row(t(ac), z(n_off, d), cc, z(n_off, d), z(n_off, 1)),
        row(t(ad), z(d, d), z(d, n_off), dd, de),
        row(t(ae), z(1, d), z(1, n_off), t(de), ee)], dim=-2)
    big_k = big_k + _noise_diagonal(sigma, noise, n, big_k.shape[-1], big_k)
    return PESChannels(K=big_k, n=n, d=d, n_off=n_off)


def pes_cross_matrix(xs: torch.Tensor, x_samples: torch.Tensor,
                     x_min: torch.Tensor, sigma, lengths) -> torch.Tensor:
    """Cross-covariances of f(xs) with the conditioning channels: xs (..., P,
    d) -> (..., P, n + d + n_off + d + 1)."""
    d = x_samples.shape[-1]
    inv_l = 1.0 / lengths
    dw = (xs[..., :, None, :] - x_samples) * inv_l[..., None, None, :]
    vals = sigma[..., None, None] * torch.exp(-0.5 * torch.sum(dw * dw,
                                                               dim=-1))
    blocks = _se_blocks(xs, x_min, sigma, inv_l, _offdiag_indices(d))
    return torch.cat((vals,) + blocks, dim=-1)


def pes_cross_vector(x: torch.Tensor, x_samples: torch.Tensor,
                     x_min: torch.Tensor, sigma, lengths) -> torch.Tensor:
    """k(f(x), [y_n, grad*, offdiagH*, diagH*, f*]) for one point per set,
    x (..., d): (..., n_ch)."""
    return pes_cross_matrix(x[..., None, :], x_samples, x_min, sigma,
                            lengths)[..., 0, :]


# ---------------------------------------------------------------------------
# Expectation Propagation
# ---------------------------------------------------------------------------

class PESState(NamedTuple):
    """Per-hyperparameter-set precompute for the acquisition (leading axes
    of the sets on every field)."""
    k_plus_w_inv: torch.Tensor   # (..., n_ch, n_ch)
    c_and_m: torch.Tensor        # (..., n_ch)
    k_star_min: torch.Tensor     # (..., n_ch)
    m_f_min: torch.Tensor        # (...)
    v_f_min: torch.Tensor        # (...)
    x_min: torch.Tensor          # (..., d)
    sigma: torch.Tensor          # (...)
    lengths: torch.Tensor        # (..., d)
    noise: torch.Tensor          # (...)
    chol_kn: torch.Tensor        # (..., n, n) chol of K_n + noise I


def _phi_over_ndtr(alpha: torch.Tensor) -> torch.Tensor:
    """phi(a) / Phi(a), computed in log space."""
    return torch.exp(-0.5 * alpha**2 - 0.5 * math.log(2 * math.pi)
                     - torch.special.log_ndtr(alpha))


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (a @ v[..., None])[..., 0]


def _vmv(u: torch.Tensor, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(u @ a) @ v over the last axes."""
    return ((u[..., None, :] @ a) @ v[..., :, None])[..., 0, 0]


def _ep_step(d: int, m, v_inv, m_tilde, v_tilde_inv, damp, v_0_inv,
             v0_inv_m0, min_y, noise):
    """One damped EP sweep over the d diag-Hessian positivity sites and the
    soft f(x*) <= min y site: (m, v_inv, m_tilde, v_tilde_inv) after it.
    Reads nothing from the host (the inverse is ``inv_ex``'s), so it can be
    one program, ``damp`` a 0-d tensor."""
    v_bar = 1.0 / (v_inv - v_tilde_inv)
    m_bar = v_bar * (m * v_inv - m_tilde * v_tilde_inv)

    # diag-Hessian positivity factors (first d z-channels)
    mb_d, vb_d = m_bar[..., :d], v_bar[..., :d]
    alpha = mb_d / torch.sqrt(vb_d)
    ratio = _phi_over_ndtr(alpha)
    beta = ratio * (ratio + alpha) / vb_d
    kappa = (ratio + alpha) / torch.sqrt(vb_d)
    m_new_d = mb_d + 1.0 / kappa
    v_new_d_inv = beta / (1.0 - beta * vb_d)

    # soft "f(x*) <= min y" factor (last z-channel)
    mb_l = min_y - m_bar[..., -1]
    vb_l = v_bar[..., -1] + noise
    alpha_l = mb_l / torch.sqrt(vb_l)
    ratio_l = _phi_over_ndtr(alpha_l)
    beta_l = ratio_l * (ratio_l + alpha_l) / vb_l
    kappa_l = -(ratio_l + alpha_l) / torch.sqrt(vb_l)
    m_new_l = mb_l + 1.0 / kappa_l
    v_new_l_inv = beta_l / (1.0 - beta_l * vb_l)

    m_tilde_new = torch.cat([m_new_d, m_new_l[..., None]], dim=-1)
    v_tilde_new_inv = torch.cat([v_new_d_inv, v_new_l_inv[..., None]],
                                dim=-1)
    # stability guards as in the reference; 1e-300 is 0 in float32
    v_tilde_new_inv = torch.where(v_tilde_new_inv.abs() < 1e-300, 1e-300,
                                  v_tilde_new_inv)
    neg_cavity = v_inv < 0
    m_tilde_new = torch.where(neg_cavity, m_tilde, m_tilde_new)
    v_tilde_new_inv = torch.where(neg_cavity, v_tilde_inv, v_tilde_new_inv)
    # a failed site update keeps the old site
    bad = ~torch.isfinite(m_tilde_new) | ~torch.isfinite(v_tilde_new_inv)
    m_tilde_new = torch.where(bad, m_tilde, m_tilde_new)
    v_tilde_new_inv = torch.where(bad, v_tilde_inv, v_tilde_new_inv)

    m_tilde = damp * m_tilde_new + (1 - damp) * m_tilde
    v_tilde_inv = damp * v_tilde_new_inv + (1 - damp) * v_tilde_inv

    v_new = torch.linalg.inv_ex(linalg.symmetrize(
        torch.diag_embed(v_tilde_inv) + v_0_inv))[0]
    m = _mv(v_new, v_tilde_inv * m_tilde + v0_inv_m0)
    v_inv = 1.0 / torch.diagonal(v_new, dim1=-2, dim2=-1)
    return m, v_inv, m_tilde, v_tilde_inv


def expectation_propagation(channels: PESChannels, y: torch.Tensor,
                            hess_offdiag: torch.Tensor, noise,
                            num_iterations: int = 60,
                            damping: float = 0.5,
                            program_cache=None) -> tuple:
    """EP for the d positive-diagonal-Hessian factors and the soft
    f(x*) <= min(y) factor, a fixed damped schedule (damping 0.5 x 0.99^i).
    Returns (k_plus_w_inv, c_and_m, (m_tilde, v_tilde_inv)).  Each sweep is
    :func:`_ep_step`: with a ``program_cache`` (and ``programs.CAPTURE``
    "auto") one program per shapes, replayed ``num_iterations`` times with
    the damping as its input, the counterpart of the JAX package's
    ``lax.scan``."""
    kk, n, d, n_off = channels
    nc = n + d + n_off                 # c-channel count
    nz = d + 1                         # z-channel count
    kw = dict(dtype=y.dtype, device=y.device)
    batch = kk.shape[:-2]
    noise = torch.as_tensor(noise, **kw)

    k_c = kk[..., :nc, :nc]
    k_z = kk[..., nc:, nc:]
    k_zc = kk[..., nc:, :nc]
    c = torch.cat([y.expand(batch + y.shape), torch.zeros(batch + (d,), **kw),
                   hess_offdiag.expand(batch + hess_offdiag.shape[-1:])],
                  dim=-1)
    chol_c = linalg.cholesky(k_c)
    m_0 = _mv(k_zc, linalg.cho_solve(chol_c, c))
    v_0 = linalg.symmetrize(
        k_z - k_zc @ linalg.cho_solve(chol_c, k_zc.transpose(-1, -2)))
    eye = torch.eye(nz, **kw)
    v_0_inv = linalg.cho_solve(linalg.cholesky(v_0), eye.expand_as(v_0))
    min_y = torch.min(y)
    v0_inv_m0 = _mv(v_0_inv, m_0)

    m = m_0
    v_inv = 1.0 / torch.diagonal(v_0, dim1=-2, dim2=-1)
    m_tilde = torch.zeros(batch + (nz,), **kw)
    v_tilde_inv = torch.zeros(batch + (nz,), **kw)
    damps = damping * 0.99 ** torch.arange(num_iterations, **kw)
    step = functools.partial(_ep_step, d)
    for damp in damps:
        m, v_inv, m_tilde, v_tilde_inv = programs.run(
            program_cache, ("ep_step", d), step, m, v_inv, m_tilde,
            v_tilde_inv, damp, v_0_inv, v0_inv_m0, min_y, noise)

    w_diag = torch.cat([torch.zeros(batch + (nc,), **kw), 1.0 / v_tilde_inv],
                       dim=-1)
    k_plus_w_inv = torch.linalg.inv_ex(linalg.symmetrize(
        kk + torch.diag_embed(w_diag)))[0]
    return k_plus_w_inv, torch.cat([c, m_tilde], dim=-1), \
        (m_tilde, v_tilde_inv)


def make_pes_state(x_samples: torch.Tensor, y: torch.Tensor,
                   x_min: torch.Tensor, hess_at_min: torch.Tensor, sigma,
                   lengths, noise, num_ep_iterations: int = 60,
                   program_cache=None) -> PESState:
    """The per-set precompute (EP and the cross terms at x*): x_min (...,
    d), hess_at_min (..., d, d), sigma (...), lengths (..., d), noise
    (...); EP's sweeps through ``program_cache``'s programs when given."""
    kw = dict(dtype=y.dtype, device=y.device)
    sigma = torch.as_tensor(sigma, **kw)
    lengths = torch.as_tensor(lengths, **kw)
    noise = torch.as_tensor(noise, **kw)
    channels = build_pes_covariance(x_samples, x_min, sigma, lengths, noise)
    off = _offdiag_indices(channels.d)
    hess_off = hess_at_min[..., [i for (i, j) in off], [j for (i, j) in off]]
    k_plus_w_inv, c_and_m, _ = expectation_propagation(
        channels, y, hess_off, noise, num_ep_iterations,
        program_cache=program_cache)
    k_star_min = pes_cross_vector(x_min, x_samples, x_min, sigma, lengths)
    return PESState(
        k_plus_w_inv=k_plus_w_inv, c_and_m=c_and_m, k_star_min=k_star_min,
        m_f_min=_vmv(k_star_min, k_plus_w_inv, c_and_m),
        v_f_min=sigma - _vmv(k_star_min, k_plus_w_inv, k_star_min),
        x_min=x_min, sigma=sigma, lengths=lengths, noise=noise,
        chol_kn=linalg.cholesky(channels.K[..., :channels.n, :channels.n]))


# ---------------------------------------------------------------------------
# Acquisition
# ---------------------------------------------------------------------------

def pes_acquisition(x: torch.Tensor, state: PESState,
                    x_samples: torch.Tensor) -> torch.Tensor:
    """Entropy reduction at points x (P, d) for every set of ``state`` (to
    MAXIMIZE): (..., P)."""
    k_star = pes_cross_matrix(x, x_samples, state.x_min, state.sigma,
                              state.lengths)                 # (..., P, n_ch)
    sigma, noise = state.sigma[..., None], state.noise[..., None]
    kkw = k_star @ state.k_plus_w_inv
    m_f = _mv(kkw, state.c_and_m)
    v_f = sigma - torch.sum(kkw * k_star, dim=-1)
    v_f_cross = k_star[..., -1] - _mv(kkw, state.k_star_min)

    # conditioned variance given f(x) > f(x*) (truncated-Gaussian moment)
    v_sum = torch.clamp(v_f - 2.0 * (1 - 1e-4) * v_f_cross +
                        state.v_f_min[..., None], min=1e-10)
    alpha = (m_f - state.m_f_min[..., None]) / torch.sqrt(v_sum)
    beta = _phi_over_ndtr(alpha)
    shrink = (beta / v_sum) * (alpha + beta) * (v_f - v_f_cross) ** 2
    v_cond = v_f - shrink + noise

    # unconditioned predictive variance from the plain GP
    n = x_samples.shape[0]
    sol = linalg.solve_triangular(state.chol_kn,
                                  k_star[..., :n].transpose(-1, -2),
                                  lower=True)
    v_n = noise + sigma * (1 + 1e-10) - torch.sum(sol * sol, dim=-2)
    return 0.5 * torch.log(v_n + noise) - 0.5 * torch.log(v_cond + noise)


def pes_acquisition_multi(x: torch.Tensor, states: PESState,
                          x_samples: torch.Tensor) -> torch.Tensor:
    """Hyperparameter-marginalized acquisition at x (P, d): the NaN-mean
    over the sets (M leading axis), failed sets dropped: (P,)."""
    vals = pes_acquisition(x, states, x_samples)
    return torch.nanmean(torch.where(torch.isfinite(vals), vals,
                                     float("nan")), dim=0)
