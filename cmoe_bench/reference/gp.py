"""The GP ensemble, its hyperparameter posterior and the recommendation in
plain PyTorch.

What the driver's model is, from its definition (Cornell-MOE's GP with a
hyperparameter ensemble sampled by MCMC, spearmint's priors), not from the
port's code:

- The values are standardized, (y - mean) / std (population std), and the
  data padded to a multiple of the shape bucket with copies of the first
  point that carry the standardized mean and a noise variance of
  ``PAD_NOISE``; the prior mean is the standardized values' mean.
- Member s: Matern 5/2 with amplitude a_s and length scales l_s, K_s =
  k(X, X) + diag(noise_s + pad noise) + j a_s I, j the relative jitter
  that a float32 fit carries (``F32_JITTER``; 0 in float64); alpha_s =
  K_s^-1 (y - m).
- The chain samples theta = log(a, l_1..l_d, noise) under the log
  posterior :func:`log_prior` + :func:`chain_lml`: the LML of the padded,
  standardized values under K = k(X, X) + diag(noise + pad noise), with
  no jitter, over all padded rows.
- The recommendation is the argmin over the domain of the ensemble mean
  of the posterior means; with fidelity dimensions (the last
  coordinates), over the other coordinates with the fidelities at 1.

With observed partials (derivative channels, m of them) each point carries
1 + m channels [value, dv/dx_i, ...], and K has side N (1 + m), point-major
and channel-minor, as upstream's block covariance (Cornell-MOE's
``gpp_covariance.cpp``): between (x, channel a) and (y, channel b) the
entry is k(x, y) for two values, dk/dx_i or dk/dy_j for a value and a
partial, and d2k/dx_i dy_j for two partials.  The value channel is
standardized as above and the partials scaled by 1 / std; each member has
one noise per channel, [log a, log l (d), log noise (1 + m)] the walker's
layout; a padding point has ``PAD_NOISE`` on every channel, the
standardized mean as its value and 0 as its partials; the prior mean is
subtracted from the value channel only.  These functions
(:func:`matern52_blocks`, :func:`prepare_channels`, :func:`fit_channels`,
:func:`log_prior_channels`, :func:`chain_lml_channels`, the channel branch
of :func:`posterior_mean`) leave the value-only functions as they are.

Everything runs in float64 on the device it is given.  Minima over the
domain are taken on a lattice, then refined by rounds of a local lattice
around the best point at half the spacing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

PAD_NOISE = 1.0e8
F32_JITTER = 1.0e-6
# the box |theta| <= LOG_BOUND outside which the posterior is 0
LOG_BOUND = 20.0
# spearmint's priors: Normal(0, 1) on log a, Tophat on log l, Horseshoe
# (scale 0.1) on the log noise value itself
LENGTH_RANGE = (-2.0, 3.0)
HORSESHOE_SCALE = 0.1
SQRT5 = math.sqrt(5.0)
_LOCAL = (-1.0, -0.5, 0.0, 0.5, 1.0)


F64 = torch.float64


def t64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=F64, device=device)


def matern52(a: torch.Tensor, b: torch.Tensor, amp, lengths) -> torch.Tensor:
    """k(a, b) (P, Q) of the Matern 5/2 kernel, distances by differences."""
    diff = (a[:, None, :] - b[None, :, :]) / lengths
    s = torch.sum(diff * diff, dim=-1)
    r = torch.sqrt(s)
    return amp * (1.0 + SQRT5 * r + (5.0 / 3.0) * s) * torch.exp(-SQRT5 * r)


def matern52_blocks(a: torch.Tensor, b: torch.Tensor, amp, lengths,
                    da=(), db=()) -> torch.Tensor:
    """k over channels, (P (1 + len(da)), Q (1 + len(db))), point-major:
    between (a_p, channel u) and (b_q, channel v), channel 0 the value and
    channel 1 + k the partial along coordinate da[k] (db[k]).  With
    delta = (a_p - b_q) / l^2, r the scaled distance, e = exp(-sqrt5 r) and
    g = (5/3) amp (1 + sqrt5 r) e (so dk/dr = -g r):
    dk/da_i = -g delta_i, dk/db_j = g delta_j and d2k/da_i db_j =
    g [i = j] / l_i^2 - (25/3) amp e delta_i delta_j."""
    diff = a[:, None, :] - b[None, :, :]
    delta = diff / lengths ** 2
    s = torch.sum(diff * delta, dim=-1)
    r = torch.sqrt(s)
    e = torch.exp(-SQRT5 * r)
    k = amp * (1.0 + SQRT5 * r + (5.0 / 3.0) * s) * e
    g = (5.0 / 3.0) * amp * (1.0 + SQRT5 * r) * e
    h = (25.0 / 3.0) * amp * e
    rows = [[k] + [g * delta[..., j] for j in db]]
    for i in da:
        rows.append([-g * delta[..., i]] + [
            (g / lengths[i] ** 2 if i == j else 0.0) -
            h * delta[..., i] * delta[..., j] for j in db])
    block = torch.stack([torch.stack(row, -1) for row in rows], -2)
    p, q, cu, cv = block.shape
    return block.permute(0, 2, 1, 3).reshape(p * cu, q * cv)


def cholesky(k: torch.Tensor) -> torch.Tensor:
    """The lower factor of k, NaN where the factorization fails."""
    c, info = torch.linalg.cholesky_ex(k)
    return c if int(info) == 0 else torch.full_like(c, float("nan"))


@dataclass
class Data:
    """Standardized, bucket-padded training data (numpy, float64)."""

    x: np.ndarray          # (N, d)
    y: np.ndarray          # (N,) standardized
    pad_noise: np.ndarray  # (N,)
    prior_mean: float      # mean of the standardized values
    value_std: float


def prepare(points, values, bucket: int) -> Data:
    x = np.asarray(points, dtype=float)
    v = np.asarray(values, dtype=float)
    mu, sd = float(v.mean()), float(v.std())
    if not np.isfinite(sd) or sd < 1e-12:
        sd = 1.0
    ys = (v - mu) / sd
    m = float(ys.mean())
    n = x.shape[0]
    big = n if bucket <= 1 else -(-n // bucket) * bucket
    pad = big - n
    return Data(x=np.concatenate([x, np.repeat(x[:1], pad, axis=0)]),
                y=np.concatenate([ys, np.full(pad, m)]),
                pad_noise=np.concatenate([np.zeros(n), np.full(pad,
                                                               PAD_NOISE)]),
                prior_mean=m, value_std=sd)


@dataclass
class ChannelData(Data):
    """:class:`Data` with derivative channels: y (N, 1 + m) and pad_noise
    (N, 1 + m); ``derivatives`` the observed partials."""

    derivatives: tuple


def prepare_channels(points, values, bucket: int, derivatives) -> ChannelData:
    """:func:`prepare` of values (n, 1 + m): the value channel centred and
    scaled, the partials scaled by 1 / std; a padding point's partials 0
    and every channel's noise ``PAD_NOISE``."""
    x = np.asarray(points, dtype=float)
    v = np.asarray(values, dtype=float)
    mu, sd = float(v[:, 0].mean()), float(v[:, 0].std())
    if not np.isfinite(sd) or sd < 1e-12:
        sd = 1.0
    ys = v / sd
    ys[:, 0] = (v[:, 0] - mu) / sd
    m = float(ys[:, 0].mean())
    n, c = ys.shape
    big = n if bucket <= 1 else -(-n // bucket) * bucket
    pad = big - n
    fill = np.zeros((pad, c))
    fill[:, 0] = m
    return ChannelData(
        x=np.concatenate([x, np.repeat(x[:1], pad, axis=0)]),
        y=np.concatenate([ys, fill]),
        pad_noise=np.concatenate([np.zeros((n, c)),
                                  np.full((pad, c), PAD_NOISE)]),
        prior_mean=m, value_std=sd, derivatives=tuple(derivatives))


@dataclass
class Ensemble:
    """Each member's alpha (S, N) at its hyperparameters."""

    x: torch.Tensor
    prior_mean: float
    amps: torch.Tensor     # (S,)
    lengths: torch.Tensor  # (S, d)
    alpha: torch.Tensor

    @property
    def size(self) -> int:
        return self.amps.shape[0]


@dataclass
class ChannelEnsemble(Ensemble):
    """:class:`Ensemble` over derivative channels: alpha (S, N (1 + m))."""

    derivatives: tuple


def _member_k(x, amp, lengths, diag) -> torch.Tensor:
    return matern52(x, x, amp, lengths) + torch.diag(diag)


def fit(data: Data, hypers, noises, jitter: float, device) -> Ensemble:
    """The ensemble at linear hyperparameters (S, 1 + d) [amplitude,
    lengths] and noise variances (S, 1), with a relative diagonal
    ``jitter`` (``F32_JITTER`` for a float32 configuration, else 0)."""
    h, nz = t64(hypers, device), t64(noises, device)[:, 0]
    x, y = t64(data.x, device), t64(data.y, device)
    pad = t64(data.pad_noise, device)
    alphas = []
    for s in range(h.shape[0]):
        k = _member_k(x, h[s, 0], h[s, 1:], nz[s] + pad + jitter * h[s, 0])
        alphas.append(torch.cholesky_solve(
            (y - data.prior_mean)[:, None], cholesky(k))[:, 0])
    return Ensemble(x=x, prior_mean=data.prior_mean, amps=h[:, 0],
                    lengths=h[:, 1:], alpha=torch.stack(alphas))


def _channel_k(x, ds, amp, lengths, noise, pad) -> torch.Tensor:
    """K over channels plus diag(per-channel noise (1 + m,) tiled over the
    points + pad (N, 1 + m))."""
    return matern52_blocks(x, x, amp, lengths, ds, ds) + torch.diag(
        (noise[None, :] + pad).reshape(-1))


def fit_channels(data: ChannelData, hypers, noises, jitter: float, device
                 ) -> ChannelEnsemble:
    """:func:`fit` over derivative channels: noise variances (S, 1 + m),
    one per channel; the prior mean subtracted from the value channel."""
    h, nz = t64(hypers, device), t64(noises, device)
    x, y = t64(data.x, device), t64(data.y, device)
    pad = t64(data.pad_noise, device)
    ds = data.derivatives
    rhs = torch.cat([y[:, :1] - data.prior_mean, y[:, 1:]], 1).reshape(-1)
    alphas = []
    for s in range(h.shape[0]):
        k = _channel_k(x, ds, h[s, 0], h[s, 1:], nz[s] + jitter * h[s, 0],
                       pad)
        alphas.append(torch.cholesky_solve(rhs[:, None], cholesky(k))[:, 0])
    return ChannelEnsemble(x=x, prior_mean=data.prior_mean, amps=h[:, 0],
                           lengths=h[:, 1:], alpha=torch.stack(alphas),
                           derivatives=ds)


def log_prior_channels(thetas: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`log_prior` of walkers (W, 1 + dim + 1 + m) [log a, log l
    (dim), log noise (1 + m)]: the horseshoe on each channel's noise."""
    lo, hi = LENGTH_RANGE
    lengths = thetas[:, 1:1 + dim]
    inside = torch.all(torch.abs(thetas) <= LOG_BOUND, dim=1) & \
        torch.all((lengths >= lo) & (lengths <= hi), dim=1)
    amp = -0.5 * thetas[:, 0] ** 2 - 0.5 * math.log(2.0 * math.pi)
    t = thetas[:, 1 + dim:]
    noise = torch.sum(torch.log(torch.log1p(3.0 * (HORSESHOE_SCALE / t) ** 2)),
                      dim=1)
    return torch.where(inside, amp + noise, float("-inf"))


def chain_lml_channels(data: ChannelData, thetas: torch.Tensor
                       ) -> torch.Tensor:
    """:func:`chain_lml` over derivative channels: the zero-mean LML of the
    padded, standardized channels (N (1 + m),) under K over channels plus
    each walker's per-channel noise and the padding's."""
    device = thetas.device
    x, y = t64(data.x, device), t64(data.y, device).reshape(-1)
    pad = t64(data.pad_noise, device)
    d, size = x.shape[1], y.shape[0]
    out = []
    for t in thetas.to(F64):
        h = torch.exp(t)
        c = cholesky(_channel_k(x, data.derivatives, h[0], h[1:1 + d],
                                h[1 + d:], pad))
        z = torch.linalg.solve_triangular(c, y[:, None], upper=False)[:, 0]
        out.append(-0.5 * torch.sum(z * z) -
                   torch.sum(torch.log(torch.diagonal(c))) -
                   0.5 * size * math.log(2.0 * math.pi))
    return torch.stack(out)


def log_prior(thetas: torch.Tensor) -> torch.Tensor:
    """The log prior of log-hyperparameters (W, 1 + d + 1) [log a, log l,
    log noise]: -inf outside |theta| <= LOG_BOUND or the length range."""
    lo, hi = LENGTH_RANGE
    lengths = thetas[:, 1:-1]
    inside = torch.all(torch.abs(thetas) <= LOG_BOUND, dim=1) & \
        torch.all((lengths >= lo) & (lengths <= hi), dim=1)
    amp = -0.5 * thetas[:, 0] ** 2 - 0.5 * math.log(2.0 * math.pi)
    t = thetas[:, -1]
    noise = torch.log(torch.log1p(3.0 * (HORSESHOE_SCALE / t) ** 2))
    return torch.where(inside, amp + noise, float("-inf"))


def chain_lml(data: Data, thetas: torch.Tensor) -> torch.Tensor:
    """The LML the chain samples under (see the module's docstring) at
    each log-hyperparameter row (W,); NaN where the factor fails."""
    device = thetas.device
    x, y = t64(data.x, device), t64(data.y, device)
    pad = t64(data.pad_noise, device)
    n = x.shape[0]
    out = []
    for t in thetas.to(F64):
        h = torch.exp(t)
        c = cholesky(_member_k(x, h[0], h[1:-1], h[-1] + pad))
        z = torch.linalg.solve_triangular(c, y[:, None], upper=False)[:, 0]
        out.append(-0.5 * torch.sum(z * z) -
                   torch.sum(torch.log(torch.diagonal(c))) -
                   0.5 * n * math.log(2.0 * math.pi))
    return torch.stack(out)


def posterior_mean(ens: Ensemble, x: torch.Tensor, alpha=None
                   ) -> torch.Tensor:
    """Each member's posterior mean (S, P) at x (P, d); ``alpha`` (S, N)
    in place of the ensemble's own."""
    if isinstance(ens, ChannelEnsemble):
        return _channel_posterior_mean(ens, x, alpha)
    alpha = ens.alpha if alpha is None else alpha
    out = [ens.prior_mean + matern52(x, ens.x, ens.amps[s],
                                     ens.lengths[s]) @ alpha[s]
           for s in range(ens.size)]
    return torch.stack(out)


def _channel_posterior_mean(ens: ChannelEnsemble, x: torch.Tensor,
                            alpha=None) -> torch.Tensor:
    """The value channel's posterior mean (S, P) given every channel."""
    alpha = ens.alpha if alpha is None else alpha
    out = [ens.prior_mean + matern52_blocks(
        x, ens.x, ens.amps[s], ens.lengths[s], (), ens.derivatives) @
        alpha[s] for s in range(ens.size)]
    return torch.stack(out)


def lattice(bounds, points: int, device) -> torch.Tensor:
    """A lattice of about ``points`` points over the box ``bounds`` (d, 2);
    returns (P, d) and the spacing (d,)."""
    b = np.asarray(bounds, dtype=float)
    d = b.shape[0]
    per = max(2, int(round(points ** (1.0 / d))))
    axes = [np.linspace(lo, hi, per) for lo, hi in b]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, d)
    return t64(grid, device), t64((b[:, 1] - b[:, 0]) / (per - 1), device)


def _local_offsets(d: int, device) -> torch.Tensor:
    return t64(np.stack(np.meshgrid(*([_LOCAL] * d), indexing="ij"),
                         -1).reshape(-1, d), device)


def refine_min(fn, x0: torch.Tensor, v0: torch.Tensor, spacing, bounds,
               rounds: int):
    """Rounds of a local lattice around each best point (B, d), at half
    the spacing each round; ``fn`` maps candidates (B, C, d) to values
    (B, C).  Returns (points (B, d), values (B,))."""
    dev = x0.device
    lo = t64(np.asarray(bounds)[:, 0], dev)
    hi = t64(np.asarray(bounds)[:, 1], dev)
    off = _local_offsets(x0.shape[-1], dev)
    h = spacing.clone()
    x, v = x0, v0
    for _ in range(rounds):
        cand = torch.minimum(torch.maximum(
            x[:, None, :] + off[None] * h, lo), hi)
        vals = fn(cand)
        j = torch.argmin(vals, dim=1)
        best = torch.gather(vals, 1, j[:, None])[:, 0]
        better = best < v
        x = torch.where(better[:, None],
                        cand[torch.arange(cand.shape[0]), j], x)
        v = torch.where(better, best, v)
        h = h * 0.5
    return x, v


def recommend(ens: Ensemble, bounds, grid_points: int, rounds: int,
              num_fidelity: int = 0):
    """The argmin (d,) over the domain of the ensemble mean of the
    posterior means, and that mean there; with ``num_fidelity`` > 0 see
    :func:`recommend_at_full_fidelity`."""
    if num_fidelity:
        return recommend_at_full_fidelity(ens, bounds, grid_points, rounds,
                                          num_fidelity)
    grid, spacing = lattice(bounds, grid_points, ens.x.device)
    d = grid.shape[1]
    guesses = torch.cat([grid, ens.x])

    def mean_of(x):
        return torch.mean(posterior_mean(ens, x), 0)

    vals = mean_of(guesses)
    j = torch.argmin(vals)

    def fn(cand):
        return mean_of(cand.reshape(-1, d)).reshape(cand.shape[:2])

    x, v = refine_min(fn, guesses[j][None], vals[j][None], spacing, bounds,
                      rounds)
    return x[0], v[0]


def pin_fidelity(x: torch.Tensor, num_fidelity: int) -> torch.Tensor:
    """Points (..., d - num_fidelity) with the fidelities appended at 1."""
    return torch.cat([x, torch.ones(x.shape[:-1] + (num_fidelity,),
                                    dtype=x.dtype, device=x.device)], -1)


def recommend_at_full_fidelity(ens: Ensemble, bounds, grid_points: int,
                               rounds: int, num_fidelity: int):
    """:func:`recommend` over the coordinates before the last
    ``num_fidelity``, those pinned at 1: the argmin (d,), fidelities
    included, and the ensemble mean there."""
    inner = np.asarray(bounds, dtype=float)[:-num_fidelity]
    grid, spacing = lattice(inner, grid_points, ens.x.device)
    d = grid.shape[1]
    guesses = torch.cat([grid, ens.x[:, :d]])

    def mean_of(x):
        return torch.mean(posterior_mean(ens, pin_fidelity(x, num_fidelity)),
                          0)

    vals = mean_of(guesses)
    j = torch.argmin(vals)

    def fn(cand):
        return mean_of(cand.reshape(-1, d)).reshape(cand.shape[:2])

    x, v = refine_min(fn, guesses[j][None], vals[j][None], spacing, inner,
                      rounds)
    return pin_fidelity(x, num_fidelity)[0], v[0]
