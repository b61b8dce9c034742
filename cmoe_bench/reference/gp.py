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
  of the posterior means.

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
    alpha = ens.alpha if alpha is None else alpha
    out = [ens.prior_mean + matern52(x, ens.x, ens.amps[s],
                                     ens.lengths[s]) @ alpha[s]
           for s in range(ens.size)]
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


def recommend(ens: Ensemble, bounds, grid_points: int, rounds: int):
    """The argmin (d,) over the domain of the ensemble mean of the
    posterior means, and that mean there."""
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
