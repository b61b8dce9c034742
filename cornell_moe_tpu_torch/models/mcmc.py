"""MCMC hyperparameter inference and the batched GP ensemble.

Counterpart of ``cornell_moe_tpu/models/mcmc.py``.  The
affine-invariant stretch-move ensemble sampler (Goodman & Weare 2010) runs
with the walkers as a batch axis; each half-step evaluates the proposals'
log-posteriors in one call.  ``lax.scan`` becomes a Python loop over steps;
the gated chain reads its convergence condition on the host once per
64-step segment.

Dispatch rule of the log-posterior (:func:`uses_lml_kernel`): CUDA,
float32 and value channels only go through the fused LML kernel
(``ops.kernels.lml_fused``); float64, CPU tensors and derivative channels
take the plain LML (``models.likelihood``), as in the JAX package.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.models import likelihood as lik_mod
from cornell_moe_tpu_torch.models.priors import DefaultPrior
from cornell_moe_tpu_torch.ops import kernels
from cornell_moe_tpu_torch.parallel import sharding

# Hard bounds on log-hyperparameters.
LOG_BOUND = 20.0

# Noise pinned when noisy=False.
NOISELESS_VALUE = 1.0e-8

# Noise of shape-bucket padding points: large enough that they carry no
# information, small enough to keep a float32 Cholesky well-scaled.
PAD_NOISE = 1.0e8

# Stretch-move steps per convergence check of the gated chain.
CHAIN_GATE_SEGMENT = 64


def uses_lml_kernel(device_type: str, dtype: torch.dtype,
                    derivatives: Sequence[int]) -> bool:
    """Kernel B's gate: CUDA, float32 and value channels only."""
    return device_type == "cuda" and dtype == torch.float32 and \
        not cov_mod.channels(derivatives)


def bucket_size(n: int, bucket: int) -> int:
    if bucket <= 1:
        return n
    return ((n + bucket - 1) // bucket) * bucket


def pad_training_data(x, y, target_n: int):
    """Pad (x, y) to target_n rows with huge-noise dummy points.

    Returns (x_pad, y_pad, point_noise (target_n, 1+m), real_mean) as numpy
    arrays.  Dummy points repeat the first row with the value set to the
    real empirical mean; their PAD_NOISE rows make their influence
    ~1/PAD_NOISE.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if y.ndim == 1:
        y = y[:, None]
    n, nch = y.shape
    real_mean = float(y[:, 0].mean())
    n_pad = target_n - n
    if n_pad <= 0:
        return x, y, np.zeros_like(y), real_mean
    x_pad = np.concatenate([x, np.repeat(x[:1], n_pad, axis=0)])
    y_fill = np.zeros((n_pad, nch))
    y_fill[:, 0] = real_mean
    y_pad = np.concatenate([y, y_fill])
    noise = np.zeros((target_n, nch))
    noise[n:, :] = PAD_NOISE
    return x_pad, y_pad, noise, real_mean


def draw_stretch_moves(generator: torch.Generator, num_walkers: int,
                       device=None, dtype=torch.float64):
    """The random numbers of one stretch-move step, per half-ensemble:
    ((u_z, partner_idx, u_accept), (u_z, partner_idx, u_accept))."""
    half = num_walkers // 2
    kw = dict(generator=generator, device=device)
    draws = []
    for _ in range(2):
        u = torch.rand((half,), dtype=dtype, **kw)
        idx = torch.randint(0, half, (half,), **kw)
        acc = torch.rand((half,), dtype=dtype, **kw)
        draws.append((u, idx, acc))
    return tuple(draws)


def stretch_move_step_with_draws(positions: torch.Tensor,
                                 log_probs: torch.Tensor,
                                 log_prob_fn: Callable, draws,
                                 a: float = 2.0):
    """One stretch-move update of both half-ensembles from given draws.

    ``positions`` (W, D), W even; ``log_prob_fn`` maps (W', D) -> (W',).
    """
    w, d = positions.shape
    half = w // 2

    def update_half(draw, movers, movers_lp, others):
        u, idx, u_acc = draw
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        partners = others[idx]
        proposal = partners + z[:, None] * (movers - partners)
        prop_lp = log_prob_fn(proposal)
        log_accept = (d - 1.0) * torch.log(z) + prop_lp - movers_lp
        accept = torch.log(u_acc) < log_accept
        return (torch.where(accept[:, None], proposal, movers),
                torch.where(accept, prop_lp, movers_lp))

    first, second = positions[:half], positions[half:]
    lp1, lp2 = log_probs[:half], log_probs[half:]
    first, lp1 = update_half(draws[0], first, lp1, second)
    second, lp2 = update_half(draws[1], second, lp2, first)
    return torch.cat([first, second]), torch.cat([lp1, lp2])


def stretch_move_step(generator: torch.Generator, positions: torch.Tensor,
                      log_probs: torch.Tensor, log_prob_fn: Callable,
                      a: float = 2.0):
    draws = draw_stretch_moves(generator, positions.shape[0],
                               positions.device, positions.dtype)
    return stretch_move_step_with_draws(positions, log_probs, log_prob_fn,
                                        draws, a)


def run_ensemble_mcmc(generator: torch.Generator, log_prob_fn: Callable,
                      initial_positions: torch.Tensor, num_steps: int,
                      a: float = 2.0):
    """Fixed-length stretch-move chain; returns (positions, log_probs)."""
    pos = initial_positions
    lp = log_prob_fn(pos)
    for _ in range(int(num_steps)):
        pos, lp = stretch_move_step(generator, pos, lp, log_prob_fn, a)
    return pos, lp


def run_ensemble_mcmc_gated(generator: torch.Generator,
                            log_prob_fn: Callable,
                            initial_positions: torch.Tensor, max_steps: int,
                            rel_tol: float = 1.0, a: float = 2.0,
                            segment: int = CHAIN_GATE_SEGMENT):
    """Equilibration-gated stretch-move chain.

    Runs ``segment``-step blocks and stops once the block-averaged
    ensemble-mean log-posterior and every block-averaged ensemble-mean
    coordinate have stopped drifting, at one- and two-block lag:

        |m_i - m_{i-1}|, |m_i - m_{i-2}| / 2  <=  rel_tol * std_walkers / sqrt(W)

    The two-lag drift first exists at the third block, so the chain runs at
    least 3 segments (192 steps), and at most ceil(max_steps / segment)
    segments (the cap rounds up: 1024 steps for 1000).  Non-finite
    statistics never pass.  Returns (positions, log_probs, steps_taken).
    """
    w, d = initial_positions.shape
    max_segments = -(-int(max_steps) // segment)
    inv_sqrt_w = 1.0 / math.sqrt(w)
    pos = initial_positions
    lp = log_prob_fn(pos)
    inf_stat = torch.full((1 + d,), float("inf"), dtype=lp.dtype,
                          device=lp.device)
    prev1, prev2 = inf_stat, inf_stat
    seg = 0
    while seg < max_segments:
        lp_means, pos_means = [], []
        for _ in range(segment):
            pos, lp = stretch_move_step(generator, pos, lp, log_prob_fn, a)
            lp_means.append(torch.mean(lp))
            pos_means.append(torch.mean(pos, dim=0))
        stat = torch.cat([torch.mean(torch.stack(lp_means))[None],
                          torch.mean(torch.stack(pos_means), dim=0)])
        scale = torch.cat([torch.std(lp, correction=0)[None],
                           torch.std(pos, dim=0, correction=0)]) * inv_sqrt_w
        drift1 = torch.abs(stat - prev1)
        drift2 = torch.abs(stat - prev2) * 0.5
        settled = torch.all(
            torch.isfinite(drift1) & (drift1 <= rel_tol * scale) &
            torch.isfinite(drift2) & (drift2 <= rel_tol * scale))
        seg += 1
        prev1, prev2 = stat, prev1
        if settled.item():
            break
    return pos, lp, seg * segment


# ---------------------------------------------------------------------------
# Batched GP ensemble
# ---------------------------------------------------------------------------

def fit_gp_ensemble(kernel_name: str, hypers: torch.Tensor,
                    noises: torch.Tensor, points, values,
                    derivatives: Sequence[int] = (), jitter: float = 0.0,
                    bucket: int = 0) -> gp_mod.GaussianProcessState:
    """One GP per hyperparameter sample, as one ensemble state.

    ``hypers`` (S, 1+dim) linear-space covariance hyperparameters and
    ``noises`` (S, 1+m), one per channel, fix the device and dtype; points
    and values (n, 1+m) are numpy or tensors.  With ``bucket`` > 1 the data
    is padded to a multiple of it with PAD_NOISE rows.  In float32 the
    Cholesky gets a relative jitter of ``config.F32_CHOLESKY_JITTER`` times
    each member's amplitude.
    """
    dev, dt = hypers.device, hypers.dtype
    x = np.asarray(torch.as_tensor(points).cpu())
    y = np.asarray(torch.as_tensor(values).cpu())
    if y.ndim == 1:
        y = y[:, None]
    point_noise = mean = None
    if bucket > 1:
        x, y, point_noise, mean = pad_training_data(
            x, y, bucket_size(x.shape[0], bucket))
        point_noise = torch.as_tensor(point_noise, dtype=dt, device=dev)
    jit = jitter
    if dt == torch.float32:
        jit = jitter + config.F32_CHOLESKY_JITTER * hypers[:, 0]
    cov = cov_mod.COVARIANCE_TYPES[kernel_name](hyperparameters=hypers)
    return gp_mod.fit_gp(
        cov, noises, torch.as_tensor(x, dtype=dt, device=dev),
        torch.as_tensor(y, dtype=dt, device=dev), derivatives, jitter=jit,
        mean=mean, point_noise=point_noise)


def ensemble_size(states: gp_mod.GaussianProcessState) -> int:
    return states.points_sampled.shape[0]


def ensemble_member(states: gp_mod.GaussianProcessState, i: int
                    ) -> gp_mod.GaussianProcessState:
    return states.member(i)


# ---------------------------------------------------------------------------
# The training object
# ---------------------------------------------------------------------------

class GaussianProcessLogLikelihoodMCMC:
    """MCMC treatment of GP hyperparameters.

    theta = log([alpha, l_1..l_d, noise_0..noise_m]) under ``DefaultPrior``
    (one noise per observation channel), sampled by
    the stretch-move ensemble; ``train()`` burns in once, then continues
    the chain (gated when ``chain_gate_tol`` is set, with ``chain_length``
    as the cap) and keeps ``n_hypers`` random walkers as the ensemble.
    With a ``process_group`` the walkers' log-posteriors are computed in
    blocks, one per rank, and gathered (``parallel.sharding``): every rank
    holds every walker's value, so the gate stops every rank's chain at
    the same step.
    ``optimize()`` is the MAP alternative: one member at the best end of a
    multistart damped Newton.
    """

    def __init__(self, historical_data, prior=None, chain_length: int = 1000,
                 burnin_steps: int = 2000, n_hypers: int = 16,
                 noisy: bool = True, kernel_name: str = "matern_2.5",
                 generator: Optional[torch.Generator] = None,
                 bucket: int = 0, standardize: bool = False,
                 chain_gate_tol: Optional[float] = None,
                 device=None, dtype=None, derivatives: Sequence[int] = (),
                 process_group=None):
        self._data = historical_data
        self.process_group = process_group
        self.device = torch.device(device) if device is not None \
            else config.default_device()
        self.dtype = dtype if dtype is not None else \
            config.default_dtype(self.device)
        self.standardize = standardize
        self.value_mean = 0.0
        self.value_scale = 1.0
        self.chain_gate_tol = chain_gate_tol
        self.last_chain_steps: Optional[int] = None
        self.chain_steps: list = []      # steps of every train()'s chain
        self.members_replaced: list = []  # refit members of every fit
        self.bucket = bucket
        self.derivatives = cov_mod.channels(derivatives)
        self.dim = historical_data.dim
        self.num_noise = 1 + len(self.derivatives)
        n_dims = 1 + self.dim + self.num_noise
        self.prior = prior if prior is not None else DefaultPrior(
            n_dims=n_dims, num_noise=self.num_noise)
        self.chain_length = chain_length
        self.burnin_steps = burnin_steps
        # even walker count >= 2 * D, as emcee requires
        self.n_hypers = max(n_hypers, 2 * n_dims)
        if self.n_hypers % 2:
            self.n_hypers += 1
        self.noisy = noisy
        self.kernel_name = kernel_name
        self.burned = False
        self.p0: Optional[torch.Tensor] = None
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                int(np.random.randint(0, 2**31 - 1)))
        self.generator = generator
        self._models: Optional[gp_mod.GaussianProcessState] = None
        self.hypers = None
        self._hypers = None
        self._noises = None
        self._refresh_value_affine()

    # -- data ---------------------------------------------------------------
    def _refresh_value_affine(self) -> None:
        """Re-estimate the standardization map at a fit boundary."""
        if not self.standardize:
            return
        y = np.asarray(self._data.points_sampled_value, dtype=float)
        mu = float(y[:, 0].mean())
        sigma = float(y[:, 0].std())
        if not np.isfinite(sigma) or sigma < 1e-12:
            sigma = 1.0
        self.value_mean, self.value_scale = mu, sigma

    def _scaled_values(self) -> np.ndarray:
        """Training targets: the value channel as (y - mean) / std, the
        derivative channels as y / std (no shift)."""
        y = np.asarray(self._data.points_sampled_value, dtype=float)
        if y.ndim == 1:
            y = y[:, None]
        if not self.standardize:
            return y
        scaled = y / self.value_scale
        scaled[:, 0] = (y[:, 0] - self.value_mean) / self.value_scale
        return scaled

    def _padded_data(self):
        x = self._data.points_sampled
        y = self._scaled_values()
        point_noise = None
        if self.bucket > 1:
            x, y, point_noise, _ = pad_training_data(
                x, y, bucket_size(x.shape[0], self.bucket))
        kw = dict(dtype=self.dtype, device=self.device)
        return (torch.as_tensor(x, **kw), torch.as_tensor(y, **kw),
                None if point_noise is None else
                torch.as_tensor(point_noise, **kw))

    # -- log posterior ------------------------------------------------------
    def log_posterior(self, thetas: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor, point_noise=None,
                      force_plain: bool = False) -> torch.Tensor:
        """Log-posterior of a walker batch (W, D) -> (W,); -inf outside
        the bounds or where the LML is not finite."""
        dim = self.dim
        in_bounds = torch.all(torch.abs(thetas) <= LOG_BOUND, dim=1)
        lp = self.prior.lnprob(thetas)
        hyps = torch.exp(thetas)
        cov_hyps = hyps[:, :dim + 1]
        noise = hyps[:, dim + 1:] if self.noisy else torch.full(
            (hyps.shape[0], self.num_noise), NOISELESS_VALUE,
            dtype=hyps.dtype, device=hyps.device)
        n = x.shape[0]
        if uses_lml_kernel(x.device.type, x.dtype, self.derivatives) and \
                not force_plain:
            nv = noise.expand(-1, n)
            if point_noise is not None:
                nv = nv + point_noise[None, :, 0]
            us = x.T[None] / cov_hyps[:, 1:, None]
            yb = y[None, :, 0].expand(thetas.shape[0], n)
            quad, logdet = kernels.lml_fused(
                us.contiguous(), cov_hyps[:, 0].contiguous(),
                nv.contiguous(), yb.contiguous(), n, self.kernel_name)
            lml = -0.5 * quad - logdet - 0.5 * n * math.log(2.0 * math.pi)
        else:
            cov = cov_mod.COVARIANCE_TYPES[self.kernel_name](
                hyperparameters=cov_hyps)
            lml = lik_mod.log_marginal_likelihood(cov, noise, x, y,
                                                  self.derivatives,
                                                  point_noise=point_noise)
        val = lp + lml
        return torch.where(in_bounds & torch.isfinite(val), val,
                           float("-inf"))

    def compute_log_likelihood(self, theta) -> torch.Tensor:
        """Log posterior at one log-hyperparameter vector (D,)."""
        t = torch.as_tensor(theta, dtype=self.dtype, device=self.device)
        return self.log_posterior(t.reshape(1, -1), *self._padded_data())[0]

    # -- training -----------------------------------------------------------
    def train(self, do_optimize: bool = True) -> None:
        self._refresh_value_affine()
        if do_optimize:
            x, y, point_noise = self._padded_data()

            def log_prob(t):
                return sharding.sharded_point_evaluation(
                    lambda tt: self.log_posterior(tt, x, y, point_noise), t,
                    self.process_group)

            gen = self.generator
            if not self.burned:
                p0 = self.prior.sample_from_prior(
                    gen, self.n_hypers, device=self.device, dtype=self.dtype)
                p0 = torch.clamp(p0, -LOG_BOUND + 1e-3, LOG_BOUND - 1e-3)
                self.p0, _ = run_ensemble_mcmc(gen, log_prob, p0,
                                               self.burnin_steps)
                self.burned = True
            if self.chain_gate_tol is None:
                pos, _ = run_ensemble_mcmc(gen, log_prob, self.p0,
                                           self.chain_length)
                steps = self.chain_length
            else:
                pos, _, steps = run_ensemble_mcmc_gated(
                    gen, log_prob, self.p0, self.chain_length,
                    rel_tol=self.chain_gate_tol)
            self.last_chain_steps = int(steps)
            self.chain_steps.append(self.last_chain_steps)
            self.p0 = pos
            pick = torch.randint(0, self.n_hypers, (self.n_hypers,),
                                 generator=gen, device=self.device)
            self.hypers = pos[pick].cpu().numpy()
        self._finalize_models()

    def optimize(self, num_restarts: int = 1) -> None:
        """MAP fit: a multistart damped Newton over the log posterior
        (``optimizers.newton_optimize``, 40 steps, gamma 1.05, time factor
        1e-2), from starts drawn from the prior and clipped inside the
        bounds.  The best finite end wins; when no end is finite, the best
        start stands (the JAX package keeps start 0 there).  A Newton step
        can leave the Tophat prior's support of the log length scales,
        where the log posterior is -inf and the step stops.  The log
        posterior is the plain one (``force_plain``): kernel B has no
        backward.  ``map_starts`` and ``map_values`` keep the starts and
        the ends' log posteriors."""
        from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
        from cornell_moe_tpu_torch.ops.optimizers import (NewtonParameters,
                                                          newton_optimize)

        self._refresh_value_affine()
        x, y, point_noise = self._padded_data()
        kw = dict(device=self.device, dtype=self.dtype)
        bound = LOG_BOUND - 1e-3
        dom = TensorProductDomain.from_bounds(
            [[-bound, bound]] * self.prior.n_dims, **kw)
        nparams = NewtonParameters(
            num_multistarts=max(num_restarts, 1), max_num_steps=40,
            gamma=1.05, time_factor=1e-2, max_relative_change=1.0)
        starts = torch.clamp(self.prior.sample_from_prior(
            self.generator, max(num_restarts, 1), **kw), -bound, bound)

        def value(t):
            return self.log_posterior(t[None], x, y, point_noise,
                                      force_plain=True)[0]

        finals = torch.stack([newton_optimize(value, dom, t0, nparams)
                              for t0 in starts])
        vals = torch.stack([value(t) for t in finals])
        self.map_starts, self.map_values = starts, vals
        if not bool(torch.isfinite(vals).any()):
            finals = starts
            vals = torch.stack([value(t) for t in starts])
        pick = int(torch.argmax(torch.where(torch.isfinite(vals), vals,
                                            float("-inf"))))
        self.hypers = finals[pick][None].cpu().numpy()
        self._finalize_models()

    def _fit(self, cov_hypers: np.ndarray, noises: np.ndarray):
        kw = dict(dtype=self.dtype, device=self.device)
        return fit_gp_ensemble(
            self.kernel_name, torch.as_tensor(cov_hypers, **kw),
            torch.as_tensor(noises, **kw), self._data.points_sampled,
            self._scaled_values(), self.derivatives, bucket=self.bucket)

    def _finalize_models(self) -> None:
        if self.hypers is None:
            raise RuntimeError(
                "no hyperparameter samples available: call train() first")
        samples = np.asarray(self.hypers)
        keep = ~np.any((samples < -LOG_BOUND) | (samples > LOG_BOUND),
                       axis=1)
        samples = samples[keep] if keep.any() else samples
        lin = np.exp(samples)
        cov_hypers = lin[:, :self.dim + 1]
        noises = lin[:, self.dim + 1:] if self.noisy else \
            np.full((lin.shape[0], self.num_noise), NOISELESS_VALUE)
        models = self._fit(cov_hypers, noises)
        # a member whose factorization went non-finite poisons every
        # ensemble average downstream: refit it with a surviving walker's
        # hyperparameters (round-robin)
        bad = (~torch.isfinite(models.chol_K).flatten(1).all(dim=1)
               ).cpu().numpy()
        self.members_replaced.append(int(bad.sum()))
        if bad.any():
            if bad.all():
                raise FloatingPointError(
                    "every ensemble member's covariance factorization is "
                    "non-finite; pass standardize=True or standardize the "
                    "observed values")
            good = np.where(~bad)[0]
            repl = good[np.arange(int(bad.sum())) % len(good)]
            logging.getLogger("cornell_moe_tpu_torch").warning(
                "replacing %d/%d non-finite ensemble member fits with "
                "surviving walkers", int(bad.sum()), len(bad))
            cov_hypers = np.array(cov_hypers)
            noises = np.array(noises)
            cov_hypers[bad] = cov_hypers[repl]
            noises[bad] = noises[repl]
            models = self._fit(cov_hypers, noises)
        self._hypers, self._noises = cov_hypers, noises
        self._models = models

    @property
    def models(self) -> gp_mod.GaussianProcessState:
        if self._models is None:
            raise RuntimeError("call train() first")
        return self._models

    @property
    def is_trained(self) -> bool:
        return self._models is not None

    @property
    def num_mcmc(self) -> int:
        return 0 if self._models is None else ensemble_size(self._models)

    def add_sampled_points(self, sampled_points) -> None:
        """Append observations; refit the ensemble at the current
        hyperparameters if it exists."""
        self._data.append_sample_points(sampled_points)
        if self._models is not None:
            self._refresh_value_affine()
            self._models = self._fit(self._hypers, self._noises)

