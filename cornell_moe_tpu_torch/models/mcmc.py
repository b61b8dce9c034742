"""MCMC hyperparameter inference and the batched GP ensemble.

Counterpart of ``cornell_moe_tpu/models/mcmc.py``.  The
affine-invariant stretch-move ensemble sampler (Goodman & Weare 2010) runs
with the walkers as a batch axis; each half-step evaluates the proposals'
log-posteriors in one call.  The chain runs in segments of
``CHAIN_GATE_SEGMENT`` steps, the counterpart of the JAX package's
``lax.scan`` under ``lax.while_loop``: each segment is one program
(``ops.programs``, a CUDA graph on the card) whose stretch moves are drawn
eagerly from the model's generator, step by step in the order the
step-by-step chain draws them, so both chains take the same steps bit for
bit.  The gated chain reads its convergence condition on the host once per
segment.  Under a ``process_group`` each half-step's log-posteriors are
computed in walker blocks, one per rank, and gathered inside the segment's
program (an NCCL group's ``all_gather`` is captured with it); a gloo group
on a card runs the chain eagerly, step by step (:func:`chain_runs_programs`).
The ensemble fit is one program per (S, Np, d, kernel), the counterpart of
``_ensemble_fit_program``, and the MAP fit's Newton run one per start
shape.  Spans (``utils.logging_utils.span``): ``model.train`` around a
training, inside it ``model.burn_in`` and ``model.chain`` around its two
chains, ``model.fit`` around every ensemble fit and ``model.map`` around
the MAP fit.

Dispatch rule of the log-posterior (:func:`lml_route`): CUDA, float32 or
float64, value channels only and at most :data:`LML_MAX_OBS` (padded)
observations go through the fused LML kernel (``ops.kernels.lml_fused``)
in the model's own dtype (:func:`uses_lml_kernel`); the rest of the CUDA
float64 walkers (derivative channels, more observations) through the
tiled float64 Cholesky (``ops.kernels.lml_chol_f64``, via
``likelihood.log_marginal_likelihood_tiled``) on the plain LML's K, with
no transposed solve (:func:`uses_chol_kernel`); CPU tensors, float32
beyond B's gate and ``force_plain`` (the MAP fit, which autograd
differentiates) take the plain LML (``models.likelihood``), as in the
JAX package.  A float32 model keeps
float32 B (a walker its float32 factorization cannot factor gets -inf, so
the chain stays where the float32 fit works); a float64 model gets
float64 B, where that concern does not arise since its fit is float64
too.  The JAX package's TPU kernel has no float64 counterpart: its float64
chain takes the plain LML.  ``LML_PALLAS`` "never" sends every walker to
the plain LML.
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
from cornell_moe_tpu_torch.ops import kernels, programs
from cornell_moe_tpu_torch.parallel import sharding
from cornell_moe_tpu_torch.utils.logging_utils import span

# Hard bounds on log-hyperparameters.
LOG_BOUND = 20.0

# Noise pinned when noisy=False.
NOISELESS_VALUE = 1.0e-8

# Noise of shape-bucket padding points: large enough that they carry no
# information, small enough to keep a float32 Cholesky well-scaled.
PAD_NOISE = 1.0e8

# Kernel B's switch, as the JAX package's: "auto" takes the fused LML
# kernel where :func:`uses_lml_kernel` allows it, "never" the plain LML.
# The chain's programs read it when they are captured, so its value is part
# of every program's key (``programs.keyed_switch``).
LML_PALLAS = "auto"
programs.keyed_switch("mcmc.LML_PALLAS", lambda: LML_PALLAS)

# Kernel B's upper end: the most (bucket-padded) observations the chain's
# log posterior sends to it, the JAX package's cutoff (its models/mcmc.py
# takes the plain LML for n_obs > 896).  The kernel itself takes any Np.
LML_MAX_OBS = 896

# Stretch-move steps per convergence check of the gated chain, and the
# segments before the gate may stop it (as the JAX package's; the two-lag
# drift first exists at the third segment, so the chain runs at least 3)
CHAIN_GATE_SEGMENT = 64
CHAIN_GATE_MIN_SEGMENTS = 2


def uses_lml_kernel(device_type: str, dtype: torch.dtype,
                    derivatives: Sequence[int], n_obs: int) -> bool:
    """Kernel B's gate: CUDA, float32 or float64 (B's instance in the
    model's dtype: float32 models keep float32 B, float64 models get
    float64 B), value channels only and ``n_obs`` (the padded
    observations) at most :data:`LML_MAX_OBS`, while ``LML_PALLAS`` is
    "auto"."""
    return config.switch_on("mcmc.LML_PALLAS", LML_PALLAS) and \
        device_type == "cuda" and \
        dtype in (torch.float32, torch.float64) and \
        not cov_mod.channels(derivatives) and n_obs <= LML_MAX_OBS


def uses_chol_kernel(device_type: str, dtype: torch.dtype) -> bool:
    """The tiled float64 Cholesky's gate: CUDA, float64, while
    ``LML_PALLAS`` is "auto"; any channels and any N."""
    return config.switch_on("mcmc.LML_PALLAS", LML_PALLAS) and \
        device_type == "cuda" and dtype == torch.float64


def lml_route(device_type: str, dtype: torch.dtype,
              derivatives: Sequence[int], n_obs: int,
              force_plain: bool = False) -> str:
    """Where the log posterior sends its walkers' LML: ``"fused"`` (kernel
    B, :func:`uses_lml_kernel`), else ``"chol"`` (the tiled float64
    Cholesky, :func:`uses_chol_kernel`), else ``"plain"``; always
    ``"plain"`` under ``force_plain``."""
    if force_plain:
        return "plain"
    if uses_lml_kernel(device_type, dtype, derivatives, n_obs):
        return "fused"
    if uses_chol_kernel(device_type, dtype):
        return "chol"
    return "plain"


def chain_runs_programs(process_group, device) -> bool:
    """Whether the chain runs as segment programs: while
    ``programs.CAPTURE`` is "auto" and the group's gather of every
    half-step's log-posteriors can be captured with it
    (``sharding.group_captures``: no group, the CPU or NCCL); under a gloo
    group on a card the chain runs eagerly, step by step."""
    return programs.enabled() and \
        sharding.group_captures(process_group, device)


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


def draw_segment(generator: torch.Generator, steps: int, num_walkers: int,
                 device=None, dtype=torch.float64):
    """The draws of ``steps`` stretch-move steps, one
    :func:`draw_stretch_moves` per step in the step-by-step chain's order:
    (u_z, partner_idx, u_accept), each (steps, 2, num_walkers / 2), axis 1
    the half-ensemble."""
    draws = [draw_stretch_moves(generator, num_walkers, device, dtype)
             for _ in range(int(steps))]
    return tuple(torch.stack([torch.stack([half[j] for half in step])
                              for step in draws]) for j in range(3))


def _segment_draws(u, idx, acc):
    """Per step, the draws of :func:`draw_segment`'s tensors."""
    for k in range(u.shape[0]):
        yield ((u[k, 0], idx[k, 0], acc[k, 0]),
               (u[k, 1], idx[k, 1], acc[k, 1]))


def _chain_steps(pos, lp, log_prob_fn, step_draws, a: float,
                 statistic: bool = True):
    """Stretch-move steps, one per entry of ``step_draws``; returns
    (positions, log_probs, stat), stat the segment's block-averaged
    ensemble-mean log-posterior and coordinates (1 + D,) (None without
    ``statistic``)."""
    lp_means, pos_means = [], []
    for draws in step_draws:
        pos, lp = stretch_move_step_with_draws(pos, lp, log_prob_fn, draws,
                                               a)
        if statistic:
            lp_means.append(torch.mean(lp))
            pos_means.append(torch.mean(pos, dim=0))
    if not statistic:
        return pos, lp, None
    stat = torch.cat([torch.mean(torch.stack(lp_means))[None],
                      torch.mean(torch.stack(pos_means), dim=0)])
    return pos, lp, stat


def chain_segment(log_prob_fn: Callable, pos: torch.Tensor,
                  lp: torch.Tensor, u: torch.Tensor, idx: torch.Tensor,
                  acc: torch.Tensor, a: float = 2.0):
    """``u.shape[0]`` stretch-move steps from :func:`draw_segment`'s
    draws; returns (positions, log_probs, stat) as the gated chain's
    segment computes them.  This is what a chain segment's program
    captures."""
    return _chain_steps(pos, lp, log_prob_fn, _segment_draws(u, idx, acc),
                        a)


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
                      a: float = 2.0, segment_fn: Optional[Callable] = None,
                      segment: int = CHAIN_GATE_SEGMENT,
                      keep_chain: bool = False):
    """Fixed-length stretch-move chain; returns (positions, log_probs), and
    with ``keep_chain`` (positions, log_probs, chain), the chain
    (num_steps, W, D) holding the positions after each step.

    With ``segment_fn`` ((positions, log_probs, u, idx, acc) ->
    (positions, log_probs, stat), :func:`chain_segment` of ``log_prob_fn``
    or its program) the steps run in ``segment``-step blocks and a
    remainder block, each from :func:`draw_segment`'s draws; without it
    step by step.  Both take the same steps bit for bit.  A segment hands
    back its last positions only, so ``keep_chain`` runs step by step
    whether or not ``segment_fn`` is given: the same steps."""
    pos = initial_positions
    lp = log_prob_fn(pos)
    if keep_chain:
        chain = []
        for _ in range(int(num_steps)):
            pos, lp = stretch_move_step(generator, pos, lp, log_prob_fn, a)
            chain.append(pos)
        return pos, lp, (torch.stack(chain) if chain else
                         pos.new_empty((0,) + tuple(pos.shape)))
    w = pos.shape[0]
    done = 0
    while done < int(num_steps):
        steps = int(num_steps) - done
        if segment_fn is None:
            pos, lp, _ = _chain_steps(
                pos, lp, log_prob_fn,
                (draw_stretch_moves(generator, w, pos.device, pos.dtype)
                 for _ in range(steps)), a, statistic=False)
        else:
            steps = min(steps, segment)
            pos, lp, _ = segment_fn(pos, lp, *draw_segment(
                generator, steps, w, pos.device, pos.dtype))
        done += steps
    return pos, lp


def run_ensemble_mcmc_gated(generator: torch.Generator,
                            log_prob_fn: Callable,
                            initial_positions: torch.Tensor, max_steps: int,
                            rel_tol: float = 1.0, a: float = 2.0,
                            segment: int = CHAIN_GATE_SEGMENT,
                            min_segments: int = CHAIN_GATE_MIN_SEGMENTS,
                            segment_fn: Optional[Callable] = None):
    """Equilibration-gated stretch-move chain.

    Runs ``segment``-step blocks and stops once the block-averaged
    ensemble-mean log-posterior and every block-averaged ensemble-mean
    coordinate have stopped drifting, at one- and two-block lag:

        |m_i - m_{i-1}|, |m_i - m_{i-2}| / 2  <=  rel_tol * std_walkers / sqrt(W)

    and at least ``min_segments`` blocks have run.  The two-lag drift first
    exists at the third block, so the chain runs at least
    max(3, ``min_segments``) segments (192 steps by default), and at most
    ceil(max_steps / segment) segments (the cap rounds up: 1024 steps for
    1000).  Non-finite statistics never pass.  ``segment_fn`` as in
    :func:`run_ensemble_mcmc`: each block one call of it, else step by
    step.  Returns (positions, log_probs, steps_taken).
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
        if segment_fn is None:
            pos, lp, stat = _chain_steps(
                pos, lp, log_prob_fn,
                (draw_stretch_moves(generator, w, pos.device, pos.dtype)
                 for _ in range(segment)), a)
        else:
            pos, lp, stat = segment_fn(pos, lp, *draw_segment(
                generator, segment, w, pos.device, pos.dtype))
        scale = torch.cat([torch.std(lp, correction=0)[None],
                           torch.std(pos, dim=0, correction=0)]) * inv_sqrt_w
        drift1 = torch.abs(stat - prev1)
        drift2 = torch.abs(stat - prev2) * 0.5
        settled = torch.all(
            torch.isfinite(drift1) & (drift1 <= rel_tol * scale) &
            torch.isfinite(drift2) & (drift2 <= rel_tol * scale))
        seg += 1
        prev1, prev2 = stat, prev1
        if settled.item() and seg >= min_segments:
            break
    return pos, lp, seg * segment


# ---------------------------------------------------------------------------
# Batched GP ensemble
# ---------------------------------------------------------------------------

def fit_gp_ensemble(kernel_name: str, hypers: torch.Tensor,
                    noises: torch.Tensor, points, values,
                    derivatives: Sequence[int] = (), jitter: float = 0.0,
                    bucket: int = 0,
                    program_cache: Optional[programs.ProgramCache] = None
                    ) -> gp_mod.GaussianProcessState:
    """One GP per hyperparameter sample, as one ensemble state.

    ``hypers`` (S, 1+dim) linear-space covariance hyperparameters and
    ``noises`` (S, 1+m), one per channel, fix the device and dtype; points
    and values (n, 1+m) are numpy or tensors.  With ``bucket`` > 1 the data
    is padded to a multiple of it with PAD_NOISE rows.  In float32 the
    Cholesky gets a relative jitter of ``config.F32_CHOLESKY_JITTER`` times
    each member's amplitude.  With a ``program_cache`` (and
    ``programs.CAPTURE`` "auto") the fit's device part
    (``gp.fit_factors``, kernel C among it) is one program per (S, Np, d,
    kernel), the counterpart of the JAX package's
    ``_ensemble_fit_program``; the padding and the copy to the device stay
    outside it.
    """
    with span("model.fit"):
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
        cov = cov_mod.COVARIANCE_TYPES[kernel_name](hyperparameters=hypers)
        fit = gp_mod.fit_inputs(
            cov, noises, torch.as_tensor(x, dtype=dt, device=dev),
            torch.as_tensor(y, dtype=dt, device=dev), derivatives,
            point_noise=point_noise)
        noise, xt, yt, pn, ds = fit
        inputs = [hypers.contiguous(), noise.contiguous(), xt, yt] + [
            t for t in (pn, None if mean is None else
                        torch.as_tensor(mean, dtype=dt, device=dev))
            if t is not None]

        def factors_of(h, nv, xx, yy, *rest):
            rest = list(rest)
            p = rest.pop(0) if pn is not None else None
            m = rest.pop(0) if mean is not None else None
            jit = jitter
            if dt == torch.float32:
                jit = jitter + config.F32_CHOLESKY_JITTER * h[:, 0]
            return gp_mod.fit_factors(
                cov_mod.COVARIANCE_TYPES[kernel_name](hyperparameters=h), nv,
                xx, yy, p, ds, jitter=jit, mean=m)

        if program_cache is None or not programs.enabled():
            factors = factors_of(*inputs)
        else:
            key = ("fit", kernel_name, tuple(hypers.shape), tuple(xt.shape),
                   tuple(yt.shape), dt, str(dev), ds, float(jitter),
                   pn is not None, mean is not None)
            factors = program_cache.get(key, factors_of)(*inputs)
        return gp_mod.assemble_state(cov, *fit, *factors)


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
    the same step.  The chain's segments and the ensemble fit run as
    programs of ``program_cache`` (its own when None; ``ops.programs``),
    one per shape bucket, while ``programs.CAPTURE`` is "auto" (the chain
    under a process group only where its gather can be captured,
    :func:`chain_runs_programs`).
    ``optimize()`` is the MAP alternative: one member at the best end of a
    multistart damped Newton, each start's run one program.
    """

    def __init__(self, historical_data, prior=None, chain_length: int = 1000,
                 burnin_steps: int = 2000, n_hypers: int = 16,
                 noisy: bool = True, kernel_name: str = "matern_2.5",
                 generator: Optional[torch.Generator] = None,
                 bucket: int = 0, standardize: bool = False,
                 chain_gate_tol: Optional[float] = None,
                 device=None, dtype=None, derivatives: Sequence[int] = (),
                 process_group=None,
                 program_cache: Optional[programs.ProgramCache] = None):
        self._data = historical_data
        self.process_group = process_group
        self.program_cache = program_cache if program_cache is not None \
            else programs.ProgramCache()
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
        self._derivatives = cov_mod.channels(derivatives)
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
        route = lml_route(x.device.type, x.dtype, self.derivatives, n,
                          force_plain)
        if route == "fused":
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
            lml = (lik_mod.log_marginal_likelihood_tiled if route == "chol"
                   else lik_mod.log_marginal_likelihood)(
                       cov, noise, x, y, self.derivatives,
                       point_noise=point_noise)
        val = lp + lml
        return torch.where(in_bounds & torch.isfinite(val), val,
                           float("-inf"))

    def _segment_program(self, x: torch.Tensor, y: torch.Tensor,
                         point_noise: Optional[torch.Tensor]) -> Callable:
        """The chain's ``segment_fn`` on this data: one program of
        :func:`chain_segment` per (Np, W, D, steps), the model's settings
        and its process group (each rank evaluates its block of walkers and
        gathers the log-posteriors inside the program); the data are the
        program's inputs, so a retrain inside the bucket replays it."""
        extra = () if point_noise is None else (point_noise,)
        group = self.process_group

        def segment(pos, lp, u, idx, acc, xx, yy, *pn):
            return chain_segment(
                lambda t: sharding.sharded_point_evaluation(
                    lambda tt: self.log_posterior(tt, xx, yy, *pn), t, group),
                pos, lp, u, idx, acc)

        def run(pos, lp, u, idx, acc):
            key = ("chain", tuple(x.shape), tuple(y.shape), tuple(pos.shape),
                   int(u.shape[0]), self.dtype, str(self.device),
                   self.kernel_name, self.noisy, self.derivatives,
                   point_noise is not None, sharding.group_key(group))
            return self.program_cache.get(key, segment)(
                pos, lp, u, idx, acc, x, y, *extra)

        return run

    def compute_log_likelihood(self, theta) -> torch.Tensor:
        """Log posterior at one log-hyperparameter vector (D,)."""
        t = torch.as_tensor(theta, dtype=self.dtype, device=self.device)
        return self.log_posterior(t.reshape(1, -1), *self._padded_data())[0]

    # -- training -----------------------------------------------------------
    def train(self, do_optimize: bool = True) -> None:
        with span("model.train"):
            self._refresh_value_affine()
            if do_optimize:
                x, y, point_noise = self._padded_data()

                def log_prob(t):
                    return sharding.sharded_point_evaluation(
                        lambda tt: self.log_posterior(tt, x, y, point_noise),
                        t, self.process_group)

                segment_fn = self._segment_program(x, y, point_noise) \
                    if chain_runs_programs(self.process_group, self.device) \
                    else None
                gen = self.generator
                if not self.burned:
                    p0 = self.prior.sample_from_prior(
                        gen, self.n_hypers, device=self.device,
                        dtype=self.dtype)
                    p0 = torch.clamp(p0, -LOG_BOUND + 1e-3, LOG_BOUND - 1e-3)
                    with span("model.burn_in"):
                        self.p0, _ = run_ensemble_mcmc(
                            gen, log_prob, p0, self.burnin_steps,
                            segment_fn=segment_fn)
                    self.burned = True
                with span("model.chain"):
                    if self.chain_gate_tol is None:
                        pos, _ = run_ensemble_mcmc(gen, log_prob, self.p0,
                                                   self.chain_length,
                                                   segment_fn=segment_fn)
                        steps = self.chain_length
                    else:
                        pos, _, steps = run_ensemble_mcmc_gated(
                            gen, log_prob, self.p0, self.chain_length,
                            rel_tol=self.chain_gate_tol,
                            segment_fn=segment_fn)
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
        bounds.  The best finite end wins; when no end is finite, start 0
        stands as drawn, as in the JAX package.  A Newton step
        can leave the Tophat prior's support of the log length scales,
        where the log posterior is -inf and the step stops.  The log
        posterior is the plain one (``force_plain``): kernel B has no
        backward.  ``map_starts`` and ``map_values`` keep the starts and
        the ends' log posteriors.  While ``programs.CAPTURE`` is "auto"
        the 40 steps from a start are one program of the model's cache
        over (start, data), replayed for every start; the pick of the best
        end reads the host outside it, as in the JAX package."""
        from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
        from cornell_moe_tpu_torch.ops.optimizers import (NewtonParameters,
                                                          newton_optimize,
                                                          value_and_grad)

        with span("model.map"):
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

            def value_on(t, xx, yy, *pn):
                return self.log_posterior(t[None], xx, yy, *pn,
                                          force_plain=True)[0]

            def value(t):
                return value_on(t, x, y, point_noise)

            def newton(t0, *data):
                def f(t):
                    return value_on(t, *data)
                return newton_optimize(value_and_grad(f), dom, t0, nparams,
                                       hessian_fn=torch.func.hessian(f))

            data = (x, y) + (() if point_noise is None else (point_noise,))
            key = ("map_newton", self.kernel_name, self.noisy,
                   self.derivatives, nparams)
            finals = torch.stack([programs.run(self.program_cache, key, newton,
                                               t0, *data) for t0 in starts])
            vals = torch.stack([value(t) for t in finals])
            self.map_starts, self.map_values = starts, vals
            pick = int(torch.argmax(torch.where(torch.isfinite(vals), vals,
                                                float("-inf"))))
            if not bool(torch.isfinite(vals[pick])):
                finals, pick = starts, 0
            self.hypers = finals[pick][None].cpu().numpy()
            self._finalize_models()

    def _fit(self, cov_hypers: np.ndarray, noises: np.ndarray):
        kw = dict(dtype=self.dtype, device=self.device)
        return fit_gp_ensemble(
            self.kernel_name, torch.as_tensor(cov_hypers, **kw),
            torch.as_tensor(noises, **kw), self._data.points_sampled,
            self._scaled_values(), self.derivatives, bucket=self.bucket,
            program_cache=self.program_cache)

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
    def derivatives(self):
        """The observed derivative channels, a tuple of ints."""
        return self._derivatives

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

