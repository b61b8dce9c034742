"""PES experiment driver: hyperparameter sampling, x* sampling, the run_PES
loop.

Counterpart of ``cornell_moe_tpu/acquisition/pes_driver.py``: each
iteration samples M hyperparameter sets by MCMC, draws one approximate
global minimum x* per set from a random-feature posterior sample (with the
sample's Hessian there), conditions on it by EP, maximizes the
M-set-averaged PES acquisition (grid seed + gradient polish), evaluates the
suggestion and recommends the argmin of the M-set-averaged posterior mean,
appending to the resumable ``Xsamples.txt`` / ``Ysamples.txt`` /
``guesses.txt`` artifacts.  The M sets are one batch axis throughout.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.acquisition import pes as pes_mod
from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.models import likelihood as lik_mod
from cornell_moe_tpu_torch.models import mcmc as mcmc_mod
from cornell_moe_tpu_torch.models.priors import HorseshoePrior, LognormalPrior
from cornell_moe_tpu_torch.ops import optimizers, programs, random_features
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
from cornell_moe_tpu_torch.utils.logging_utils import PhaseTimer

# the random features of each x* draw
NUM_FEATURES = 1000

# Stretch-move steps per segment program of sample_hypers' chain.  Each
# segment length is built once per n, its build one eager run of the
# segment plus its capture, so short segments replayed many times cost the
# least: burn-in 50 + 100 sets = 150 steps run as 30 replays of 5
CHAIN_SEGMENT = 5

ACQ_PARAMS = optimizers.GradientDescentParameters(
    num_multistarts=1, max_num_steps=60, max_num_restarts=2,
    gamma=0.7, pre_mult=0.1, max_relative_change=0.5)


def _se_ensemble(sigma, lengths, noise, x, y) -> gp_mod.GaussianProcessState:
    """One SE GP per set: sigma (M,), lengths (M, d), noise (M,)."""
    cov = cov_mod.SquareExponential(
        hyperparameters=torch.cat([sigma[:, None], lengths], dim=1))
    return gp_mod.fit_gp(cov, noise[:, None], x, y[:, None])


def log_posterior_hypers(theta: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor, noise_scale: float = 0.1
                         ) -> torch.Tensor:
    """Log-posterior of walkers theta (W, d + 2) = log-(amplitude, lengths,
    noise): lognormal priors on the amplitude and lengths, horseshoe on the
    noise, and the SE GP's LML; -inf where not finite.  As in the
    reference, the lognormal priors read the log-hyperparameters, so any
    theta <= 0 there has log-probability -inf."""
    dim = x.shape[1]
    lp = LognormalPrior(sigma=1.0).lnprob(theta[:, 0:1]) + \
        LognormalPrior(sigma=1.0).lnprob(theta[:, 1:1 + dim]) + \
        HorseshoePrior(scale=noise_scale).lnprob(theta[:, -1:])
    h = torch.exp(theta)
    cov = cov_mod.SquareExponential(hyperparameters=h[:, :1 + dim])
    val = lp + lik_mod.log_marginal_likelihood(cov, h[:, -1:], x, y[:, None])
    return torch.where(torch.isfinite(val), val, float("-inf"))


def _chain_segment_program(cache: programs.ProgramCache, x: torch.Tensor,
                           y: torch.Tensor, noise_scale: float):
    """:func:`sample_hypers`' ``segment_fn`` on the data (x, y): one program
    of ``mcmc.chain_segment`` over :func:`log_posterior_hypers` per (n, W,
    steps), the data among its inputs."""
    def segment(pos, lp, u, idx, acc, xx, yy):
        return mcmc_mod.chain_segment(
            lambda t: log_posterior_hypers(t, xx, yy, noise_scale), pos, lp,
            u, idx, acc)

    def run(pos, lp, u, idx, acc):
        key = ("chain", tuple(x.shape), tuple(y.shape), tuple(pos.shape),
               int(u.shape[0]), x.dtype, str(x.device), "pes_hypers",
               noise_scale)
        return cache.get(key, segment)(pos, lp, u, idx, acc, x, y)

    return run


def sample_hypers(generator: torch.Generator, x: torch.Tensor,
                  y: torch.Tensor, num_sets: int, burnin: int = 50,
                  noise_scale: float = 0.1,
                  program_cache: Optional[programs.ProgramCache] = None):
    """Posterior samples (noise (M,), lengths (M, d), sigma (M,)) of the SE
    kernel's hyperparameters: a stretch-move chain of max(2 (d + 2), M)
    walkers (even) over burnin + M steps from p0 = 0.3 N(0, 1), then M
    walkers picked at random.  With a ``program_cache`` (and
    ``programs.CAPTURE`` "auto") the chain runs in ``CHAIN_SEGMENT``-step
    segments, each one program (:func:`_chain_segment_program`) whose
    stretch moves are drawn eagerly before it, the same steps bit for bit
    as the step-by-step chain."""
    dim = x.shape[1]
    n_walkers = max(2 * (2 + dim), num_sets)
    n_walkers += n_walkers % 2
    p0 = 0.3 * torch.randn((n_walkers, dim + 2), generator=generator,
                           device=x.device, dtype=x.dtype)
    segment_fn = None
    if program_cache is not None and programs.enabled():
        segment_fn = _chain_segment_program(program_cache, x, y,
                                            noise_scale)
    pos, _ = mcmc_mod.run_ensemble_mcmc(
        generator, lambda t: log_posterior_hypers(t, x, y, noise_scale), p0,
        burnin + num_sets, segment_fn=segment_fn, segment=CHAIN_SEGMENT)
    pick = torch.randint(0, n_walkers, (num_sets,), generator=generator,
                         device=x.device)
    samples = torch.exp(pos[pick])
    return samples[:, -1], samples[:, 1:1 + dim], samples[:, 0]


def sample_minimum_with_hessian(generator: Optional[torch.Generator],
                                x: torch.Tensor, y: torch.Tensor, sigma,
                                lengths, noise, domain, grid: torch.Tensor,
                                draws=None, program_cache=None):
    """One approximate global minimum x* per set (M, d) and the Hessian of
    the set's random-feature sample there (M, d, d): the sample is polished
    from its best grid point (its GD steps through ``program_cache``'s
    programs when given), and its Hessian is the closed form
    -scale sum_k theta_k cos(w_k.x + b_k) w_k w_k^T."""
    state = _se_ensemble(sigma, lengths, noise, x, y)
    sample = random_features.sample_gp_with_random_features(
        generator, state, NUM_FEATURES, draws=draws)
    x_min = random_features.global_optimization_of_gp_approximation(
        sample, domain, grid, program_cache=program_cache)
    return x_min, random_features.random_feature_hessian(sample, x_min)


def pes_states(generator, x, y, noise, lengths, sigma, domain, grid,
               program_cache=None) -> pes_mod.PESState:
    """x* draws and EP conditioning for every set."""
    x_min, hess = sample_minimum_with_hessian(
        generator, x, y, sigma, lengths, noise, domain, grid,
        program_cache=program_cache)
    return pes_mod.make_pes_state(x, y, x_min, hess, sigma, lengths, noise,
                                  program_cache=program_cache)


def _step_program(cache, key: tuple, vg_of: Callable, domain,
                  inputs: tuple) -> Optional[Callable]:
    """With a ``cache`` (and ``programs.CAPTURE`` "auto"), a polish's GD
    step ``(x, rate) -> (x_new, dx)`` as one program over (x, ``inputs``):
    the ascent direction is the gradient of ``vg_of(*inputs)`` at x, the
    step size an input; else None (the eager steps)."""
    if cache is None or not programs.enabled():
        return None

    def step(x, rate, bounds, *ins):
        return optimizers.ascent_step(
            TensorProductDomain(bounds=bounds),
            ACQ_PARAMS.max_relative_change, x, vg_of(*ins)(x)[1], rate)

    return cache.stepper(key + programs.signature(inputs), step,
                         domain.bounds, *inputs)


def _autograd(fn: Callable) -> Callable:
    """p -> (fn(p), its gradient), detached."""
    def vg(p):
        with torch.enable_grad():
            pp = p.detach().requires_grad_(True)
            v = fn(pp)
            (g,) = torch.autograd.grad(v, pp)
        return v.detach(), g
    return vg


def maximize_acquisition(states: pes_mod.PESState, x: torch.Tensor, domain,
                         grid: torch.Tensor,
                         program_cache: Optional[programs.ProgramCache] = None
                         ) -> torch.Tensor:
    """Grid seed and gradient polish of the M-set-averaged acquisition; the
    polish is kept only if it beats the best grid value (read on the
    host).  With a ``program_cache`` (and ``programs.CAPTURE`` "auto") the
    grid's evaluation is one program and each polish step another
    (:func:`_step_program`)."""
    def acq_of(xs, *fields):
        st = pes_mod.PESState(*fields)
        return lambda p: pes_mod.pes_acquisition_multi(p[None], st, xs)[0]

    grid_vals = programs.run(
        program_cache, ("pes_acquisition_grid",),
        lambda g, xs, *fields: pes_mod.pes_acquisition_multi(
            g, pes_mod.PESState(*fields), xs), grid, x, *states)
    x0 = grid[torch.argmax(grid_vals)]
    step_fn = _step_program(
        program_cache, ("pes_acquisition_step",),
        lambda *ins: _autograd(acq_of(*ins)), domain, (x, *states))
    x_opt = optimizers.gradient_ascent(_autograd(acq_of(x, *states)),
                                       domain, x0, ACQ_PARAMS,
                                       step_fn=step_fn)
    return x_opt if bool(acq_of(x, *states)(x_opt) > grid_vals.max()) \
        else x0


def recommend(x: torch.Tensor, y: torch.Tensor, noise, lengths, sigma,
              domain, grid: torch.Tensor,
              program_cache: Optional[programs.ProgramCache] = None
              ) -> torch.Tensor:
    """Argmin of the M-set-averaged posterior mean: grid seed and gradient
    polish, the polish kept only if it beats the grid (read on the host).
    With a ``program_cache`` (and ``programs.CAPTURE`` "auto") the grid's
    evaluation is one program and each polish step another, over the
    fitted sets' mean fields."""
    states = _se_ensemble(sigma, lengths, noise, x, y)
    tensors, layout = gp_mod.state_tensors(states, gp_mod.MEAN_FIELDS)

    def neg_post_mean_of(*ts):                   # (P, d) -> (P,)
        st = gp_mod.state_from_tensors(layout, ts)
        return lambda p: -torch.mean(gp_mod.posterior_mean(st, p)[..., 0],
                                     dim=0)

    grid_pm = programs.run(
        program_cache, ("pes_recommend_grid", layout),
        lambda g, *ts: neg_post_mean_of(*ts)(g), grid, *tensors)
    p0 = grid[torch.argmax(grid_pm)]
    step_fn = _step_program(
        program_cache, ("pes_recommend_step", layout),
        lambda *ts: _autograd(lambda p: neg_post_mean_of(*ts)(p[None])[0]),
        domain, tuple(tensors))
    p_opt = optimizers.gradient_ascent(
        _autograd(lambda p: neg_post_mean_of(*tensors)(p[None])[0]), domain,
        p0, ACQ_PARAMS, step_fn=step_fn)
    return p_opt if bool(neg_post_mean_of(*tensors)(p_opt[None])[0] >
                         grid_pm.max()) else p0


def _capture_seconds(cache: programs.ProgramCache) -> dict:
    """Per program kind, the seconds its builds took (warm-up and
    capture; 0 on the CPU, where a build only counts)."""
    out = {}
    for key, prog in cache.programs().items():
        kind = programs.kind(key)
        out[kind] = out.get(kind, 0.0) + (prog.capture_seconds or 0.0)
    return out


def run_PES(target_function, x_minimum, x_maximum, dimension,
            number_of_hyperparameter_sets: int = 100,
            number_of_burnin: int = 50,
            sampling_method: str = "mcmc",
            number_of_initial_points: int = 3,
            number_of_experiments: int = 1,
            number_of_iterations: int = 60,
            number_of_features: int = 1000,
            optimization_method: str = "sga",
            seed: Optional[int] = None,
            output_dir: str = ".",
            gridsize: int = 500,
            verbose: bool = True, device=None, dtype=None,
            timer: Optional[PhaseTimer] = None):
    """The PES loop.  Returns the history of (suggested point, value,
    recommendation, best so far) and appends each iteration to the
    artifacts in ``output_dir``.  Runs on ``cuda:0`` unless ``device``
    says otherwise.  The sampling and optimization methods and the feature
    count are fixed (MCMC, SGA, NUM_FEATURES), as in the JAX package.
    Each iteration's parts are timed into ``timer`` when given
    (``hyperparameters``, ``x_star_draws_and_ep`` with the count of
    ``finite_sets``, ``acquisition``, ``recommend``).

    While ``programs.CAPTURE`` is "auto" the run owns one
    ``ProgramCache``: the chain's segments, the x* polish's and both
    polishes' GD steps, EP's sweep and the two grid evaluations are
    programs (CUDA graphs on the card).  Every iteration has one more
    observation, so the cache is released at the start of each iteration
    and at the end of the run: it holds one n's programs at a time.  Each
    history entry carries that iteration's ``programs`` by kind (builds,
    replays) and their ``capture_seconds`` by kind."""
    del sampling_method, number_of_features, optimization_method
    device = torch.device(device) if device is not None \
        else config.default_device()
    dtype = dtype if dtype is not None else config.default_dtype(device)
    kw = dict(device=device, dtype=dtype)
    timer = timer if timer is not None else PhaseTimer()
    generator = torch.Generator(device=device).manual_seed(
        0 if seed is None else seed)
    bounds = np.stack([np.asarray(x_minimum, float),
                       np.asarray(x_maximum, float)], axis=1)
    domain = TensorProductDomain.from_bounds(bounds, **kw)
    m_sets = number_of_hyperparameter_sets

    def log(msg):
        if verbose:
            print(msg, flush=True)

    def write_artifact(name, arr):
        with open(os.path.join(output_dir, name), "a") as f:
            np.savetxt(f, np.atleast_2d(np.asarray(arr)))

    cache = programs.ProgramCache()
    history = []
    for pp in range(number_of_experiments):
        xs = domain.generate_latin_hypercube_points(
            generator, number_of_initial_points).cpu().numpy().astype(float)
        ys = np.asarray([float(target_function(p)) for p in xs])
        write_artifact("Xsamples.txt", xs)
        write_artifact("Ysamples.txt", ys[:, None])
        write_artifact("guesses.txt", xs)
        log(f"Best so far in the initial data {ys.min():.6f}")

        for it in range(number_of_iterations):
            log(f"PES, {pp}th job, {it}th iteration")
            cache.release()
            xt, yt = torch.as_tensor(xs, **kw), torch.as_tensor(ys, **kw)
            with timer.phase("hyperparameters"):
                noise_s, len_s, sig_s = sample_hypers(
                    generator, xt, yt, m_sets, number_of_burnin,
                    program_cache=cache)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            grid = domain.generate_latin_hypercube_points(generator,
                                                          gridsize)
            with timer.phase("x_star_draws_and_ep") as found:
                states = pes_states(generator, xt, yt, noise_s, len_s, sig_s,
                                    domain, grid, program_cache=cache)
                finite = torch.isfinite(states.k_plus_w_inv).flatten(1).all(
                    1) & torch.isfinite(states.m_f_min) & \
                    torch.isfinite(states.v_f_min)
                found["finite_sets"] = int(finite.sum())
            log(f"{found['finite_sets']} of {m_sets} hyperparameter sets "
                "finite")
            with timer.phase("acquisition"):
                optimum = maximize_acquisition(
                    states, xt, domain, grid,
                    program_cache=cache).cpu().numpy().astype(float)
            value = float(target_function(optimum))
            xs = np.vstack([xs, optimum])
            ys = np.append(ys, value)
            write_artifact("Xsamples.txt", optimum)
            write_artifact("Ysamples.txt", [[value]])
            log(f"PES suggests: {optimum}")

            with timer.phase("recommend"):
                rec = recommend(
                    torch.as_tensor(xs, **kw), torch.as_tensor(ys, **kw),
                    noise_s, len_s, sig_s, domain, grid,
                    program_cache=cache).cpu().numpy().astype(float)
            rec_value = float(target_function(rec))
            if rec_value >= ys.min():
                rec = xs[np.argmin(ys)]
                rec_value = float(ys.min())
            write_artifact("guesses.txt", rec)
            log(f"The recommended point {rec}; best so far "
                f"{min(rec_value, float(ys.min())):.6f}")
            history.append({"experiment": pp, "iteration": it,
                            "suggested": optimum, "value": value,
                            "recommended": rec,
                            "best_so_far": float(ys.min()),
                            "programs": programs.by_kind(cache),
                            "capture_seconds": _capture_seconds(cache)})
    cache.release()
    return history
