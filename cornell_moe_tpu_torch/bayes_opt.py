"""High-level Bayesian-optimization driver (q-KG, d-KG, cf-KG and q-EI).

Counterpart of ``cornell_moe_tpu/bayes_opt.py``: MCMC train -> suggest ->
observe and gated retrain -> recommend (argmin of the ensemble posterior
mean), checkpointed after each iteration when ``checkpoint_path`` is set
and resumable from it.  Method "KG" seeds its discretization with q-EI and
runs the warm, gated q-KG multistart.  An objective with observed partial
derivatives (``_observations``) trains on 1 + m channels per point, and its
KG fantasizes those channels too (d-KG).  An objective with fidelity dims
(``_num_fidelity``, the last coordinates) runs continuous-fidelity KG: the
KG is divided by each union's cost, the inner problem, the seeding and the
recommendation work on the other coordinates with the fidelity ones pinned
to 1, and ``capital_so_far`` adds up the largest fidelity product of each
observed batch.  Method "EI" maximizes q,p-EI on ensemble member 0.  The
port runs eagerly; there is no cache of compiled programs.

Scale-out (``n_devices`` or ``process_group``): every rank of a
``torch.distributed`` group runs this loop from the same seed, and the
multistarts' restart axis, the chain's walkers and the recommend grid are
sharded over the ranks (``parallel.sharding``).  Rank 0 alone evaluates the
objective, and the values are broadcast, so the observations never diverge;
rank 0 alone prints and writes checkpoints, and every rank reads them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.acquisition import expected_improvement as ei_mod
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg_mod
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.models import mcmc as mcmc_mod
from cornell_moe_tpu_torch.ops import optimizers
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
from cornell_moe_tpu_torch.parallel import sharding
from cornell_moe_tpu_torch.utils import checkpoint as ckpt
from cornell_moe_tpu_torch.utils.data_containers import (HistoricalData,
                                                         SamplePoint)
from cornell_moe_tpu_torch.utils.logging_utils import PhaseTimer

METHODS = ("KG", "EI")

# The reference driver's optimizer parameter packs
DEFAULT_SGD_PARAMS_KG = optimizers.GradientDescentParameters(
    num_multistarts=200, max_num_steps=50, max_num_restarts=2,
    num_steps_averaged=4, gamma=0.7, pre_mult=1.0,
    max_relative_change=0.5, tolerance=1.0e-10)
DEFAULT_SGD_PARAMS_PS = optimizers.GradientDescentParameters(
    num_multistarts=1, max_num_steps=6, max_num_restarts=1,
    num_steps_averaged=3, gamma=0.0, pre_mult=1.0,
    max_relative_change=0.1, tolerance=1.0e-10)
# one 1000-step trajectory, the reference's actual recommend behaviour
DEFAULT_SGD_PARAMS_RECOMMEND = optimizers.GradientDescentParameters(
    num_multistarts=1, max_num_steps=1000, max_num_restarts=1,
    num_steps_averaged=15, gamma=0.7, pre_mult=1.0,
    max_relative_change=0.02, tolerance=1.0e-10)


def _qei_suggest_arrays(generator, state, domain, params, num_to_sample,
                        num_mc, conv_tol=None, chunk_size=None, group=None):
    """One GP's q-EI suggestion (q, d) and its EI on fresh draws (model
    units)."""
    pts = ei_mod.multistart_expected_improvement_optimization(
        generator, state, domain, num_to_sample, params,
        num_mc_iterations=num_mc, conv_tol=conv_tol, chunk_size=chunk_size,
        group=group)
    voi = ei_mod.evaluate_expected_improvement_at_point_list(
        state, pts[None], generator=generator, num_mc_iterations=num_mc)[0]
    return pts, voi


def gen_sample_from_qei(generator, state, domain, params, num_to_sample,
                        num_mc=2**10):
    """q-EI suggestion from one GP: (points (q, d), EI)."""
    pts, voi = _qei_suggest_arrays(generator, state, domain, params,
                                   num_to_sample, num_mc)
    return pts, float(voi)


def gen_sample_from_qei_mcmc(generator, states, domain, params,
                             num_to_sample, num_mc=2**10):
    """Ensemble-averaged q-EI suggestion: (points (q, d), mean EI on fresh
    draws)."""
    pts = ei_mod.multistart_expected_improvement_mcmc_optimization(
        generator, states, domain, num_to_sample, params,
        num_mc_iterations=num_mc)
    normals = ei_mod.draw_normals(generator, num_mc, num_to_sample,
                                  device=pts.device, dtype=pts.dtype)
    voi = ei_mod.monte_carlo_expected_improvement_mcmc(
        states, pts, None, states.best_observed_value, normals)
    return pts, float(voi)


def seed_kg_discretization(generator, states, domain, qei_params=None,
                           ps_params=DEFAULT_SGD_PARAMS_PS,
                           num_qei_pts: int = 10, num_eval_pts: int = 1000,
                           num_mc: int = 2**10, conv_tol=None,
                           chunk_size=None, num_fidelity: int = 0,
                           group=None) -> torch.Tensor:
    """Per-member inner-optimization seeds for KG, (S, num_qei_pts + 1,
    dim_opt): num_qei_pts points from ensemble q-EI plus each member's
    posterior-mean argmin (uniform eval points + its sampled points,
    GD-polished), on the inner domain with fidelity coordinates pinned.
    A ``group`` shards the q-EI's restart axis."""
    if qei_params is None:
        qei_params = DEFAULT_SGD_PARAMS_KG
    discrete = ei_mod.multistart_expected_improvement_mcmc_optimization(
        generator, states, domain, num_qei_pts, qei_params,
        num_mc_iterations=num_mc, conv_tol=conv_tol, chunk_size=chunk_size,
        group=group)
    s = states.points_sampled.shape[0]
    inner = kg_mod.inner_domain(domain, num_fidelity)
    dim_opt = inner.dim
    eval_pts = inner.generate_uniform_random_points_in_domain(
        generator, num_eval_pts)
    guesses = torch.cat([eval_pts.expand((s,) + eval_pts.shape),
                         states.points_sampled[..., :dim_opt]], dim=1)
    pt, _ = kg_mod.compute_optimal_posterior_mean(states, inner, guesses,
                                                  ps_params, num_fidelity)
    discrete = discrete[:, :dim_opt]
    return torch.cat([discrete.expand((s,) + discrete.shape), pt[:, None]],
                     dim=1)


def best_so_far_from_discretization(states, discrete_pts,
                                    num_fidelity: int = 0) -> torch.Tensor:
    """Per-member min posterior mean over its discretization (fidelity
    coordinates pinned to 1), (S,)."""
    mus = gp_mod.posterior_mean(
        states, kg_mod._pin_fidelity(discrete_pts, num_fidelity))[..., 0]
    return torch.min(mus, dim=-1).values


def _qkg_suggest_arrays(generator, states, domain, discrete_pts, params,
                        inner_params, num_to_sample, num_mc, conv_tol=None,
                        chunk_size=None, derivatives_to_sample=(),
                        num_fidelity: int = 0, group=None):
    """Suggested points (q, d) and their VOI (ensemble KG divided by the
    fidelity cost, model units).  The fantasy observations at the
    suggested points include the ``derivatives_to_sample`` channels
    (d-KG)."""
    ds = tuple(int(i) for i in derivatives_to_sample)
    best_so_far = best_so_far_from_discretization(states, discrete_pts,
                                                  num_fidelity)
    pts = kg_mod.multistart_knowledge_gradient_mcmc_optimization(
        generator, states, domain, num_to_sample, params, inner_params,
        discrete_pts, best_so_far=best_so_far, num_mc_iterations=num_mc,
        chunk_size=chunk_size, conv_tol=conv_tol, derivatives_to_sample=ds,
        num_fidelity=num_fidelity, group=group)
    normals = ei_mod.draw_antithetic_normals(
        generator, num_mc, num_to_sample * (1 + len(ds)), device=pts.device,
        dtype=pts.dtype)
    voi = kg_mod.knowledge_gradient_mcmc(
        states, pts, discrete_pts, normals,
        kg_mod.inner_domain(domain, num_fidelity), inner_params, best_so_far,
        ds, num_fidelity)
    return pts, voi


def gen_sample_from_qkg_mcmc(generator, states, domain, discrete_pts,
                             params=None, inner_params=DEFAULT_SGD_PARAMS_PS,
                             num_to_sample: int = 1, num_mc=2**7,
                             num_fidelity: int = 0):
    """Ensemble-averaged q-KG suggestion: (points (q, d), KG)."""
    if params is None:
        params = DEFAULT_SGD_PARAMS_KG
    pts, voi = _qkg_suggest_arrays(generator, states, domain, discrete_pts,
                                   params, inner_params, num_to_sample,
                                   num_mc, num_fidelity=num_fidelity)
    return pts, float(voi)


def recommend_from_guesses(states, domain, guesses: torch.Tensor,
                           params=DEFAULT_SGD_PARAMS_RECOMMEND,
                           num_fidelity: int = 0, group=None
                           ) -> torch.Tensor:
    """Best guess (G, dim_opt) under the ensemble-mean posterior mean
    (fidelity coordinates pinned to 1), then one GD polish over the inner
    ``domain``; the polish is kept only if it improves.  A ``group`` shards
    the guesses' evaluation over its ranks."""
    dim = guesses.shape[-1]

    def ensemble_neg_mean(x):                     # (..., dim_opt) -> (...)
        mu = gp_mod.posterior_mean(
            states, kg_mod._pin_fidelity(x.reshape(-1, dim), num_fidelity))
        return -torch.mean(mu[..., 0], dim=0).reshape(x.shape[:-1])

    vals = sharding.sharded_point_evaluation(ensemble_neg_mean, guesses,
                                             group)
    vals = torch.where(torch.isfinite(vals), vals, float("-inf"))
    x0 = guesses[torch.argmax(vals)]

    def vg(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            v = ensemble_neg_mean(xx)
            (g,) = torch.autograd.grad(v, xx)
        return v.detach(), g

    x = optimizers.gradient_ascent(vg, domain, x0, params)
    return x if bool(ensemble_neg_mean(x) > vals.max()) else x0


@dataclass
class BayesianOptimizer:
    """The suggest/observe/recommend loop for method "KG" (on an objective
    with observed partial derivatives, d-KG; with fidelity dims, cf-KG) or
    "EI"."""

    objective_func: object = None
    method: str = "KG"
    num_to_sample: int = 1
    num_mc: Optional[int] = None
    n_hypers: int = 16
    chain_length: int = 1000
    burnin_steps: int = 2000
    noisy: bool = False
    kernel_name: str = "matern_2.5"
    sgd_params: optimizers.GradientDescentParameters = DEFAULT_SGD_PARAMS_KG
    inner_sgd_params: optimizers.GradientDescentParameters = \
        DEFAULT_SGD_PARAMS_PS
    seed: int = 0
    verbose: bool = True
    # written after each iteration when set (utils/checkpoint.py)
    checkpoint_path: Optional[str] = None
    # pad num_sampled to multiples of this (huge-noise dummy points)
    shape_bucket: int = 16
    # step-norm gates: warm KG outer GD, seeding q-EI GD, retrain chain
    suggest_conv_tol: Optional[float] = 3e-3
    seed_conv_tol: Optional[float] = 3e-3
    chain_gate_tol: Optional[float] = 1.0
    # train on standardized values (derivative channels scaled by 1/std);
    # VOI is reported in raw units
    standardize: bool = False
    # KG's fantasy observations include the objective's observed derivative
    # channels (d-KG); False fantasizes value channels only
    kg_sample_derivatives: bool = True
    # the restart axis's chunking (KG, the seeding q-EI and the EI suggest);
    # with a process group, the per-rank shard by default, so that a
    # sharded run equals an unsharded one given the same chunking
    suggest_chunk_size: Optional[int] = None
    device: Optional[object] = None
    dtype: Optional[torch.dtype] = None
    # scale-out: a torch.distributed group, or n_devices to take the
    # default one (sharding.default_process_group: the initialized group,
    # else torchrun's, else a world of one)
    n_devices: Optional[int] = None
    process_group: Optional[object] = None

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"method {self.method!r} not supported: "
                             f"choose one of {METHODS}")
        f = self.objective_func
        self.num_fidelity = f._num_fidelity
        self.derivatives = tuple(int(i) for i in f._observations)
        if self.process_group is None and self.n_devices:
            self.process_group = sharding.default_process_group(
                self.n_devices, self.device)
        if self.process_group is not None and \
                self.suggest_chunk_size is None:
            self.suggest_chunk_size = max(
                self.sgd_params.num_multistarts //
                dist.get_world_size(self.process_group), 1)
        self.device = torch.device(self.device) if self.device is not None \
            else config.default_device()
        if self.dtype is None:
            self.dtype = config.default_dtype(self.device)
        self.dim = f._dim
        self.domain = TensorProductDomain.from_bounds(
            f._search_domain, device=self.device, dtype=self.dtype)
        self.num_mc = self.num_mc or (2**7 if self.method == "KG"
                                      else 2**10)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self.capital_so_far = 0.0
        self.history = []
        self.timer = PhaseTimer()

    @property
    def is_rank0(self) -> bool:
        return self.process_group is None or \
            dist.get_rank(self.process_group) == 0

    def _log(self, msg):
        if self.verbose and self.is_rank0:
            print(msg, flush=True)

    def _on_rank0(self, fn, *args):
        """``fn(*args)`` run on rank 0 alone, its value broadcast to every
        rank (the objective's evaluations)."""
        if self.process_group is None:
            return fn(*args)
        value = fn(*args) if self.is_rank0 else None
        return sharding.broadcast_from_rank0(value, self.process_group)

    def _evaluate(self, points) -> list:
        """The observed entries of ``evaluate`` at each point (rank 0's)."""
        f = self.objective_func
        return self._on_rank0(
            lambda: [f.evaluate(pt)[self._obs_idx] for pt in points])

    def initialize(self, num_init_pts: Optional[int] = None):
        f = self.objective_func
        n = num_init_pts or f._num_init_pts
        pts = self.domain.generate_latin_hypercube_points(
            self.generator, n).cpu().numpy()
        data = HistoricalData(self.dim, len(self.derivatives))
        for pt, val in zip(pts, self._evaluate(pts)):
            data.append_sample_points([SamplePoint(pt, val, f._sample_var)])
        self.model = mcmc_mod.GaussianProcessLogLikelihoodMCMC(
            data, chain_length=self.chain_length,
            burnin_steps=self.burnin_steps, n_hypers=self.n_hypers,
            noisy=self.noisy, kernel_name=self.kernel_name,
            generator=self.generator, bucket=self.shape_bucket,
            standardize=self.standardize,
            chain_gate_tol=self.chain_gate_tol, device=self.device,
            dtype=self.dtype, derivatives=self.derivatives,
            process_group=self.process_group)
        t0 = time.time()
        self.model.train()
        self._log(f"initial training took {time.time() - t0:.2f}s on "
                  f"{n} points")
        return data

    @property
    def _obs_idx(self):
        """The entries of ``evaluate``'s output that are observed: the
        value and the observed partials."""
        return [0] + [1 + i for i in self.derivatives]

    def suggest(self):
        t0 = time.time()
        states = self.model.models
        if self.method == "KG":
            discrete = seed_kg_discretization(
                self.generator, states, self.domain,
                qei_params=self.sgd_params, ps_params=self.inner_sgd_params,
                conv_tol=self.seed_conv_tol,
                chunk_size=self.suggest_chunk_size,
                num_fidelity=self.num_fidelity, group=self.process_group)
            pts, voi = _qkg_suggest_arrays(
                self.generator, states, self.domain, discrete,
                self.sgd_params, self.inner_sgd_params, self.num_to_sample,
                self.num_mc, conv_tol=self.suggest_conv_tol,
                chunk_size=self.suggest_chunk_size,
                derivatives_to_sample=self.derivatives
                if self.kg_sample_derivatives else (),
                num_fidelity=self.num_fidelity, group=self.process_group)
        else:
            # q,p-EI on a single GP, member 0 of the ensemble
            pts, voi = _qei_suggest_arrays(
                self.generator, mcmc_mod.ensemble_member(states, 0),
                self.domain, self.sgd_params, self.num_to_sample,
                self.num_mc, conv_tol=self.suggest_conv_tol,
                chunk_size=self.suggest_chunk_size, group=self.process_group)
        # VOI back to raw units (KG and EI are linear in the value scale)
        pts = pts.cpu().numpy()
        voi = float(voi) * self.model.value_scale
        self._log(f"{self.method} suggest took {time.time() - t0:.2f}s, "
                  f"VOI {voi:.6f}")
        return pts, voi

    def observe(self, points):
        f = self.objective_func
        points = np.atleast_2d(points)
        sampled = [SamplePoint(pt, val, f._sample_var)
                   for pt, val in zip(points, self._evaluate(points))]
        if self.num_fidelity:
            capitals = np.prod(np.atleast_2d(points)[
                :, self.dim - self.num_fidelity:], axis=1)
            self.capital_so_far += float(np.max(capitals))
        t0 = time.time()
        self.model.add_sampled_points(sampled)
        self.model.train()
        self._log(f"retraining took {time.time() - t0:.2f}s")
        return sampled

    def recommend(self, num_eval_pts: int = 10000) -> np.ndarray:
        """Argmin of the ensemble posterior mean over a uniform grid plus
        the (bucket-padded) sampled points, GD-polished, on the inner
        domain; the fidelity coordinates of the result are 1."""
        t0 = time.time()
        states = self.model.models
        inner = kg_mod.inner_domain(self.domain, self.num_fidelity)
        eval_pts = inner.generate_uniform_random_points_in_domain(
            self.generator, num_eval_pts)
        guesses = torch.cat([eval_pts,
                             states.points_sampled[0][:, :inner.dim]], dim=0)
        best = recommend_from_guesses(states, inner, guesses,
                                      num_fidelity=self.num_fidelity,
                                      group=self.process_group)
        self._log(f"recommendation took {time.time() - t0:.2f}s")
        return np.concatenate([best.cpu().numpy(),
                               np.ones(self.num_fidelity)])

    def save_checkpoint(self, iteration: int) -> None:
        """Write the data, the model's walker state and the generator's
        state to ``checkpoint_path`` (nothing when it is None).  In a group
        rank 0 writes, and every rank waits until it has."""
        if self.checkpoint_path is None:
            return
        if self.is_rank0:
            ckpt.save_checkpoint(
                self.checkpoint_path, self.model._data,
                mcmc_model=self.model, generator=self.generator,
                metadata={"iteration": iteration, "method": self.method,
                          "capital": self.capital_so_far})
        if self.process_group is not None:
            dist.barrier(group=self.process_group)

    def resume(self, path: Optional[str] = None) -> dict:
        """Restore the model (data, walker state, ensemble) and the
        generator's state from a checkpoint; returns its metadata (the last
        completed iteration among it).  A JAX package checkpoint carries
        no generator state: the generator is then seeded from ``seed``.
        Every rank reads the checkpoint; the driver's process group is
        attached to the restored model."""
        self.model, manifest = ckpt.restore_mcmc_model(
            path or self.checkpoint_path, generator=self.generator,
            seed=self.seed, device=self.device, dtype=self.dtype)
        self.model.process_group = self.process_group
        self.capital_so_far = manifest["metadata"].get("capital", 0.0)
        return manifest["metadata"]

    def run(self, num_iterations: int, num_init_pts: Optional[int] = None,
            start_iteration: int = 0):
        """Iterations ``start_iteration`` .. ``num_iterations`` - 1; the
        first initializes the model unless the run resumes."""
        if start_iteration == 0:
            with self.timer.phase("initialize"):
                self.initialize(num_init_pts)
        for it in range(start_iteration, num_iterations):
            self._log(f"--- iteration {it} ({self.method}, "
                      f"q={self.num_to_sample}) ---")
            with self.timer.phase("suggest", method=self.method):
                pts, voi = self.suggest()
            with self.timer.phase("observe_retrain"):
                self.observe(pts)
            with self.timer.phase("recommend"):
                report = self.recommend()
            true_val = float(self._on_rank0(
                self.objective_func.evaluate_true, report)[0])
            self._log(f"recommended point {report}, true value "
                      f"{true_val:.6f}")
            self.history.append({
                "iteration": it, "voi": voi, "suggested": pts,
                "recommended": report, "true_value": true_val,
                "capital": self.capital_so_far})
            self.save_checkpoint(it)
        return self.history
