"""MCMC-averaged KG classes (compat layer).

Counterpart of ``cornell_moe_tpu/compat/knowledge_gradient_mcmc.py`` (the
reference's ``cpp_wrappers/knowledge_gradient_mcmc.py``):
GaussianProcessMCMC, PosteriorMeanMCMC, KnowledgeGradientMCMC and
multistart_knowledge_gradient_mcmc_optimization.  The suggestion runs the
core's warm batched multistart, whose inner descent goes through the
hand-written descent kernel on the card.  A ``GaussianProcessMCMC`` owns a
``ProgramCache`` (``ops.programs``): its ensemble fit, the optimizers'
steps and the point lists' blocks run as programs of it (CUDA graphs on
the card) while ``programs.CAPTURE`` is "auto"; the multistart and a
single VOI run eagerly, by the rule of
:func:`multistart_knowledge_gradient_mcmc_optimization`.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.acquisition import expected_improvement as ei_core
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg_core
from cornell_moe_tpu_torch.compat._boundary import (
    ProgramForm, UnionPoints, domain_bounds, domain_key, ensemble_cache, rows,
    to_numpy, to_tensor, value_and_grad_by_autograd, with_bounds)
from cornell_moe_tpu_torch.compat.interfaces import OptimizableInterface
from cornell_moe_tpu_torch.compat.knowledge_gradient import \
    data_bounds_domain
from cornell_moe_tpu_torch.compat.optimization import (
    core_domain, multistart_parameters)
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.models import mcmc as mcmc_mod
from cornell_moe_tpu_torch.ops import programs
from cornell_moe_tpu_torch.utils.rng import as_generator


class GaussianProcessMCMC:
    """A stacked ensemble of GPs, one per hyperparameter sample
    (cpp_wrappers/knowledge_gradient_mcmc.py GaussianProcessMCMC), fitted
    on ``device`` in ``dtype`` (``mcmc.fit_gp_ensemble``, one program per
    shapes of its ``program_cache``, which the objectives built on it
    share)."""

    def __init__(self, hyperparameters_list, noise_variance_list,
                 historical_data, derivatives: Sequence[int] = (),
                 kernel_name: str = "matern_2.5", device=None, dtype=None):
        self._hypers = np.atleast_2d(np.asarray(hyperparameters_list,
                                                dtype=float))
        self._noises = np.atleast_2d(np.asarray(noise_variance_list,
                                                dtype=float))
        self._historical_data = historical_data
        self._derivatives = tuple(int(i) for i in derivatives)
        self._kernel_name = kernel_name
        self.device, self.dtype = config.placement(device, dtype)
        self.program_cache = programs.ProgramCache()
        self._refit()

    def _refit(self):
        data = self._historical_data
        self._states = mcmc_mod.fit_gp_ensemble(
            self._kernel_name, to_tensor(self._hypers, self.device,
                                         self.dtype),
            to_tensor(self._noises, self.device, self.dtype),
            data.points_sampled, data.points_sampled_value,
            self._derivatives, program_cache=self.program_cache)

    @property
    def states(self):
        """Stacked functional states."""
        return self._states

    @property
    def dim(self):
        return self._historical_data.dim

    @property
    def num_sampled(self):
        return self._historical_data.num_sampled

    @property
    def num_mcmc(self):
        return self._hypers.shape[0]

    @property
    def derivatives(self):
        return self._derivatives

    def get_historical_data_copy(self):
        return copy.deepcopy(self._historical_data)

    def add_sampled_points(self, sampled_points):
        self._historical_data.append_sample_points(sampled_points)
        self._refit()


class PosteriorMeanMCMC(OptimizableInterface):
    """Ensemble-averaged -posterior_mean
    (cpp_wrappers/knowledge_gradient_mcmc.py PosteriorMeanMCMC).

    Accepts either a GaussianProcessMCMC (whose program cache it shares)
    or a stacked functional state (its own cache).
    """

    def __init__(self, gp_mcmc, num_fidelity: int = 0,
                 point_to_sample=None):
        self._states = getattr(gp_mcmc, "states", gp_mcmc)
        self.program_cache = ensemble_cache(gp_mcmc)
        x = self._states.points_sampled
        self.device, self.dtype = x.device, x.dtype
        self._num_fidelity = num_fidelity
        self._dim = x.shape[-1]
        dim_opt = self._dim - num_fidelity
        self._point = np.zeros(dim_opt) if point_to_sample is None else \
            np.asarray(point_to_sample, dtype=float).reshape(-1)[:dim_opt]

    @property
    def dim(self):
        return self._dim

    @property
    def num_fidelity(self):
        return self._num_fidelity

    @property
    def problem_size(self):
        return self._dim - self._num_fidelity

    def get_current_point(self):
        return np.copy(self._point)

    def set_current_point(self, point):
        self._point = np.asarray(point, dtype=float).reshape(-1)[
            :self.problem_size]

    def program_form(self) -> ProgramForm:
        """The ensemble's mean fields as the inputs."""
        tensors, layout = gp_mod.state_tensors(self._states,
                                               gp_mod.MEAN_FIELDS)
        nf = self._num_fidelity

        def objective(point, *ts):
            states = gp_mod.state_from_tensors(layout, ts)
            s = states.points_sampled.shape[0]
            return torch.mean(kg_core.posterior_mean_objective(
                states, point.expand(s, -1), nf))

        return ProgramForm(("posterior_mean_mcmc", layout, nf),
                           tuple(tensors), objective)

    def objective_torch(self, point):
        """Ensemble mean of -mu at the fidelity-pinned point (dim_opt,),
        differentiable."""
        form = self.program_form()
        return form.objective(point, *form.inputs)

    def value_and_grad_torch(self, point):
        return value_and_grad_by_autograd(self.objective_torch, point)

    def _current(self):
        return to_tensor(self._point, self.device, self.dtype)

    def compute_objective_function(self):
        return float(self.objective_torch(self._current()))

    def compute_grad_objective_function(self):
        return to_numpy(self.value_and_grad_torch(self._current())[1])


class KnowledgeGradientMCMC(UnionPoints, OptimizableInterface):
    """Ensemble-averaged q-KG with continuous-fidelity cost
    (cpp_wrappers/knowledge_gradient_mcmc.py KnowledgeGradientMCMC).

    Each member's best-so-far is the least posterior mean over its own
    discretization; the inner (posterior-mean) domain is the bounding box
    of the data and the discretizations.  The antithetic MC normals are
    drawn from ``generator`` (a ``torch.Generator`` or a seed, 0 when None)
    when the union's width is first set.
    """

    def __init__(self, gaussian_process_mcmc, gaussian_process_list=None,
                 num_fidelity: int = 0, inner_optimizer=None,
                 discrete_pts_list=None, points_to_sample=None,
                 points_being_sampled=None, num_to_sample: int = 1,
                 num_mc_iterations: int = 2**7, generator=None):
        del gaussian_process_list
        self._gp_mcmc = gaussian_process_mcmc
        self._states = gaussian_process_mcmc.states
        self.program_cache = ensemble_cache(gaussian_process_mcmc)
        self.device = gaussian_process_mcmc.device
        self.dtype = gaussian_process_mcmc.dtype
        self._num_fidelity = num_fidelity
        self._inner_params = getattr(inner_optimizer,
                                     "optimizer_parameters",
                                     inner_optimizer)
        discrete = np.stack([np.atleast_2d(np.asarray(d, dtype=float))
                             for d in discrete_pts_list])
        self._discrete_pts = self._tensor(discrete)
        self._num_mc_iterations = num_mc_iterations
        self._points_being_sampled = rows(points_being_sampled)
        self._generator = as_generator(generator, self.device)
        self._normals = None

        # per-member best = min posterior mean over its discretization
        self._best_so_far_list = torch.min(gp_mod.posterior_mean(
            self._states, kg_core._pin_fidelity(self._discrete_pts,
                                                num_fidelity))[..., 0],
            dim=-1).values
        if points_to_sample is None:
            points_to_sample = np.zeros((num_to_sample,
                                         self._gp_mcmc.dim))
        self.set_current_point(points_to_sample)

        dim_opt = self._gp_mcmc.dim - num_fidelity
        self._inner_domain = data_bounds_domain(
            self._gp_mcmc._historical_data.points_sampled,
            discrete.reshape(-1, dim_opt), dim_opt, self.device, self.dtype)

    _draw_normals = staticmethod(ei_core.draw_antithetic_normals)

    @property
    def dim(self):
        return self._gp_mcmc.dim

    def set_inner_domain(self, domain):
        self._inner_domain = core_domain(domain)

    def program_form(self) -> ProgramForm:
        """The ensemble, the discretization, the normals, the per-member
        best values, the inner domain's bounds and the points being
        sampled as the inputs."""
        tensors, layout = gp_mod.state_tensors(self._states)
        being = self._being()
        inputs = (*tensors, self._discrete_pts, self._normals,
                  self._best_so_far_list, domain_bounds(self._inner_domain)
                  ) + (() if being is None else (being,))
        k, inner, nf, q = len(tensors), self._inner_domain, \
            self._num_fidelity, self.num_to_sample
        inner_params = self._inner_params

        def objective(points_to_sample, *ins):
            disc, nrm, best, bounds, *rest = ins[k:]
            return kg_core.knowledge_gradient_mcmc(
                gp_mod.state_from_tensors(layout, ins[:k]),
                ei_core._union(points_to_sample, rest[0] if rest else None),
                disc, nrm, with_bounds(inner, bounds), inner_params, best,
                num_fidelity=nf, num_to_sample=q)

        return ProgramForm(("knowledge_gradient_mcmc", layout,
                            domain_key(inner), inner_params, nf, q,
                            being is not None), inputs, objective)

    def objective_torch(self, points_to_sample):
        """Ensemble KG at the union points_to_sample (q, d) ++ the points
        being sampled, divided by the fidelity cost of the current point's
        num_to_sample points; differentiable (envelope gradient)."""
        form = self.program_form()
        return form.objective(points_to_sample, *form.inputs)

    def value_and_grad_torch(self, points_to_sample):
        return value_and_grad_by_autograd(self.objective_torch,
                                          points_to_sample)

    def compute_knowledge_gradient_mcmc(self):
        """The objective at the current point, eagerly: one evaluation,
        where a program's build alone is an eager evaluation and a capture
        (the rule of :func:`multistart_knowledge_gradient_mcmc_optimization`)."""
        return float(self.objective_torch(
            self._tensor(self._points_to_sample)))

    def compute_grad_knowledge_gradient_mcmc(self):
        return to_numpy(self.value_and_grad_torch(
            self._tensor(self._points_to_sample))[1])

    compute_objective_function = compute_knowledge_gradient_mcmc
    compute_grad_objective_function = compute_grad_knowledge_gradient_mcmc

    def evaluate_at_point_list(self, points_to_evaluate):
        """Ensemble-averaged KG at each candidate block
        (``evaluate_KG_mcmc_at_point_list`` counterpart): (n, dim)
        single-point candidates or (n, q, dim) blocks; returns (n,).  While
        ``programs.CAPTURE`` is "auto" each block is one replay of one
        program per block shape (the blocks are not batched: a batch could
        reorder the reductions)."""
        pts = self._tensor(points_to_evaluate)
        if pts.dim() == 2:
            pts = pts[:, None, :]
        form = self.program_form()
        return to_numpy(torch.stack([
            programs.run(self.program_cache, ("kg_score", "compat") +
                         form.key, form.objective, block, *form.inputs)
            for block in pts]))


def multistart_knowledge_gradient_mcmc_optimization(
        kg_optimizer, inner_optimizer=None, num_multistarts=None,
        discrete_pts_list=None, num_to_sample=None, num_pts=None,
        max_num_threads=None, status=None, generator=None):
    """Solve ensemble q-KG (cpp_wrappers/knowledge_gradient_mcmc.py
    multistart_knowledge_gradient_mcmc_optimization counterpart): the
    core's warm batched multistart, with the objective's points being
    sampled in every union; the starts and normals come from
    ``generator`` (seed 1 when None).

    The rule: this multistart runs eagerly.  It runs ungated, every start
    taking all its steps, so its warm steps are bound by the card's work
    (kernel A and the estimator), not by the host: the driver's step
    programs save nothing here and their builds cost more (``PERF.md``:
    2.42 s with them against 2.35 s eagerly on an H100 at 700 W)."""
    del inner_optimizer, discrete_pts_list, num_pts, max_num_threads
    obj = kg_optimizer.objective_function
    if num_to_sample is None:
        num_to_sample = obj.num_to_sample
    best = kg_core.multistart_knowledge_gradient_mcmc_optimization(
        as_generator(generator, obj.device, 1), obj._states,
        core_domain(kg_optimizer.domain), num_to_sample,
        multistart_parameters(kg_optimizer, num_multistarts),
        obj._inner_params, obj._discrete_pts,
        points_being_sampled=obj._being(),
        best_so_far=obj._best_so_far_list,
        num_mc_iterations=obj._num_mc_iterations,
        num_fidelity=obj._num_fidelity)
    if status is not None:
        status["gradient_descent_found_update"] = True
    return to_numpy(best)
