"""KnowledgeGradient / PosteriorMean classes + endpoints (compat layer).

Counterpart of ``cornell_moe_tpu/compat/knowledge_gradient.py`` (the
reference's ``cpp_wrappers/knowledge_gradient.py``): PosteriorMean,
KnowledgeGradient, posterior_mean_optimization and
multistart_knowledge_gradient_optimization, on one GP, through the core's
single-GP surface (the per-union route, no kernel).  The objectives share
their GP's program cache (``ops.programs``; their program forms,
``compat._boundary.ProgramForm``).
"""

from __future__ import annotations

import numpy as np
import torch

from cornell_moe_tpu_torch.acquisition import expected_improvement as ei_core
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg_core
from cornell_moe_tpu_torch.compat._boundary import (
    ProgramForm, UnionPoints, domain_bounds, domain_key, rows, to_numpy,
    to_tensor, value_and_grad_by_autograd, with_bounds)
from cornell_moe_tpu_torch.compat.interfaces import OptimizableInterface
from cornell_moe_tpu_torch.compat.optimization import (
    core_domain, multistart_parameters)
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
from cornell_moe_tpu_torch.utils.rng import as_generator


def data_bounds_domain(points_sampled: np.ndarray, discrete_pts: np.ndarray,
                       dim_opt: int, device, dtype) -> TensorProductDomain:
    """The inner (posterior-mean) domain of the compat KG classes: the
    bounding box of the sampled points' first ``dim_opt`` coordinates and
    the discretization (n, dim_opt)."""
    lo = np.minimum(points_sampled.min(0)[:dim_opt], discrete_pts.min(0))
    hi = np.maximum(points_sampled.max(0)[:dim_opt], discrete_pts.max(0))
    return TensorProductDomain.from_bounds(np.stack([lo, hi], axis=1),
                                           device=device, dtype=dtype)


class PosteriorMean(OptimizableInterface):
    """-posterior_mean objective with fidelity pinning
    (cpp_wrappers/knowledge_gradient.py PosteriorMean)."""

    def __init__(self, gaussian_process, num_fidelity: int = 0,
                 point_to_sample=None):
        self._gaussian_process = gaussian_process
        self.program_cache = getattr(gaussian_process, "program_cache", None)
        self.device = gaussian_process.device
        self.dtype = gaussian_process.dtype
        self._num_fidelity = num_fidelity
        dim_opt = gaussian_process.dim - num_fidelity
        self._point = np.zeros(dim_opt) if point_to_sample is None else \
            np.asarray(point_to_sample, dtype=float).reshape(-1)[:dim_opt]

    @property
    def dim(self):
        return self._gaussian_process.dim

    @property
    def num_fidelity(self):
        return self._num_fidelity

    @property
    def problem_size(self):
        return self.dim - self._num_fidelity

    def get_current_point(self):
        return np.copy(self._point)

    def set_current_point(self, point):
        self._point = np.asarray(point, dtype=float).reshape(-1)[
            :self.problem_size]

    def program_form(self) -> ProgramForm:
        """The GP's mean fields as the inputs."""
        tensors, layout = gp_mod.state_tensors(self._gaussian_process.state,
                                               gp_mod.MEAN_FIELDS)
        nf = self._num_fidelity

        def objective(point, *ts):
            return kg_core.posterior_mean_objective(
                gp_mod.state_from_tensors(layout, ts), point, nf)

        return ProgramForm(("posterior_mean", layout, nf), tuple(tensors),
                           objective)

    def objective_torch(self, point):
        """-mu at the fidelity-pinned point (dim_opt,), differentiable."""
        form = self.program_form()
        return form.objective(point, *form.inputs)

    def value_and_grad_torch(self, point):
        return value_and_grad_by_autograd(self.objective_torch, point)

    def _current(self):
        return to_tensor(self._point, self.device, self.dtype)

    def compute_posterior_mean(self):
        """Returns -mu (the maximized objective), as in the reference."""
        return float(self.objective_torch(self._current()))

    def compute_grad_posterior_mean(self):
        return to_numpy(self.value_and_grad_torch(self._current())[1])

    compute_objective_function = compute_posterior_mean
    compute_grad_objective_function = compute_grad_posterior_mean


class KnowledgeGradient(UnionPoints, OptimizableInterface):
    """q-KG evaluator (cpp_wrappers/knowledge_gradient.py
    KnowledgeGradient) on one GP.  The antithetic MC normals are drawn from
    ``generator`` (a ``torch.Generator`` or a seed, 0 when None) when the
    union's width is first set; ``best_so_far`` defaults to the least
    posterior mean over the discretization."""

    def __init__(self, gaussian_process, inner_optimizer, discrete_pts,
                 num_fidelity: int = 0, points_to_sample=None,
                 points_being_sampled=None, num_mc_iterations: int = 2**7,
                 best_so_far=None, generator=None):
        self._gaussian_process = gaussian_process
        self.program_cache = getattr(gaussian_process, "program_cache", None)
        self.device = gaussian_process.device
        self.dtype = gaussian_process.dtype
        self._num_fidelity = num_fidelity
        self._inner_params = getattr(inner_optimizer,
                                     "optimizer_parameters",
                                     inner_optimizer)
        self._discrete_pts = rows(discrete_pts)
        self._points_being_sampled = rows(points_being_sampled)
        self._num_mc_iterations = num_mc_iterations
        if best_so_far is None:
            mus = gaussian_process.compute_mean_of_points(
                np.hstack([self._discrete_pts,
                           np.ones((self._discrete_pts.shape[0],
                                    num_fidelity))]))
            best_so_far = float(np.min(mus))
        self._best_so_far = best_so_far
        self._generator = as_generator(generator, self.device)
        self._normals = None
        if points_to_sample is None:
            points_to_sample = np.zeros((1, gaussian_process.dim))
        self.set_current_point(points_to_sample)
        self._inner_domain = data_bounds_domain(
            gaussian_process._historical_data.points_sampled,
            self._discrete_pts, gaussian_process.dim - num_fidelity,
            self.device, self.dtype)

    _draw_normals = staticmethod(ei_core.draw_antithetic_normals)

    @property
    def dim(self):
        return self._gaussian_process.dim

    def set_inner_domain(self, domain):
        """Override the inner posterior-mean optimization domain."""
        self._inner_domain = core_domain(domain)

    def _as_ensemble(self):
        """The KG arguments for the core's ensemble functions: the GP as an
        ensemble of one, the discretization and best-so-far with its axis
        of 1."""
        return (self._gaussian_process.state.as_ensemble(),
                self._tensor(self._discrete_pts)[None],
                self._tensor([self._best_so_far]))

    def program_form(self) -> ProgramForm:
        """The GP, the discretization, the normals, the best value, the
        inner domain's bounds and the points being sampled as the inputs;
        the value is the per-union estimator's."""
        tensors, layout = gp_mod.state_tensors(self._gaussian_process.state)
        being = self._being()
        inputs = (*tensors, self._tensor(self._discrete_pts), self._normals,
                  self._tensor([self._best_so_far]),
                  domain_bounds(self._inner_domain)) + \
            (() if being is None else (torch.atleast_2d(being),))
        k, inner, nf = len(tensors), self._inner_domain, self._num_fidelity
        inner_params = self._inner_params

        def objective(points_to_sample, *ins):
            disc, nrm, best, bounds, *rest = ins[k:]
            return kg_core.knowledge_gradient(
                gp_mod.state_from_tensors(layout, ins[:k]).as_ensemble(),
                ei_core._union(torch.atleast_2d(points_to_sample),
                               rest[0] if rest else None),
                disc[None], nrm, with_bounds(inner, bounds), inner_params,
                best, num_fidelity=nf)[0]

        return ProgramForm(("knowledge_gradient", layout, domain_key(inner),
                            inner_params, nf, being is not None), inputs,
                           objective)

    def value_and_grad_torch(self, points_to_sample):
        """(KG, dKG/dpoints_to_sample) at points (q, d): the envelope
        gradient of the per-union estimator, by autograd."""
        form = self.program_form()
        return value_and_grad_by_autograd(
            lambda x: form.objective(x, *form.inputs), points_to_sample)

    def compute_knowledge_gradient(self):
        state, discrete, best = self._as_ensemble()
        union = ei_core._union(self._tensor(self._points_to_sample),
                               self._being())
        return float(kg_core.knowledge_gradient(
            state, union, discrete, self._normals, self._inner_domain,
            self._inner_params, best, num_fidelity=self._num_fidelity)[0])

    def compute_grad_knowledge_gradient(self):
        return to_numpy(self.value_and_grad_torch(
            self._tensor(self._points_to_sample))[1])

    compute_objective_function = compute_knowledge_gradient
    compute_grad_objective_function = compute_grad_knowledge_gradient

    def evaluate_at_point_list(self, points_to_evaluate):
        """KG at each candidate (P, d) or block (P, q, d): (P,)."""
        state, discrete, best = self._as_ensemble()
        return to_numpy(kg_core.evaluate_knowledge_gradient_at_point_list(
            state, self._tensor(points_to_evaluate), discrete,
            self._normals, self._inner_domain, self._inner_params, best,
            num_fidelity=self._num_fidelity)[:, 0])


def posterior_mean_optimization(ps_optimizer, initial_guess=None,
                                max_num_threads=None, status=None):
    """Find argmin of the posterior mean
    (cpp_wrappers/knowledge_gradient.py posterior_mean_optimization
    counterpart): a GD polish from the best of the guesses, its steps
    programs of the GP's cache on a box domain."""
    del max_num_threads
    obj = ps_optimizer.objective_function
    if initial_guess is None:
        initial_guess = obj.get_current_point()
    guesses = torch.atleast_2d(to_tensor(initial_guess, obj.device,
                                         obj.dtype))
    domain = core_domain(ps_optimizer.domain)
    pt, _ = kg_core.compute_optimal_posterior_mean(
        obj._gaussian_process.state, domain, guesses,
        ps_optimizer.optimizer_parameters, obj.num_fidelity,
        program_cache=obj.program_cache
        if isinstance(domain, TensorProductDomain) else None)
    if status is not None:
        status["gradient_descent_found_update"] = True
    pt = to_numpy(pt)
    obj.set_current_point(pt)
    return pt


def multistart_knowledge_gradient_optimization(
        kg_optimizer, inner_optimizer=None, num_multistarts=None,
        deriv=None, num_pts=None, num_to_sample=None,
        max_num_threads=None, status=None, generator=None):
    """Solve q-KG (cpp_wrappers/knowledge_gradient.py
    multistart_knowledge_gradient_optimization counterpart); the starts
    and normals come from ``generator`` (seed 1 when None)."""
    del inner_optimizer, deriv, num_pts, max_num_threads
    obj = kg_optimizer.objective_function
    if num_to_sample is None:
        num_to_sample = obj.num_to_sample
    best = kg_core.multistart_knowledge_gradient_optimization(
        as_generator(generator, obj.device, 1), obj._gaussian_process.state,
        core_domain(kg_optimizer.domain), num_to_sample,
        multistart_parameters(kg_optimizer, num_multistarts),
        obj._inner_params, obj._tensor(obj._discrete_pts),
        points_being_sampled=obj._being(), best_so_far=obj._best_so_far,
        num_mc_iterations=obj._num_mc_iterations,
        num_fidelity=obj._num_fidelity)
    if status is not None:
        status["gradient_descent_found_update"] = True
    return to_numpy(best)
