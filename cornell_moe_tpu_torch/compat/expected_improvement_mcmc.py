"""MCMC-averaged EI class (compat layer).

Counterpart of ``cornell_moe_tpu/compat/expected_improvement_mcmc.py``
(the reference's ``cpp_wrappers/expected_improvement_mcmc.py``):
ExpectedImprovementMCMC and
multistart_expected_improvement_mcmc_optimization, on the ensemble's
device, with the ensemble's program cache (``ops.programs``).
"""

from __future__ import annotations

import numpy as np
import torch

from cornell_moe_tpu_torch.acquisition import expected_improvement as ei_core
from cornell_moe_tpu_torch.compat._boundary import (
    ProgramForm, UnionPoints, ensemble_cache, rows, to_numpy,
    value_and_grad_by_autograd)
from cornell_moe_tpu_torch.compat.interfaces import OptimizableInterface
from cornell_moe_tpu_torch.compat.optimization import (
    core_domain, multistart_parameters)
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.ops import programs
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
from cornell_moe_tpu_torch.utils.rng import as_generator


class ExpectedImprovementMCMC(UnionPoints, OptimizableInterface):
    """Mean EI over a hyperparameter ensemble; the MC normals are drawn
    from ``generator`` (a ``torch.Generator`` or a seed, 0 when None) when
    the union's width is first set.  Its program form takes the ensemble,
    the best values, the normals and the points being sampled as inputs,
    so its optimizer steps and point lists run as programs of the
    ensemble's cache (``compat.optimization.runs_programs``)."""

    def __init__(self, gaussian_process_mcmc, num_to_sample: int = 1,
                 points_to_sample=None, points_being_sampled=None,
                 num_mc_iterations: int = 10000, generator=None):
        self._gp_mcmc = gaussian_process_mcmc
        self._states = gaussian_process_mcmc.states
        self.program_cache = ensemble_cache(gaussian_process_mcmc)
        self.device = gaussian_process_mcmc.device
        self.dtype = gaussian_process_mcmc.dtype
        self._num_mc_iterations = num_mc_iterations
        self._points_being_sampled = rows(points_being_sampled)
        self._best_so_far = self._states.best_observed_value
        self._generator = as_generator(generator, self.device)
        self._normals = None
        if points_to_sample is None:
            points_to_sample = np.zeros((num_to_sample,
                                         self._gp_mcmc.dim))
        self.set_current_point(points_to_sample)

    _draw_normals = staticmethod(ei_core.draw_normals)

    @property
    def dim(self):
        return self._gp_mcmc.dim

    def program_form(self) -> ProgramForm:
        """The best values, the MC normals, the points being sampled (when
        there are any) and the ensemble as the inputs."""
        tensors, layout = gp_mod.state_tensors(self._states)
        being = self._being()
        extra = () if being is None else (being,)

        def objective(points_to_sample, best, normals, *rest):
            bs = rest[0] if extra else None
            return ei_core.monte_carlo_expected_improvement_mcmc(
                gp_mod.state_from_tensors(layout, rest[len(extra):]),
                points_to_sample, bs, best, normals)

        best = torch.as_tensor(self._best_so_far, dtype=self.dtype,
                               device=self.device)
        return ProgramForm(("expected_improvement_mcmc", layout,
                            bool(extra)),
                           (best, self._normals, *extra, *tensors),
                           objective)

    def objective_torch(self, points_to_sample):
        """Ensemble-mean q,p-EI at points (q, d), differentiable."""
        form = self.program_form()
        return form.objective(points_to_sample, *form.inputs)

    def value_and_grad_torch(self, points_to_sample):
        return value_and_grad_by_autograd(self.objective_torch,
                                          points_to_sample)

    def compute_expected_improvement_mcmc(self):
        return float(self.objective_torch(
            self._tensor(self._points_to_sample)))

    def compute_grad_expected_improvement_mcmc(self):
        return to_numpy(self.value_and_grad_torch(
            self._tensor(self._points_to_sample))[1])

    compute_objective_function = compute_expected_improvement_mcmc
    compute_grad_objective_function = compute_grad_expected_improvement_mcmc

    def evaluate_at_point_list(self, points_to_evaluate):
        """Ensemble-averaged EI at each candidate block
        (``evaluate_EI_mcmc_at_point_list`` counterpart): (n, dim)
        single-point candidates or (n, q, dim) blocks; returns (n,).  While
        ``programs.CAPTURE`` is "auto" each block replays one program per
        block shape, the objective's (the blocks are not batched: a batch
        could reorder the reductions)."""
        pts = self._tensor(points_to_evaluate)
        if pts.dim() == 2:
            pts = pts[:, None, :]
        form = self.program_form()
        return to_numpy(torch.stack([
            programs.run(self.program_cache, ("ei_mcmc_point",) + form.key,
                         form.objective, block, *form.inputs)
            for block in pts]))


def multistart_expected_improvement_mcmc_optimization(
        ei_optimizer, num_multistarts=None, num_to_sample=None,
        max_num_threads=None, status=None, generator=None):
    """Solve ensemble q-EI (cpp_wrappers/expected_improvement_mcmc.py
    multistart_expected_improvement_mcmc_optimization counterpart); the
    starts and normals come from ``generator`` (seed 1 when None).  On a
    box domain its GD steps run as programs of the objective's cache."""
    del max_num_threads
    obj = ei_optimizer.objective_function
    if num_to_sample is None:
        num_to_sample = obj.num_to_sample
    domain = core_domain(ei_optimizer.domain)
    best = ei_core.multistart_expected_improvement_mcmc_optimization(
        as_generator(generator, obj.device, 1), obj._states, domain,
        num_to_sample,
        multistart_parameters(ei_optimizer, num_multistarts),
        points_being_sampled=obj._being(), best_so_far=obj._best_so_far,
        num_mc_iterations=obj._num_mc_iterations,
        program_cache=obj.program_cache
        if isinstance(domain, TensorProductDomain) else None)
    if status is not None:
        status["gradient_descent_found_update"] = True
    return to_numpy(best)
