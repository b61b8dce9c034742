"""ExpectedImprovement class + optimization endpoints (compat layer).

Counterpart of ``cornell_moe_tpu/compat/expected_improvement.py`` (the
reference's ``cpp_wrappers/expected_improvement.py``): the
ExpectedImprovement evaluator (q,p-EI with current-point state),
``multistart_expected_improvement_optimization`` and
``heuristic_expected_improvement_optimization``.  Common random numbers:
the MC normals are drawn once, from the object's generator, when the
union's width is first set, and reused for every evaluation (the
reference's ResetToMostRecentSeed).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from cornell_moe_tpu_torch.acquisition import expected_improvement as ei_core
from cornell_moe_tpu_torch.compat._boundary import (
    ProgramForm, UnionPoints, rows, to_numpy, value_and_grad_by_autograd)
from cornell_moe_tpu_torch.compat.interfaces import (
    ExpectedImprovementInterface)
from cornell_moe_tpu_torch.compat.optimization import (
    core_domain, multistart_parameters)
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
from cornell_moe_tpu_torch.utils.constant import (
    DEFAULT_EXPECTED_IMPROVEMENT_MC_ITERATIONS)
from cornell_moe_tpu_torch.utils.rng import as_generator


class ExpectedImprovement(UnionPoints, ExpectedImprovementInterface):
    """q,p-EI evaluator (cpp_wrappers/expected_improvement.py class), on
    its GP's device; ``generator`` a ``torch.Generator`` or a seed (0 when
    None)."""

    def __init__(self, gaussian_process, points_to_sample=None,
                 points_being_sampled=None,
                 num_mc_iterations=DEFAULT_EXPECTED_IMPROVEMENT_MC_ITERATIONS,
                 generator=None):
        self._gaussian_process = gaussian_process
        self.program_cache = getattr(gaussian_process, "program_cache", None)
        self.device = gaussian_process.device
        self.dtype = gaussian_process.dtype
        self._num_mc_iterations = num_mc_iterations
        self._points_being_sampled = rows(points_being_sampled)
        self._best_so_far = float(
            gaussian_process._historical_data.best_value)
        self._generator = as_generator(generator, self.device)
        self._normals = None
        if points_to_sample is None:
            points_to_sample = np.zeros((1, gaussian_process.dim))
        self.set_current_point(points_to_sample)

    _draw_normals = staticmethod(ei_core.draw_normals)

    @property
    def dim(self):
        return self._gaussian_process.dim

    @property
    def _use_analytic(self):
        return self.num_to_sample == 1 and \
            self._points_being_sampled is None

    # -- evaluation --------------------------------------------------------
    def program_form(self, force_monte_carlo=False):
        """The closed form's inputs (the best value and the GP) for q = 1,
        p = 0 unless ``force_monte_carlo``; else the MC estimator's (the
        best value, the object's normals, the points being sampled when
        there are any, and the GP)."""
        tensors, layout = gp_mod.state_tensors(self._gaussian_process.state)
        best = torch.as_tensor(self._best_so_far, dtype=self.dtype,
                               device=self.device)
        if self._use_analytic and not force_monte_carlo:
            def objective(points_to_sample, b, *ts):
                return ei_core.analytic_expected_improvement(
                    gp_mod.state_from_tensors(layout, ts), points_to_sample,
                    b)

            return ProgramForm(("expected_improvement", layout),
                               (best, *tensors), objective)
        being = self._being()
        extra = () if being is None else (being,)

        def mc_objective(points_to_sample, b, normals, *rest):
            bs = rest[0] if extra else None
            return ei_core.monte_carlo_expected_improvement(
                gp_mod.state_from_tensors(layout, rest[len(extra):]),
                points_to_sample, bs, b, normals)

        return ProgramForm(("expected_improvement_mc", layout, bool(extra)),
                           (best, self._normals, *extra, *tensors),
                           mc_objective)

    def objective_torch(self, points_to_sample, force_monte_carlo=False):
        """EI at points (q, d), differentiable: the closed form for q = 1,
        p = 0, else the MC estimator on the object's normals."""
        form = self.program_form(force_monte_carlo)
        return form.objective(points_to_sample, *form.inputs)

    def value_and_grad_torch(self, points_to_sample):
        return value_and_grad_by_autograd(self.objective_torch,
                                          points_to_sample)

    def compute_expected_improvement(self, force_monte_carlo=False):
        return float(self.objective_torch(
            self._tensor(self._points_to_sample), force_monte_carlo))

    def compute_grad_expected_improvement(self, force_monte_carlo=False):
        fn = functools.partial(self.objective_torch,
                               force_monte_carlo=force_monte_carlo)
        return to_numpy(value_and_grad_by_autograd(
            fn, self._tensor(self._points_to_sample))[1])

    compute_objective_function = compute_expected_improvement
    compute_grad_objective_function = compute_grad_expected_improvement

    def evaluate_at_point_list(self, points_to_evaluate):
        """EI at each candidate (P, d) or block (P, q, d): (P,); MC blocks
        on fresh normals from the object's generator."""
        return to_numpy(ei_core.evaluate_expected_improvement_at_point_list(
            self._gaussian_process.state, self._tensor(points_to_evaluate),
            generator=self._generator, best_so_far=self._best_so_far,
            num_mc_iterations=self._num_mc_iterations))


def multistart_expected_improvement_optimization(
        ei_optimizer, num_multistarts: Optional[int] = None,
        num_to_sample: Optional[int] = None, randomness=None,
        max_num_threads=None, status=None, generator=None):
    """Solve q,p-EI (cpp_wrappers/expected_improvement.py
    multistart_expected_improvement_optimization counterpart).

    ``ei_optimizer`` pairs an ExpectedImprovement objective with a domain
    and GradientDescentParameters; the starts (and the MC normals) come
    from ``generator`` (seed 1 when None).  On a box domain its GD steps
    run as programs of the GP's cache.
    """
    del randomness, max_num_threads
    obj = ei_optimizer.objective_function
    if num_to_sample is None:
        num_to_sample = obj.num_to_sample
    domain = core_domain(ei_optimizer.domain)
    best = ei_core.multistart_expected_improvement_optimization(
        as_generator(generator, obj.device, 1), obj._gaussian_process.state,
        domain, num_to_sample,
        multistart_parameters(ei_optimizer, num_multistarts),
        points_being_sampled=obj._being(), best_so_far=obj._best_so_far,
        num_mc_iterations=obj._num_mc_iterations,
        program_cache=obj.program_cache
        if isinstance(domain, TensorProductDomain) else None)
    if status is not None:
        status["gradient_descent_found_update"] = True
    return to_numpy(best)


def heuristic_expected_improvement_optimization(
        ei_optimizer, num_to_sample: int, estimation_policy=None,
        randomness=None, max_num_threads=None, status=None,
        generator=None):
    """Sequential heuristic q-point selection (constant liar / kriging
    believer), the ``heuristic_expected_improvement_optimization`` binding's
    counterpart.  ``estimation_policy`` is one of the compat
    estimation-policy objects (ConstantLiarEstimationPolicy /
    KrigingBelieverEstimationPolicy) or a callable ``(state, point) ->
    (value, noise)``; ``generator`` seed 2 when None.
    """
    del randomness, max_num_threads
    obj = ei_optimizer.objective_function
    best = ei_core.heuristic_expected_improvement_optimization(
        as_generator(generator, obj.device, 2), obj._gaussian_process.state,
        core_domain(ei_optimizer.domain), num_to_sample,
        ei_optimizer.optimizer_parameters,
        estimation_policy=estimation_policy, best_so_far=obj._best_so_far,
        num_mc_iterations=obj._num_mc_iterations)
    if status is not None:
        status["heuristic_ei_found_update"] = True
    return to_numpy(best)
