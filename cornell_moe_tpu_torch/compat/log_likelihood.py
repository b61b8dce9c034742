"""Log-likelihood model-selection classes (compat layer).

Counterpart of ``cornell_moe_tpu/compat/log_likelihood.py`` (the
reference's ``cpp_wrappers/log_likelihood.py``):
GaussianProcessLogLikelihood, GaussianProcessLogMarginalLikelihood,
GaussianProcessLeaveOneOutLogLikelihood,
multistart_hyperparameter_optimization,
restarted_hyperparameter_optimization and
evaluate_log_likelihood_at_hyperparameter_list.

The measures are computed on the covariance's device in its dtype; each
objective owns a program cache (``ops.programs``) for the compat
optimizers' steps.
Hyperparameter optimization runs over LOG-hyperparameters (as the
reference's C++ does internally) with the port's multistart machinery.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from cornell_moe_tpu_torch.compat._boundary import (
    ProgramForm, to_numpy, to_tensor, value_and_grad_by_autograd)
from cornell_moe_tpu_torch.compat.interfaces import (
    GaussianProcessLogLikelihoodInterface)
from cornell_moe_tpu_torch.compat.optimization import (
    _newton, core_domain, multistart_parameters)
from cornell_moe_tpu_torch.models import likelihood as lik_mod
from cornell_moe_tpu_torch.ops import optimizers as opt_mod
from cornell_moe_tpu_torch.ops import programs
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
from cornell_moe_tpu_torch.utils.rng import as_generator


class GaussianProcessLogLikelihood(GaussianProcessLogLikelihoodInterface):
    """Measures covariance-hyperparameter fit quality over the data."""

    objective_type = "log_marginal_likelihood"
    _measure = staticmethod(lik_mod.log_marginal_likelihood)

    def __init__(self, covariance_function, historical_data,
                 noise_variance=None, derivatives=()):
        self._covariance = covariance_function
        self.device = covariance_function.device
        self.dtype = covariance_function.dtype
        self._historical_data = historical_data
        self._derivatives = tuple(int(i) for i in derivatives)
        if noise_variance is None:
            noise_variance = np.full((1 + len(self._derivatives),), 1e-8)
        self._noise_variance = np.asarray(noise_variance, dtype=float)
        self.program_cache = programs.ProgramCache()

    # -- hyperparameter access -------------------------------------------
    @property
    def dim(self):
        return self._historical_data.dim

    @property
    def num_hyperparameters(self):
        return self._covariance.num_hyperparameters

    @property
    def problem_size(self):
        return self.num_hyperparameters

    def get_hyperparameters(self):
        return self._covariance.get_hyperparameters()

    def set_hyperparameters(self, hyperparameters):
        self._covariance.set_hyperparameters(hyperparameters)

    hyperparameters = property(
        lambda s: s.get_hyperparameters(),
        lambda s, h: s.set_hyperparameters(h))
    current_point = hyperparameters
    get_current_point = get_hyperparameters
    set_current_point = set_hyperparameters

    def get_covariance_copy(self):
        return copy.deepcopy(self._covariance)

    def get_historical_data_copy(self):
        return copy.deepcopy(self._historical_data)

    # -- evaluation --------------------------------------------------------
    def _tensor(self, array) -> torch.Tensor:
        return to_tensor(array, self.device, self.dtype)

    def program_form(self) -> ProgramForm:
        """The noise variance and the data as the inputs."""
        data = self._historical_data
        measure, to_kernel = self._measure, self._covariance.to_kernel
        ds = self._derivatives

        def objective(hyperparameters, noise, points, values):
            return measure(to_kernel(hyperparameters), noise, points, values,
                           ds)

        return ProgramForm(
            (self.objective_type, type(self._covariance).__name__, ds),
            (self._tensor(self._noise_variance),
             self._tensor(data.points_sampled),
             self._tensor(data.points_sampled_value)), objective)

    def objective_torch(self, hyperparameters: torch.Tensor) -> torch.Tensor:
        """The measure at hyperparameters (..., 1 + dim), differentiable
        (``torch.func`` transforms included); batch axes give a batch of
        values."""
        form = self.program_form()
        return form.objective(hyperparameters, *form.inputs)

    def value_and_grad_torch(self, hyperparameters: torch.Tensor):
        return value_and_grad_by_autograd(self.objective_torch,
                                          hyperparameters)

    def _current(self) -> torch.Tensor:
        return self._tensor(self._covariance.get_hyperparameters())

    def compute_log_likelihood(self):
        return float(self.objective_torch(self._current()))

    def compute_grad_log_likelihood(self):
        return to_numpy(self.value_and_grad_torch(self._current())[1])

    compute_objective_function = compute_log_likelihood
    compute_grad_objective_function = compute_grad_log_likelihood


class GaussianProcessLogMarginalLikelihood(GaussianProcessLogLikelihood):
    """LML measure (cpp_wrappers/log_likelihood.py
    GaussianProcessLogMarginalLikelihood)."""

    objective_type = "log_marginal_likelihood"
    _measure = staticmethod(lik_mod.log_marginal_likelihood)


class GaussianProcessLeaveOneOutLogLikelihood(GaussianProcessLogLikelihood):
    """LOO-CV pseudo-likelihood measure (cpp_wrappers/log_likelihood.py
    GaussianProcessLeaveOneOutLogLikelihood)."""

    objective_type = "leave_one_out_log_likelihood"
    _measure = staticmethod(lik_mod.leave_one_out_log_likelihood)


def _log_domain(log_likelihood_optimizer, obj):
    """The optimizer's domain (over log-hyperparameters), or the broad
    [-10, 10] log-box of the reference's main program."""
    if log_likelihood_optimizer.domain is not None:
        return core_domain(log_likelihood_optimizer.domain)
    return TensorProductDomain.from_bounds(
        [[-10.0, 10.0]] * obj.num_hyperparameters, device=obj.device,
        dtype=obj.dtype)


def _log_objective(obj):
    def value(log_h):
        return obj.objective_torch(torch.exp(log_h))
    return value


def multistart_hyperparameter_optimization(
        log_likelihood_optimizer, num_multistarts: Optional[int] = None,
        randomness=None, max_num_threads=None, status=None, generator=None):
    """Point-estimate hyperparameter fit
    (cpp_wrappers/log_likelihood.py multistart_hyperparameter_optimization
    counterpart).

    Multistart gradient ascent over LOG-hyperparameters from
    Latin-hypercube starts drawn from ``generator`` (seed 0 when None), in
    the optimizer's domain or a [-10, 10] log-box.  Returns the best
    hyperparameters in linear space and sets them on the objective.
    """
    del randomness, max_num_threads
    obj = log_likelihood_optimizer.objective_function
    params = multistart_parameters(log_likelihood_optimizer,
                                   num_multistarts)
    domain = _log_domain(log_likelihood_optimizer, obj)
    value = _log_objective(obj)
    starts = domain.generate_latin_hypercube_points(
        as_generator(generator, obj.device), params.num_multistarts)
    res = opt_mod.multistart_optimize(
        lambda lh: value_and_grad_by_autograd(value, lh), domain, starts,
        params)
    best = np.exp(to_numpy(res.best_point))
    if status is not None:
        status["log_likelihood_found_update"] = True
    obj.set_hyperparameters(best)
    return best


def restarted_hyperparameter_optimization(
        log_likelihood_optimizer, **kwargs):
    """Newton-polished variant: multistart gradient ascent, then a damped
    Newton polish in log space (30 steps, time factor 1, gamma 1.1), kept
    where it improves the measure."""
    best = multistart_hyperparameter_optimization(
        log_likelihood_optimizer, **kwargs)
    obj = log_likelihood_optimizer.objective_function
    domain = _log_domain(log_likelihood_optimizer, obj)
    newton = opt_mod.NewtonParameters(max_num_steps=30, time_factor=1.0,
                                      gamma=1.1)
    best_t = to_tensor(best, obj.device, obj.dtype)
    x = _newton(_log_objective(obj), domain, torch.log(best_t), newton)
    polished = torch.exp(x)
    final = polished if float(obj.objective_torch(polished)) > \
        float(obj.objective_torch(best_t)) else best_t
    final = to_numpy(final)
    obj.set_hyperparameters(final)
    return final


def evaluate_log_likelihood_at_hyperparameter_list(
        log_likelihood_evaluator, hyperparameters_to_evaluate,
        max_num_threads=None, status=None):
    """The measure at each row of ``hyperparameters_to_evaluate`` (K,
    1 + dim), as one batched evaluation (cpp_wrappers/log_likelihood.py
    evaluate_log_likelihood_at_hyperparameter_list counterpart): (K,)."""
    del max_num_threads
    obj = log_likelihood_evaluator
    vals = obj.objective_torch(obj._tensor(hyperparameters_to_evaluate))
    if status is not None:
        status["evaluated_log_likelihood_at_hyperparameter_list"] = True
    return to_numpy(vals)
