"""Optimizer parameter/config classes for the compatibility layer.

Counterpart of ``cornell_moe_tpu/compat/optimization.py`` (the reference's
``cpp_wrappers/optimization.py`` and ``python_version/optimization.py``):
the parameter structs (GradientDescentParameters / NewtonParameters /
LBFGSBParameters / COBYLAParameters / NullParameters), the optimizer
config holders (NullOptimizer / GradientDescentOptimizer /
NewtonOptimizer / LBFGSBOptimizer / COBYLAOptimizer), and
``multistart_optimize``.

The core parameter dataclasses are re-exported from
``cornell_moe_tpu_torch.ops.optimizers`` (the reference's field names).
The optimizer classes pair an OptimizableInterface objective with a
domain and parameters.  ``optimize()`` runs the port's optimizers on the
objective's torch hook (``value_and_grad_torch``; Newton:
``objective_torch``) where it has one, else on its numpy methods; the
scipy optimizers take float64 numpy, converted at their boundary.  Where
:func:`runs_programs` holds, gradient descent takes each step through one
program of the objective's cache and Newton runs each start as one
program (``ops.programs``), the counterparts of the JAX package's scanned
optimizers.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple
from typing import Optional

import numpy as np
import torch

from cornell_moe_tpu_torch.compat._boundary import (
    domain_bounds, domain_key, to_numpy, value_and_grad_by_autograd,
    with_bounds)
from cornell_moe_tpu_torch.compat.interfaces import OptimizerInterface
from cornell_moe_tpu_torch.ops import optimizers as opt_mod
from cornell_moe_tpu_torch.ops import programs
from cornell_moe_tpu_torch.ops.optimizers import (  # noqa: F401 (re-exported)
    GradientDescentParameters, NewtonParameters)

__all__ = [
    "GradientDescentParameters", "NewtonParameters", "NullParameters",
    "LBFGSBParameters", "COBYLAParameters", "NullOptimizer",
    "GradientDescentOptimizer", "NewtonOptimizer", "LBFGSBOptimizer",
    "COBYLAOptimizer", "multistart_optimize",
]

NullParameters = namedtuple("NullParameters", [])

LBFGSBParameters = namedtuple(
    "LBFGSBParameters",
    ["approx_grad", "max_func_evals", "max_metric_correc", "factr",
     "pgtol", "epsilon"])

COBYLAParameters = namedtuple(
    "COBYLAParameters", ["rhobeg", "rhoend", "maxfun", "catol"])


def core_domain(domain):
    """The port's functional domain of a compat domain (a core domain
    passes through)."""
    return getattr(domain, "core", domain)


def multistart_parameters(optimizer, num_multistarts: Optional[int] = None):
    """The optimizer's parameters, ``num_multistarts`` replaced when
    given."""
    params = optimizer.optimizer_parameters
    if num_multistarts is not None:
        params = dataclasses.replace(params, num_multistarts=num_multistarts)
    return params


def runs_programs(objective) -> bool:
    """The rule for an objective's optimizer steps: programs while
    ``programs.CAPTURE`` is "auto" and the objective has a
    ``program_cache`` and a program form (``program_form()`` not None).
    An objective with only numpy methods reads the host at every step and
    runs eagerly, as the JAX package calls back into the host there
    (``pure_callback``)."""
    if not programs.enabled() or \
            getattr(objective, "program_cache", None) is None or \
            not hasattr(objective, "program_form"):
        return False
    return objective.program_form() is not None


class _OptimizerBase(OptimizerInterface):

    def __init__(self, domain, optimizable, optimizer_parameters,
                 num_random_samples=None):
        self.domain = domain
        self.objective_function = optimizable
        self.optimizer_parameters = optimizer_parameters
        self.num_random_samples = num_random_samples

    def _start(self):
        """(the domain's core, the objective's current point as a tensor on
        the domain's device and dtype)."""
        core = core_domain(self.domain)
        b = domain_bounds(core)
        x0 = torch.as_tensor(np.asarray(
            self.objective_function.get_current_point(), dtype=float),
            device=b.device, dtype=b.dtype)
        return core, x0

    def _finish(self, x: torch.Tensor) -> np.ndarray:
        x = to_numpy(x)
        self.objective_function.set_current_point(x)
        return x

    def _value_and_grad(self):
        """The objective's torch hook, or its numpy methods behind a
        tensor boundary."""
        obj = self.objective_function
        if hasattr(obj, "value_and_grad_torch"):
            return obj.value_and_grad_torch

        def vg(x):
            obj.set_current_point(to_numpy(x))
            kw = dict(dtype=x.dtype, device=x.device)
            return (torch.as_tensor(obj.compute_objective_function(), **kw),
                    torch.as_tensor(np.asarray(
                        obj.compute_grad_objective_function()),
                        **kw).reshape(x.shape))
        return vg


class NullOptimizer(_OptimizerBase):
    """A no-op optimizer (cpp_wrappers/optimization.py NullOptimizer)."""

    def optimize(self, **kwargs):
        return self.objective_function.get_current_point()


class GradientDescentOptimizer(_OptimizerBase):
    """Restarted gradient ascent on the objective
    (python_version/optimization.py GradientDescentOptimizer).

    optimize() polishes the objective's current point; use
    :func:`multistart_optimize` for the multistart wrapper.  Where
    :func:`runs_programs` holds, each step is one program of the
    objective's cache over (x, the objective's tensors, the domain's
    bounds), keyed by the objective's kind and shapes, its step size an
    input.
    """

    def optimize(self, **kwargs):
        core, x0 = self._start()
        return self._finish(opt_mod.gradient_ascent(
            self._value_and_grad(), core, x0, self.optimizer_parameters,
            step_fn=self._step_program(core)))

    def _step_program(self, core):
        obj = self.objective_function
        if not runs_programs(obj):
            return None
        form = obj.program_form()
        mrc = self.optimizer_parameters.max_relative_change

        def step(x, rate, bounds, *inputs):
            _, g = value_and_grad_by_autograd(
                lambda xx: form.objective(xx, *inputs), x)
            return opt_mod.ascent_step(with_bounds(core, bounds), mrc, x, g,
                                       rate)

        return obj.program_cache.stepper(
            ("compat_step", form.key, domain_key(core), mrc) +
            programs.signature(form.inputs), step, domain_bounds(core),
            *form.inputs)


def _newton(value_fn, domain, x0, params):
    """``opt_mod.newton_optimize`` of a scalar ``value_fn``: its value and
    gradient and its Hessian by ``torch.func``."""
    return opt_mod.newton_optimize(opt_mod.value_and_grad(value_fn), domain,
                                   x0, params,
                                   hessian_fn=torch.func.hessian(value_fn))


class NewtonOptimizer(_OptimizerBase):
    """Damped-Newton polish (gpp_optimization.hpp Newton counterpart) of an
    objective with a differentiable ``objective_torch``; its Hessian is
    ``torch.func``'s.  Where :func:`runs_programs` holds, the whole run
    from the start is one program of the objective's cache, as the MAP
    fit's Newton run is."""

    def optimize(self, **kwargs):
        obj = self.objective_function
        if not hasattr(obj, "objective_torch"):
            raise TypeError(
                f"NewtonOptimizer needs an objective with objective_torch; "
                f"{type(obj).__name__} has none")
        core, x0 = self._start()
        params = self.optimizer_parameters
        if not runs_programs(obj):
            return self._finish(_newton(obj.objective_torch, core, x0,
                                        params))
        form = obj.program_form()

        def newton(start, bounds, *inputs):
            return _newton(lambda t: form.objective(t, *inputs),
                           with_bounds(core, bounds), start, params)

        return self._finish(programs.run(
            obj.program_cache, ("compat_newton", form.key, domain_key(core),
                                params), newton, x0, domain_bounds(core),
            *form.inputs))


class _ScipyOptimizer(_OptimizerBase):

    _method = None

    def optimize(self, **kwargs):
        import scipy.optimize

        obj = self.objective_function
        shape = np.asarray(obj.get_current_point()).shape
        x0 = np.asarray(obj.get_current_point(), dtype=np.float64).ravel()
        bounds = None
        if hasattr(self.domain, "_domain_bounds"):
            bounds = list(self.domain._domain_bounds) * \
                (x0.size // len(self.domain._domain_bounds))

        def neg_obj(x):
            obj.set_current_point(x.reshape(shape))
            return -float(obj.compute_objective_function())

        res = scipy.optimize.minimize(neg_obj, x0, method=self._method,
                                      bounds=bounds)
        obj.set_current_point(res.x.reshape(shape))
        return res.x


class LBFGSBOptimizer(_ScipyOptimizer):
    """python_version/optimization.py LBFGSBOptimizer counterpart."""

    _method = "L-BFGS-B"


class COBYLAOptimizer(_ScipyOptimizer):
    """python_version/optimization.py COBYLAOptimizer counterpart."""

    _method = "COBYLA"


def multistart_optimize(optimizer, starting_points=None,
                        num_multistarts: Optional[int] = None):
    """Run optimizer.optimize() from each start and return the optimized
    points, best objective first (python_version/optimization.py
    multistart_optimize counterpart).  Without ``starting_points``, the
    starts are Latin-hypercube points of the optimizer's domain."""
    obj = optimizer.objective_function
    if starting_points is None:
        if num_multistarts is None:
            num_multistarts = getattr(optimizer.optimizer_parameters,
                                      "num_multistarts", 1)
        starting_points = \
            optimizer.domain.generate_latin_hypercube_points(
                num_multistarts)
    results = []
    for x0 in np.atleast_2d(np.asarray(starting_points, dtype=float)):
        obj.set_current_point(x0)
        x = optimizer.optimize()
        results.append((float(obj.compute_objective_function()),
                        np.asarray(x)))
    results.sort(key=lambda t: -t[0])
    return np.asarray([x for _, x in results])
