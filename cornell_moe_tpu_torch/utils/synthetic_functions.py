"""Synthetic objectives, in numpy.

Counterpart of ``cornell_moe_tpu/utils/synthetic_functions.py`` for the
objectives the port's paths use.  Each objective carries ``_dim``,
``_search_domain``, ``_num_init_pts``, ``_sample_var``, ``_min_value``,
``_observations`` and ``_num_fidelity``; ``evaluate(_true)`` returns
``[value, dvalue/dx_0, ..., dvalue/dx_{d-1}]`` with the gradient written
out by hand (objective evaluation is host-side work).
"""

from __future__ import annotations

import math

import numpy as np


class SyntheticFunction:
    """Base: subclasses define ``_value_and_grad(x) -> (value, grad)``."""

    _sample_var = 0.0
    _observations: tuple = ()
    _num_fidelity = 0
    _num_init_pts = 3

    def __init__(self):
        self._rng = np.random.default_rng(0)

    def evaluate_true(self, x):
        v, g = self._value_and_grad(np.asarray(x, dtype=float))
        return np.concatenate([[float(v)], np.asarray(g, dtype=float)])

    def evaluate(self, x):
        out = self.evaluate_true(x)
        if self._sample_var > 0:
            out = out + self._rng.normal(
                0.0, math.sqrt(self._sample_var), size=out.shape)
        return out

    @property
    def derivative_observations(self):
        return tuple(self._observations)


class Branin(SyntheticFunction):
    """Min 0.397887 at (pi, 2.275) and (9.42478, 2.475)."""

    def __init__(self):
        self._dim = 2
        self._search_domain = np.array([[0.0, 15.0], [-5.0, 15.0]])
        self._min_value = 0.397887
        super().__init__()

    def _value_and_grad(self, x):
        a, b = 1.0, 5.1 / (4 * math.pi**2)
        c, r = 5.0 / math.pi, 6.0
        s, t = 10.0, 1.0 / (8 * math.pi)
        inner = x[1] - b * x[0]**2 + c * x[0] - r
        value = a * inner**2 + s * (1 - t) * math.cos(x[0]) + s
        grad = np.array([
            2.0 * a * inner * (c - 2.0 * b * x[0])
            - s * (1 - t) * math.sin(x[0]),
            2.0 * a * inner])
        return value, grad


class BraninWithDerivatives(Branin):
    """Branin with both partials observed (the d-KG / d-EI setting)."""

    _observations = (0, 1)


class BraninFidelity(Branin):
    """Branin with one continuous-fidelity dimension (the last coordinate
    s in [0.05, 1]): a fidelity s < 1 adds the smooth bias
    10 (1 - s) cos^2(x_0 / 2), s = 1 recovers Branin.  An evaluation costs
    s (the cf-KG setting)."""

    _num_fidelity = 1

    def __init__(self):
        super().__init__()
        self._dim = 3
        self._search_domain = np.array([[0.0, 15.0], [-5.0, 15.0],
                                        [0.05, 1.0]])

    def _value_and_grad(self, x):
        value, grad = super()._value_and_grad(x[:2])
        c = math.cos(0.5 * x[0])
        value = value + 10.0 * (1.0 - x[2]) * c**2
        grad = np.array([grad[0] - 5.0 * (1.0 - x[2]) * math.sin(x[0]),
                         grad[1], -10.0 * c**2])
        return value, grad


_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H6_A = np.array([[10, 3, 17, 3.50, 1.7, 8], [0.05, 10, 17, 0.1, 8, 14],
                  [3, 3.5, 1.7, 10, 17, 8], [17, 8, 0.05, 10, 0.1, 14]])
_H6_P = 1e-4 * np.array(
    [[1312, 1696, 5569, 124, 8283, 5886],
     [2329, 4135, 8307, 3736, 1004, 9991],
     [2348, 1451, 3522, 2883, 3047, 6650],
     [4047, 8828, 8732, 5743, 1091, 381]])


class Hartmann6(SyntheticFunction):
    """Min -3.32237 at (0.20169, 0.150011, 0.476874, 0.275332, 0.311652,
    0.6573)."""

    def __init__(self):
        self._dim = 6
        self._search_domain = np.repeat([[0.0, 1.0]], 6, axis=0)
        self._min_value = -3.32237
        super().__init__()

    def _value_and_grad(self, x):
        diff = x[None, :] - _H6_P                          # (4, 6)
        terms = _H6_ALPHA * np.exp(-np.sum(_H6_A * diff**2, axis=1))
        value = -np.sum(terms)
        grad = np.sum(terms[:, None] * 2.0 * _H6_A * diff, axis=0)
        return value, grad


class Hartmann6WithDerivatives(Hartmann6):
    """Noisy Hartmann6 with all six partials observed."""

    _observations = (0, 1, 2, 3, 4, 5)
    _sample_var = 0.01
