"""Synthetic objectives, in numpy.

Counterpart of ``cornell_moe_tpu/utils/synthetic_functions.py`` for the
objective the port's main path uses.  Each objective carries ``_dim``,
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
