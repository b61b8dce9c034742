"""Synthetic objectives, in numpy.

Counterpart of ``cornell_moe_tpu/utils/synthetic_functions.py``, with its
``SYNTHETIC_FUNCTIONS`` registry (the command line's objectives).  Each
objective carries ``_dim``,
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


class BraninNoisy(Branin):
    """Branin with observation noise of variance 0.25."""

    _sample_var = 0.25


class Rosenbrock(SyntheticFunction):
    """Min 0 at (1, ..., 1)."""

    def __init__(self, dim: int = 2):
        self._dim = dim
        self._search_domain = np.repeat([[-2.0, 2.0]], dim, axis=0)
        self._min_value = 0.0
        super().__init__()

    def _value_and_grad(self, x):
        head, tail = x[:-1], x[1:]
        bend = tail - head**2
        value = np.sum((1.0 - head) ** 2 + 100.0 * bend**2)
        grad = np.zeros_like(x)
        grad[:-1] = -2.0 * (1.0 - head) - 400.0 * head * bend
        grad[1:] += 200.0 * bend
        return value, grad


def _hartmann(x, alpha, a, p):
    """-sum_i alpha_i exp(-sum_j a_ij (x_j - p_ij)^2) and its gradient."""
    diff = x[None, :] - p
    terms = alpha * np.exp(-np.sum(a * diff**2, axis=1))
    return -np.sum(terms), np.sum(terms[:, None] * 2.0 * a * diff, axis=0)


_H3_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H3_A = np.array([[3., 10., 30.], [0.1, 10., 35.],
                  [3., 10., 30.], [0.1, 10., 35.]])
_H3_P = 1e-4 * np.array([[3689, 1170, 2673], [4699, 4387, 7470],
                         [1091, 8732, 5547], [381, 5743, 8828]])


class Hartmann3(SyntheticFunction):
    """Min -3.86278 at (0.114614, 0.555649, 0.852547)."""

    def __init__(self):
        self._dim = 3
        self._search_domain = np.repeat([[0.0, 1.0]], 3, axis=0)
        self._min_value = -3.86278
        super().__init__()

    def _value_and_grad(self, x):
        return _hartmann(x, _H3_ALPHA, _H3_A, _H3_P)


class Levy4(SyntheticFunction):
    """Min 0 at (1, 1, 1, 1); a difficult case for KG-type methods."""

    def __init__(self):
        self._dim = 4
        self._search_domain = np.repeat([[-5.0, 5.0]], 4, axis=0)
        self._min_value = 0.0
        super().__init__()

    def _value_and_grad(self, x):
        z = 1.0 + (x - 1.0) / 4.0
        pi = math.pi
        head, last = z[:-1], z[-1]
        wave = 1.0 + 10.0 * np.sin(pi * head + 1.0) ** 2
        value = (math.sin(pi * z[0]) ** 2 + np.sum((head - 1.0) ** 2 * wave)
                 + (last - 1.0) ** 2 * (1.0 + math.sin(2.0 * pi * last) ** 2))
        dz = np.zeros_like(z)
        dz[0] = pi * math.sin(2.0 * pi * z[0])
        dz[:-1] += 2.0 * (head - 1.0) * wave + \
            10.0 * pi * (head - 1.0) ** 2 * np.sin(2.0 * (pi * head + 1.0))
        dz[-1] = 2.0 * (last - 1.0) * (1.0 + math.sin(2.0 * pi * last) ** 2) \
            + 2.0 * pi * (last - 1.0) ** 2 * math.sin(4.0 * pi * last)
        return value, dz / 4.0


class Ackley(SyntheticFunction):
    """Min 0 at the origin (domain scaled by 20 internally, value by 1/6);
    the gradient of the distance term at the origin, a kink, is 0."""

    def __init__(self, dim: int = 5):
        self._dim = dim
        self._search_domain = np.repeat([[-1.0, 1.0]], dim, axis=0)
        self._min_value = 0.0
        super().__init__()

    def _value_and_grad(self, x):
        xs = 20.0 * x
        n = xs.shape[0]
        r = math.sqrt(np.sum(xs**2) / n)
        decay = math.exp(-0.2 * r)
        waves = math.exp(np.sum(np.cos(2.0 * math.pi * xs)) / n)
        value = (-20.0 * decay - waves + 20.0 + math.e) / 6.0
        dr = xs / (n * r) if r > 0.0 else np.zeros_like(xs)
        grad = (4.0 * decay * dr +
                waves * 2.0 * math.pi * np.sin(2.0 * math.pi * xs) / n) / 6.0
        return value, 20.0 * grad


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
        return _hartmann(x, _H6_ALPHA, _H6_A, _H6_P)


class Hartmann6WithDerivatives(Hartmann6):
    """Noisy Hartmann6 with all six partials observed."""

    _observations = (0, 1, 2, 3, 4, 5)
    _sample_var = 0.01


SYNTHETIC_FUNCTIONS = {
    "Branin": Branin,
    "BraninNoisy": BraninNoisy,
    "BraninWithDerivatives": BraninWithDerivatives,
    "Hartmann6WithDerivatives": Hartmann6WithDerivatives,
    "BraninFidelity": BraninFidelity,
    "Rosenbrock": Rosenbrock,
    "Hartmann3": Hartmann3,
    "Levy4": Levy4,
    "Hartmann6": Hartmann6,
    "Ackley": Ackley,
}
