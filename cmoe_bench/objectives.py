"""The objectives the benchmark owns: frozen copies of the noise-free
entries of the port's ``utils/synthetic_functions.SYNTHETIC_FUNCTIONS``
(``Branin``, ``BraninWithDerivatives``, ``BraninFidelity``,
``Rosenbrock``, ``Hartmann3``, ``Levy4``, ``Hartmann6``, ``Ackley``), each
its value and its hand-written gradient, on the port's raw domain.

The port receives only points and values: an :class:`Objective` carries
the attributes ``BayesianOptimizer`` reads (``_dim``, ``_search_domain``,
``_num_init_pts``, ``_sample_var``, ``_observations``, ``_num_fidelity``)
and ``evaluate``, which returns ``[value, dv/dx_0, ..., dv/dx_{d-1}]`` as
the port's objectives do; the driver keeps the value and the partials
that ``_observations`` names.  The observed partials and the fidelity
dimensions come from the configuration (``observations``, default none;
``num_fidelity``).  It logs every point it is asked for and the whole
vector it gave (``log``) and the host seconds it spent (``seconds``), so
that the harness hands the reference the same data and takes its own
evaluations out of the retrain's span.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple

import numpy as np


def branin(x):
    """Branin at x (2,) and its gradient: min 0.397887 at (pi, 2.275) and
    (9.42478, 2.475)."""
    a, b = 1.0, 5.1 / (4 * math.pi ** 2)
    c, r = 5.0 / math.pi, 6.0
    s, t = 10.0, 1.0 / (8 * math.pi)
    inner = x[1] - b * x[0] ** 2 + c * x[0] - r
    value = a * inner ** 2 + s * (1 - t) * math.cos(x[0]) + s
    grad = np.array([2.0 * a * inner * (c - 2.0 * b * x[0])
                     - s * (1 - t) * math.sin(x[0]),
                     2.0 * a * inner])
    return value, grad


def branin_fidelity(x):
    """Branin with the fidelity s = x[2] in [0.05, 1]: a fidelity below 1
    adds 10 (1 - s) cos^2(x_0 / 2)."""
    value, grad = branin(x[:2])
    c = math.cos(0.5 * x[0])
    value = value + 10.0 * (1.0 - x[2]) * c ** 2
    grad = np.array([grad[0] - 5.0 * (1.0 - x[2]) * math.sin(x[0]),
                     grad[1], -10.0 * c ** 2])
    return value, grad


def rosenbrock(x):
    """Min 0 at (1, ..., 1)."""
    head, tail = x[:-1], x[1:]
    bend = tail - head ** 2
    value = np.sum((1.0 - head) ** 2 + 100.0 * bend ** 2)
    grad = np.zeros_like(x)
    grad[:-1] = -2.0 * (1.0 - head) - 400.0 * head * bend
    grad[1:] += 200.0 * bend
    return value, grad


def _hartmann(x, alpha, a, p):
    """-sum_i alpha_i exp(-sum_j a_ij (x_j - p_ij)^2) and its gradient."""
    diff = x[None, :] - p
    terms = alpha * np.exp(-np.sum(a * diff ** 2, axis=1))
    return -np.sum(terms), np.sum(terms[:, None] * 2.0 * a * diff, axis=0)


_H3_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H3_A = np.array([[3., 10., 30.], [0.1, 10., 35.],
                  [3., 10., 30.], [0.1, 10., 35.]])
_H3_P = 1e-4 * np.array([[3689, 1170, 2673], [4699, 4387, 7470],
                         [1091, 8732, 5547], [381, 5743, 8828]])
_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H6_A = np.array([[10, 3, 17, 3.50, 1.7, 8], [0.05, 10, 17, 0.1, 8, 14],
                  [3, 3.5, 1.7, 10, 17, 8], [17, 8, 0.05, 10, 0.1, 14]])
_H6_P = 1e-4 * np.array(
    [[1312, 1696, 5569, 124, 8283, 5886],
     [2329, 4135, 8307, 3736, 1004, 9991],
     [2348, 1451, 3522, 2883, 3047, 6650],
     [4047, 8828, 8732, 5743, 1091, 381]])


def hartmann3(x):
    """Min -3.86278 at (0.114614, 0.555649, 0.852547)."""
    return _hartmann(x, _H3_ALPHA, _H3_A, _H3_P)


def hartmann6(x):
    """Min -3.32237 at (0.20169, 0.150011, 0.476874, 0.275332, 0.311652,
    0.6573)."""
    return _hartmann(x, _H6_ALPHA, _H6_A, _H6_P)


def levy4(x):
    """Min 0 at (1, 1, 1, 1)."""
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


def ackley(x):
    """Min 0 at the origin (the domain scaled by 20, the value by 1/6); the
    gradient of the distance term at the origin, a kink, is 0."""
    xs = 20.0 * x
    n = xs.shape[0]
    r = math.sqrt(np.sum(xs ** 2) / n)
    decay = math.exp(-0.2 * r)
    waves = math.exp(np.sum(np.cos(2.0 * math.pi * xs)) / n)
    value = (-20.0 * decay - waves + 20.0 + math.e) / 6.0
    dr = xs / (n * r) if r > 0.0 else np.zeros_like(xs)
    grad = (4.0 * decay * dr +
            waves * 2.0 * math.pi * np.sin(2.0 * math.pi * xs) / n) / 6.0
    return value, 20.0 * grad


class Spec(NamedTuple):
    """An objective: its value and gradient, raw domain and fidelity
    dimensions (the last coordinates)."""

    fn: Callable
    domain: list
    num_fidelity: int


_BRANIN_DOMAIN = [[0.0, 15.0], [-5.0, 15.0]]
OBJECTIVES = {
    "Branin": Spec(branin, _BRANIN_DOMAIN, 0),
    "BraninWithDerivatives": Spec(branin, _BRANIN_DOMAIN, 0),
    "BraninFidelity": Spec(branin_fidelity, _BRANIN_DOMAIN + [[0.05, 1.0]],
                           1),
    "Rosenbrock": Spec(rosenbrock, [[-2.0, 2.0]] * 2, 0),
    "Hartmann3": Spec(hartmann3, [[0.0, 1.0]] * 3, 0),
    "Levy4": Spec(levy4, [[-5.0, 5.0]] * 4, 0),
    "Hartmann6": Spec(hartmann6, [[0.0, 1.0]] * 6, 0),
    "Ackley": Spec(ackley, [[-1.0, 1.0]] * 5, 0),
}


class Objective:
    """A noise-free objective in the driver's interface, logging what it
    evaluates."""

    _sample_var = 0.0
    _num_init_pts = 3

    def __init__(self, name: str, observations=(), num_fidelity: int = 0):
        if name not in OBJECTIVES:
            raise ValueError(f"unknown objective {name!r}")
        spec = OBJECTIVES[name]
        if num_fidelity != spec.num_fidelity:
            raise ValueError(f"{name} has {spec.num_fidelity} fidelity "
                             f"dimensions, not {num_fidelity!r}")
        self._fn, self._num_fidelity = spec.fn, spec.num_fidelity
        self._search_domain = np.array(spec.domain)
        self._dim = self._search_domain.shape[0]
        obs = tuple(observations)
        if len(set(obs)) != len(obs) or not all(
                isinstance(i, int) and 0 <= i < self._dim for i in obs):
            raise ValueError(f"observations {list(obs)!r} of {name}: "
                             f"distinct partials of 0..{self._dim - 1}")
        self._observations = obs
        self.log: list = []
        self.seconds = 0.0

    @property
    def channels(self) -> list:
        """The entries of ``evaluate``'s vector that the driver observes:
        the value, then the observed partials in their order."""
        return [0] + [1 + i for i in self._observations]

    def evaluate(self, x) -> np.ndarray:
        t0 = time.perf_counter()
        x = np.asarray(x, dtype=float).copy()
        value, grad = self._fn(x)
        out = np.concatenate([[float(value)], np.asarray(grad, dtype=float)])
        self.log.append((x, out))
        self.seconds += time.perf_counter() - t0
        return out
