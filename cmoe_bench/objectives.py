"""The objective the benchmark owns, a frozen copy of Branin as the port's
``utils/synthetic_functions.py`` defines it (the raw domain [0, 15] x
[-5, 15], no observation noise).

The port receives only points and values: an :class:`Objective` carries
the attributes ``BayesianOptimizer`` reads (``_dim``, ``_search_domain``,
``_num_init_pts``, ``_sample_var``, ``_observations``, ``_num_fidelity``)
and ``evaluate``.  It logs every point it is asked for
and the value it gave (``log``) and the host seconds it spent
(``seconds``), so that the harness hands the reference the same data and
takes its own evaluations out of the retrain's span.
"""

from __future__ import annotations

import math
import time

import numpy as np

BRANIN_DOMAIN = [[0.0, 15.0], [-5.0, 15.0]]


def branin(x) -> float:
    """Branin at x (2,): min 0.397887 at (pi, 2.275) and (9.42478, 2.475)."""
    a, b = 1.0, 5.1 / (4 * math.pi ** 2)
    c, r = 5.0 / math.pi, 6.0
    s, t = 10.0, 1.0 / (8 * math.pi)
    inner = x[1] - b * x[0] ** 2 + c * x[0] - r
    return a * inner ** 2 + s * (1 - t) * math.cos(x[0]) + s


class Objective:
    """A noise-free objective in the driver's interface, logging what it
    evaluates."""

    _sample_var = 0.0
    _observations: tuple = ()
    _num_init_pts = 3

    def __init__(self, name: str):
        if name != "Branin":
            raise ValueError(f"unknown objective {name!r}")
        self._fn, self._num_fidelity = branin, 0
        self._search_domain = np.array(BRANIN_DOMAIN)
        self._dim = self._search_domain.shape[0]
        self.log: list = []
        self.seconds = 0.0

    def evaluate(self, x) -> np.ndarray:
        t0 = time.perf_counter()
        x = np.asarray(x, dtype=float).copy()
        value = float(self._fn(x))
        self.log.append((x, value))
        self.seconds += time.perf_counter() - t0
        return np.array([value])
