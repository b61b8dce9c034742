"""HeSBO count-sketch embedding for high-dimensional problems.

Counterpart of ``cornell_moe_tpu/utils/hesbo.py``, numpy only: optimize in a
random low-dimensional box (the first low_dim coordinates of the original
search domain) and evaluate the objective at the count-sketch
back-projection, where each high dimension copies one sign-flipped low
dimension (Nayebi et al., HeSBO).  The sketch is drawn from
``np.random.default_rng(seed)`` in the same order as there, so both
packages hold the same projection for a seed.
"""

from __future__ import annotations

import copy

import numpy as np


class Projection:
    """Wrap an objective so it is optimized in a low-dim embedding."""

    def __init__(self, low_dim: int, obj_func, seed: int = 0):
        rng = np.random.default_rng(seed)
        self._dim = low_dim
        self._search_domain = copy.deepcopy(
            np.asarray(obj_func._search_domain)[:low_dim])
        self._num_init_pts = obj_func._num_init_pts
        self._sample_var = obj_func._sample_var
        self._min_value = obj_func._min_value
        self._observations = obj_func._observations
        self._num_fidelity = obj_func._num_fidelity

        self.obj_func = obj_func
        self._org_search_domain = np.asarray(obj_func._search_domain)
        self._high_to_low = rng.integers(0, low_dim, obj_func._dim)
        self._sign = rng.choice([-1.0, 1.0], obj_func._dim)

    def _box_scale(self, k):
        dom = self._org_search_domain
        return (dom[:k, 1] + dom[:k, 0]) / 2, (dom[:k, 1] - dom[:k, 0]) / 2

    def _org_to_box(self, x):
        """Original coordinates -> the [-1, 1] box (per low dim)."""
        x = np.atleast_2d(np.asarray(x, dtype=float)).copy()
        k = min(len(self._org_search_domain), x.shape[1])
        mid, half = self._box_scale(k)
        x[:, :k] = (x[:, :k] - mid) / half
        return x

    def _box_to_org(self, x):
        x = np.atleast_2d(np.asarray(x, dtype=float)).copy()
        k = min(len(self._org_search_domain), x.shape[1])
        mid, half = self._box_scale(k)
        x[:, :k] = x[:, :k] * half + mid
        return x

    def back_projection(self, low_obs):
        """Low-dim point(s) -> high-dim point(s) via the count sketch."""
        low = self._org_to_box(low_obs)
        high = self._sign[None, :] * low[:, self._high_to_low]
        return np.squeeze(self._box_to_org(high))

    def evaluate_true(self, x):
        return self.obj_func.evaluate_true(self.back_projection(x))

    def evaluate(self, x):
        return self.obj_func.evaluate(self.back_projection(x))

    @property
    def derivative_observations(self):
        return tuple(self._observations)


projection = Projection  # the reference's spelling (hesbo_embed.projection)
