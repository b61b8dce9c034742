"""Sample data containers.

Counterpart of ``python/data_containers.py`` in the reference: SamplePoint
(point, value-vector including derivative channels, noise) and
HistoricalData (data_containers.py:19,78).  Host-side numpy containers, a
copy of ``cornell_moe_tpu/utils/data_containers.py`` (numpy only); callers
turn the accessors' arrays into tensors on their own device.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Iterable, List

import numpy as np

SamplePoint = namedtuple("SamplePoint", ["point", "value", "noise_variance"])
SamplePoint.__new__.__defaults__ = (0.0,)
SamplePoint.__doc__ = """A single observation.

``value`` is a vector of length 1 + num_derivatives: the observed function
value followed by the observed partial derivatives (data_containers.py:19).
"""


class HistoricalData:
    """Append-only record of (point, value-channels, noise) observations.

    ``points_sampled_value`` has shape (n, 1 + num_derivatives)
    (data_containers.py:129).
    """

    def __init__(self, dim: int, num_derivatives: int = 0,
                 sample_points: Iterable = ()):
        self.dim = int(dim)
        self.num_derivatives = int(num_derivatives)
        self._points: List[np.ndarray] = []
        self._values: List[np.ndarray] = []
        self._noises: List[float] = []
        self.append_sample_points(sample_points)

    # -- mutation ---------------------------------------------------------
    def append_sample_points(self, sample_points: Iterable) -> None:
        for sp in sample_points:
            if isinstance(sp, SamplePoint):
                point, value, noise = sp.point, sp.value, sp.noise_variance
            else:
                point, value = sp[0], sp[1]
                noise = sp[2] if len(sp) > 2 else 0.0
            point = np.asarray(point, dtype=float).reshape(-1)
            value = np.atleast_1d(np.asarray(value, dtype=float))
            if point.shape != (self.dim,):
                raise ValueError(
                    f"point has dim {point.shape}, expected ({self.dim},)")
            if value.shape != (1 + self.num_derivatives,):
                raise ValueError(
                    f"value has {value.shape[0]} channels, expected "
                    f"{1 + self.num_derivatives}")
            self._points.append(point)
            self._values.append(value)
            self._noises.append(float(noise))

    def append_historical_data(self, points_sampled, points_sampled_value,
                               points_sampled_noise_variance=None) -> None:
        pts = np.atleast_2d(np.asarray(points_sampled, dtype=float))
        vals = np.asarray(points_sampled_value, dtype=float)
        if vals.ndim == 1:
            vals = vals[:, None]
        noises = np.zeros(pts.shape[0]) if points_sampled_noise_variance \
            is None else np.asarray(points_sampled_noise_variance)
        for p, v, s in zip(pts, vals, noises):
            self.append_sample_points([SamplePoint(p, v, float(s))])

    # -- accessors --------------------------------------------------------
    @property
    def num_sampled(self) -> int:
        return len(self._points)

    @property
    def points_sampled(self) -> np.ndarray:
        if not self._points:
            return np.zeros((0, self.dim))
        return np.stack(self._points)

    @property
    def points_sampled_value(self) -> np.ndarray:
        if not self._values:
            return np.zeros((0, 1 + self.num_derivatives))
        return np.stack(self._values)

    @property
    def points_sampled_noise_variance(self) -> np.ndarray:
        return np.asarray(self._noises)

    @property
    def best_value(self) -> float:
        return float(self.points_sampled_value[:, 0].min())

    @property
    def best_point(self) -> np.ndarray:
        return self.points_sampled[
            int(np.argmin(self.points_sampled_value[:, 0]))]

    def to_list_of_sample_points(self) -> List[SamplePoint]:
        return [SamplePoint(p, v, s) for p, v, s in
                zip(self._points, self._values, self._noises)]

    def __str__(self) -> str:  # print_historical_data parity
        return (f"HistoricalData(dim={self.dim}, "
                f"num_sampled={self.num_sampled}, "
                f"num_derivatives={self.num_derivatives})\n"
                f"points:\n{self.points_sampled}\n"
                f"values:\n{self.points_sampled_value}")
