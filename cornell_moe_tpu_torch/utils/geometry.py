"""Geometry primitives and space-filling designs.

Counterpart of ``cornell_moe_tpu/utils/geometry.py`` (the reference's
``python/geometry_utils.py`` and ``cpp/gpp_geometry.hpp``): ClosedInterval,
hypercube/simplex membership, latin-hypercube and grid point generation,
and the hyperplane primitive.  Host-side numpy utilities; the tensor
versions live on the domain classes (``ops/domains.py``).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

ClosedInterval = namedtuple("ClosedInterval", ["min", "max"])
ClosedInterval.length = property(lambda self: self.max - self.min)
ClosedInterval.is_inside = lambda self, value: \
    self.min <= value <= self.max
ClosedInterval.is_empty = lambda self: self.min > self.max


def _bounds(domain_bounds) -> np.ndarray:
    return np.asarray([(b[0], b[1]) for b in domain_bounds], dtype=float)


def generate_latin_hypercube_points(num_points, domain_bounds, seed=None):
    """LHC sample over a list of ClosedInterval/(min, max) pairs, from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    bounds = _bounds(domain_bounds)
    dim = bounds.shape[0]
    out = np.empty((num_points, dim))
    for d in range(dim):
        perm = rng.permutation(num_points)
        u = rng.random(num_points)
        out[:, d] = bounds[d, 0] + (perm + u) / num_points * \
            (bounds[d, 1] - bounds[d, 0])
    return out


def generate_grid_points(points_per_dimension, domain_bounds):
    """Tensor-product grid, the first coordinate varying slowest."""
    bounds = _bounds(domain_bounds)
    dim = bounds.shape[0]
    per_dim = np.broadcast_to(np.asarray(points_per_dimension), (dim,))
    axes = [np.linspace(bounds[d, 0], bounds[d, 1], int(per_dim[d]))
            for d in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1)


def check_point_inside_hypercube(domain_bounds, point) -> bool:
    """CheckPointInHypercube: every coordinate within its bounds."""
    point = np.asarray(point)
    bounds = _bounds(domain_bounds)
    return bool(np.all((point >= bounds[:, 0]) & (point <= bounds[:, 1])))


def check_point_in_unit_simplex(point) -> bool:
    """CheckPointInUnitSimplex: x >= 0 and sum(x) <= 1."""
    point = np.asarray(point)
    return bool(np.all(point >= 0.0) and point.sum() <= 1.0)


class Plane:
    """Hyperplane a_0 + sum_i n_i x_i = 0 with unit normal: signed
    distances, orthogonal projection and ray intersection distances, the
    primitives of the simplex domain's walls."""

    def __init__(self, unit_normal, offset=None, point=None):
        self.unit_normal = np.asarray(unit_normal, dtype=float)
        if offset is not None:
            self.offset = float(offset)
        elif point is not None:
            # plane through `point` with the given normal
            self.offset = -float(np.dot(np.asarray(point, float),
                                        self.unit_normal))
        else:
            self.offset = 0.0

    @property
    def dim(self) -> int:
        return self.unit_normal.shape[0]

    def orthogonal_distance_to_point(self, point) -> float:
        """Signed shortest distance (positive = normal's half-space)."""
        return float(np.dot(np.asarray(point, float), self.unit_normal)
                     + self.offset)

    def orthogonal_projection_onto_plane(self, point) -> np.ndarray:
        """The plane point closest to ``point``."""
        p = np.asarray(point, dtype=float)
        return p - self.orthogonal_distance_to_point(p) * self.unit_normal

    def distance_to_plane_along_vector(self, point, vector) -> float:
        """Signed ray-intersection distance in units of ||vector||."""
        p = np.asarray(point, float)
        v = np.asarray(vector, float)
        num = -self.offset - float(np.dot(p, self.unit_normal))
        return num / float(np.dot(v, self.unit_normal))
