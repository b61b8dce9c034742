"""Domain wrappers for the compatibility layer.

Counterpart of ``cornell_moe_tpu/compat/domain.py`` (the reference's
``cpp_wrappers/domain.py``): TensorProductDomain and
SimplexIntersectTensorProductDomain built from ClosedInterval lists, with
the reference's ``_domain_type`` tags and numpy returns.  The core domain
(:attr:`core`) lives on the wrapper's ``device`` in its ``dtype``; random
points come from ``random_source``'s uniform generator when one is given,
else from the wrapper's own ``generator`` (seed 0 by default).
"""

from __future__ import annotations

import numpy as np

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.compat._boundary import to_numpy, to_tensor
from cornell_moe_tpu_torch.compat.interfaces import DomainInterface
from cornell_moe_tpu_torch.ops import domains as dom_mod
from cornell_moe_tpu_torch.utils.constant import (
    SIMPLEX_INTERSECT_TENSOR_PRODUCT_DOMAIN_TYPE,
    TENSOR_PRODUCT_DOMAIN_TYPE)
from cornell_moe_tpu_torch.utils.rng import as_generator


class _DomainCompat(DomainInterface):

    _core_class = None

    def __init__(self, domain_bounds, generator=None, device=None,
                 dtype=None):
        self._domain_bounds = [(float(b[0]), float(b[1]))
                               for b in domain_bounds]
        self.device, self.dtype = config.placement(device, dtype)
        self._core = self._core_class.from_bounds(
            np.asarray(self._domain_bounds), device=self.device,
            dtype=self.dtype)
        self._generator = as_generator(generator, self.device)

    def _source(self, random_source):
        return self._generator if random_source is None else \
            random_source.uniform_generator

    def _tensor(self, array):
        return to_tensor(array, self.device, self.dtype)

    @property
    def dim(self):
        return len(self._domain_bounds)

    @property
    def core(self):
        """The port's functional domain."""
        return self._core

    def check_point_inside(self, point):
        return bool(self._core.check_point_inside(self._tensor(point)))

    def generate_uniform_random_points_in_domain(self, num_points,
                                                 random_source=None):
        return to_numpy(self._core.generate_uniform_random_points_in_domain(
            self._source(random_source), num_points))

    def generate_latin_hypercube_points(self, num_points,
                                        random_source=None):
        return to_numpy(self._core.generate_latin_hypercube_points(
            self._source(random_source), num_points))

    def compute_update_restricted_to_domain(self, max_relative_change,
                                            current_point, update_vector):
        return to_numpy(self._core.limit_update(
            max_relative_change, self._tensor(current_point),
            self._tensor(update_vector)))


class TensorProductDomain(_DomainCompat):
    """cpp_wrappers/domain.py TensorProductDomain counterpart."""

    _domain_type = TENSOR_PRODUCT_DOMAIN_TYPE
    _core_class = dom_mod.TensorProductDomain


class SimplexIntersectTensorProductDomain(_DomainCompat):
    """cpp_wrappers/domain.py SimplexIntersectTensorProductDomain
    counterpart."""

    _domain_type = SIMPLEX_INTERSECT_TENSOR_PRODUCT_DOMAIN_TYPE
    _core_class = dom_mod.SimplexIntersectTensorProductDomain
