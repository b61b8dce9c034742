"""RepeatedDomain compat wrapper.

Counterpart of ``cornell_moe_tpu/compat/repeated_domain.py`` (the
reference's ``python/repeated_domain.py``): wraps a compat domain so every
operation acts on (num_points, num_repeats, dim) blocks, the reference's
q-point product domain, on the wrapped domain's device and dtype.
"""

from __future__ import annotations

import torch

from cornell_moe_tpu_torch.compat._boundary import to_numpy, to_tensor
from cornell_moe_tpu_torch.ops import domains as dom_mod


class RepeatedDomain:

    def __init__(self, num_repeats: int, domain):
        self.num_repeats = int(num_repeats)
        self._domain = domain
        self.device, self.dtype = domain.device, domain.dtype
        self._core = dom_mod.RepeatedDomain(domain=domain.core,
                                            num_repeats=self.num_repeats)

    @property
    def core(self):
        return self._core

    @property
    def dim(self):
        return self._domain.dim

    def _tensor(self, array):
        return to_tensor(array, self.device, self.dtype)

    def check_point_inside(self, points):
        return bool(torch.all(self._core.check_point_inside(
            self._tensor(points))))

    def generate_uniform_random_points_in_domain(self, num_points,
                                                 random_source=None):
        pts = self._domain.generate_uniform_random_points_in_domain(
            num_points * self.num_repeats, random_source)
        return pts.reshape(num_points, self.num_repeats, self.dim)

    def generate_latin_hypercube_points(self, num_points,
                                        random_source=None):
        pts = self._domain.generate_latin_hypercube_points(
            num_points * self.num_repeats, random_source)
        return pts.reshape(num_points, self.num_repeats, self.dim)

    def compute_update_restricted_to_domain(self, max_relative_change,
                                            current_point, update_vector):
        return to_numpy(self._core.limit_update(
            max_relative_change, self._tensor(current_point),
            self._tensor(update_vector)))
