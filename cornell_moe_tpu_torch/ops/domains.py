"""Optimization domains: the tensor-product box and its q-point repeat.

Counterpart of ``TensorProductDomain`` and ``RepeatedDomain`` in
``cornell_moe_tpu/ops/domains.py``.  Random points come from an explicit
``torch.Generator`` on the bounds' device.
"""

from __future__ import annotations

import dataclasses

import torch

# When a proposed step would exit the domain, fall back to the larger of
# half the step or half the distance to the wall (kInvalidStepScaleFactor).
_INVALID_STEP_SCALE = 0.5


def box_limit_update(lower, upper, max_relative_change, x: torch.Tensor,
                     dx: torch.Tensor) -> torch.Tensor:
    """Clamp a proposed step so the new point stays inside the box.

    Per coordinate, |step| is capped at ``max_relative_change`` times the
    distance to the nearest wall; a step that would still exit falls back
    to half the step or half the distance to the violated wall.
    """
    dist = torch.minimum(x - lower, upper - x)
    cap = max_relative_change * dist
    step = torch.where(torch.abs(dx) > cap, torch.sign(dx) * cap, dx)
    nxt = x + step
    half = step * _INVALID_STEP_SCALE
    fix_lo = torch.where((x + half) < lower,
                         (lower - x) * _INVALID_STEP_SCALE, half)
    fix_hi = torch.where((x + half) > upper,
                         (upper - x) * _INVALID_STEP_SCALE, half)
    return torch.where(nxt < lower, fix_lo,
                       torch.where(nxt > upper, fix_hi, step))


@dataclasses.dataclass
class TensorProductDomain:
    """Axis-aligned box; ``bounds`` is (dim, 2) = [min, max] per row."""

    bounds: torch.Tensor

    @classmethod
    def from_bounds(cls, bounds, device=None, dtype=torch.float64
                    ) -> "TensorProductDomain":
        return cls(bounds=torch.as_tensor(bounds, dtype=dtype,
                                          device=device).reshape(-1, 2))

    @property
    def dim(self) -> int:
        return self.bounds.shape[0]

    @property
    def lower(self) -> torch.Tensor:
        return self.bounds[:, 0]

    @property
    def upper(self) -> torch.Tensor:
        return self.bounds[:, 1]

    def check_point_inside(self, point: torch.Tensor) -> torch.Tensor:
        return torch.all((point >= self.lower) & (point <= self.upper),
                         dim=-1)

    def clip(self, point: torch.Tensor) -> torch.Tensor:
        return torch.minimum(torch.maximum(point, self.lower), self.upper)

    def generate_uniform_random_points_in_domain(
            self, generator: torch.Generator, num_points: int
            ) -> torch.Tensor:
        u = torch.rand((num_points, self.dim), generator=generator,
                       dtype=self.bounds.dtype, device=self.bounds.device)
        return self.lower + u * (self.upper - self.lower)

    def generate_latin_hypercube_points(self, generator: torch.Generator,
                                        num_points: int) -> torch.Tensor:
        """Stratified Latin-hypercube sample."""
        dev, dt = self.bounds.device, self.bounds.dtype
        perms = torch.stack([
            torch.randperm(num_points, generator=generator, device=dev)
            for _ in range(self.dim)], dim=1).to(dt)        # (n, dim)
        u = torch.rand((num_points, self.dim), generator=generator,
                       dtype=dt, device=dev)
        strata = (perms + u) / num_points
        return self.lower + strata * (self.upper - self.lower)

    def limit_update(self, max_relative_change, current_point: torch.Tensor,
                     update_vector: torch.Tensor) -> torch.Tensor:
        return box_limit_update(self.lower, self.upper, max_relative_change,
                                current_point, update_vector)


@dataclasses.dataclass
class RepeatedDomain:
    """q-point product domain: arrays of shape (..., num_repeats, dim)."""

    domain: TensorProductDomain
    num_repeats: int

    @property
    def dim(self) -> int:
        return self.domain.dim

    def check_point_inside(self, points: torch.Tensor) -> torch.Tensor:
        return torch.all(self.domain.check_point_inside(points), dim=-1)

    def clip(self, points: torch.Tensor) -> torch.Tensor:
        return self.domain.clip(points)

    def generate_uniform_random_points_in_domain(
            self, generator: torch.Generator, num_points: int
            ) -> torch.Tensor:
        pts = self.domain.generate_uniform_random_points_in_domain(
            generator, num_points * self.num_repeats)
        return pts.reshape(num_points, self.num_repeats, self.dim)

    def generate_latin_hypercube_points(self, generator: torch.Generator,
                                        num_points: int) -> torch.Tensor:
        pts = self.domain.generate_latin_hypercube_points(
            generator, num_points * self.num_repeats)
        return pts.reshape(num_points, self.num_repeats, self.dim)

    def limit_update(self, max_relative_change, current_point: torch.Tensor,
                     update_vector: torch.Tensor) -> torch.Tensor:
        return self.domain.limit_update(max_relative_change, current_point,
                                        update_vector)
