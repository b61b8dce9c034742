"""Optimization domains: the tensor-product box, its intersection with
the unit simplex, its q-point repeat, and the domain of every point.

Counterpart of ``cornell_moe_tpu/ops/domains.py``.  Random points come from
an explicit ``torch.Generator`` on the bounds' device.
"""

from __future__ import annotations

import dataclasses

import torch

# When a proposed step would exit the domain, fall back to the larger of
# half the step or half the distance to the wall (kInvalidStepScaleFactor).
_INVALID_STEP_SCALE = 0.5
# A relative change of exactly 1 could land on a wall of the simplex
# domain's box; it is reduced by this much (4 float32 epsilons).
_RELATIVE_CHANGE_EPSILON_TWEAK = 4.0 * torch.finfo(torch.float32).eps


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
class SimplexIntersectTensorProductDomain:
    """The box intersected with the unit simplex (sum(x) <= 1, x >= 0)."""

    tensor_product_domain: TensorProductDomain

    @classmethod
    def from_bounds(cls, bounds, device=None, dtype=torch.float64
                    ) -> "SimplexIntersectTensorProductDomain":
        """The box ``bounds`` intersected with [0, 1]^d, as the reference's
        constructor does."""
        box = TensorProductDomain.from_bounds(bounds, device=device,
                                              dtype=dtype)
        return cls(tensor_product_domain=TensorProductDomain(
            bounds=torch.clamp(box.bounds, 0.0, 1.0)))

    @property
    def dim(self) -> int:
        return self.tensor_product_domain.dim

    def check_point_inside(self, point: torch.Tensor) -> torch.Tensor:
        in_box = self.tensor_product_domain.check_point_inside(point)
        in_simplex = (torch.sum(point, dim=-1) <= 1.0) & \
            torch.all(point >= 0.0, dim=-1)
        return in_box & in_simplex

    def clip(self, point: torch.Tensor) -> torch.Tensor:
        """Clip to the box, then scale onto the simplex where the sum
        exceeds 1."""
        p = self.tensor_product_domain.clip(point)
        total = torch.sum(p, dim=-1, keepdim=True)
        return p * torch.where(total > 1.0, (1.0 - 1e-12) / total, 1.0)

    def generate_uniform_random_points_in_domain(
            self, generator: torch.Generator, num_points: int,
            oversample: int = 8) -> torch.Tensor:
        """Draw ``oversample`` times the points in the box, keep those
        inside the simplex first, and repair any shortfall by
        :meth:`clip`: the output size never depends on the draws."""
        cand = self.tensor_product_domain.\
            generate_uniform_random_points_in_domain(
                generator, num_points * oversample)
        ok = self.check_point_inside(cand)
        order = torch.argsort((~ok).to(torch.int8), stable=True)
        chosen = cand[order[:num_points]]
        return torch.where(self.check_point_inside(chosen)[:, None],
                           chosen, self.clip(chosen))

    def limit_update(self, max_relative_change, current_point: torch.Tensor,
                     update_vector: torch.Tensor) -> torch.Tensor:
        """The box's limit, then the step shrunk along its direction so
        that the new point's sum stays at most 1."""
        if max_relative_change == 1.0:
            max_relative_change -= _RELATIVE_CHANGE_EPSILON_TWEAK
        step = self.tensor_product_domain.limit_update(
            max_relative_change, current_point, update_vector)
        total = torch.sum(current_point + step, dim=-1, keepdim=True)
        step_sum = torch.sum(step, dim=-1, keepdim=True)
        denom = torch.where(torch.abs(step_sum) > 1e-300, step_sum, 1.0)
        scale = torch.clamp(
            (1.0 - torch.sum(current_point, dim=-1, keepdim=True)) / denom,
            0.0, 1.0)
        return torch.where(total > 1.0, step * scale, step)


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


def tensor_product_domain(bounds, device=None, dtype=torch.float64
                          ) -> TensorProductDomain:
    return TensorProductDomain.from_bounds(bounds, device=device, dtype=dtype)


class DummyDomain:
    """The domain that holds every point: no clipping, no step limit."""

    def check_point_inside(self, point: torch.Tensor) -> torch.Tensor:
        return torch.ones(point.shape[:-1], dtype=torch.bool,
                          device=point.device)

    def clip(self, point: torch.Tensor) -> torch.Tensor:
        return point

    def limit_update(self, max_relative_change, current_point,
                     update_vector):
        del max_relative_change, current_point
        return update_vector
