"""The numpy/tensor boundary of the compatibility layer, its autograd
hook, and the program form of its objectives."""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from cornell_moe_tpu_torch.ops import programs


def to_tensor(array, device, dtype) -> torch.Tensor:
    """A float tensor on ``device`` in ``dtype`` from numpy or a list."""
    return torch.as_tensor(np.asarray(array, dtype=float), device=device,
                           dtype=dtype)


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


def value_and_grad_by_autograd(fn: Callable, x: torch.Tensor):
    """(fn(x), d fn / d x), both detached, by ``torch.autograd`` of a
    scalar-valued ``fn``."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        value = fn(xx)
        (grad,) = torch.autograd.grad(value, xx)
    return value.detach(), grad


class ProgramForm(NamedTuple):
    """An objective as a function of tensors, the form a program captures:
    ``objective(x, *inputs)`` is its value at x (differentiable), reading
    no tensor but ``inputs`` and no setting but those in ``key`` (the
    objective's kind and settings, hashable)."""
    key: tuple
    inputs: tuple
    objective: Callable


def ensemble_cache(gp_mcmc) -> programs.ProgramCache:
    """The program cache of the ensemble an objective is built on: a
    ``GaussianProcessMCMC``'s own, or a new one for a functional state."""
    cache = getattr(gp_mcmc, "program_cache", None)
    return programs.ProgramCache() if cache is None else cache


def domain_bounds(core) -> torch.Tensor:
    """The bounds tensor under a core domain (repeated, simplex or box)."""
    while not hasattr(core, "bounds"):
        core = getattr(core, "domain", None) or core.tensor_product_domain
    return core.bounds


def _inner_field(core) -> str:
    return "domain" if hasattr(core, "domain") else "tensor_product_domain"


def with_bounds(core, bounds: torch.Tensor):
    """``core`` with its box's bounds replaced by ``bounds``: the domain a
    program rebuilds from its bounds input."""
    if hasattr(core, "bounds"):
        return dataclasses.replace(core, bounds=bounds)
    name = _inner_field(core)
    return dataclasses.replace(
        core, **{name: with_bounds(getattr(core, name), bounds)})


def domain_key(core) -> tuple:
    """A core domain's structure without its bounds, for a program's key."""
    if hasattr(core, "bounds"):
        return (type(core).__name__,)
    return (type(core).__name__, getattr(core, "num_repeats", None)) + \
        domain_key(getattr(core, _inner_field(core)))


def rows(points):
    """Points as a float (n, d) array; None stays None."""
    return None if points is None else \
        np.atleast_2d(np.asarray(points, dtype=float))


class UnionPoints:
    """The state the EI and KG objects share: the points to sample (q, d),
    the points being sampled (p, d), and common random numbers, the MC
    normals (num_mc, q + p) drawn by ``_draw_normals`` from the object's
    ``_generator`` whenever the union's width changes.  A subclass sets
    ``device``, ``dtype``, ``_points_being_sampled``,
    ``_num_mc_iterations``, ``_generator`` and ``_normals = None`` before
    its first ``set_current_point``."""

    _draw_normals = None

    @property
    def num_to_sample(self):
        return self._points_to_sample.shape[0]

    @property
    def problem_size(self):
        return self.num_to_sample * self.dim

    def _tensor(self, array) -> torch.Tensor:
        return to_tensor(array, self.device, self.dtype)

    def _being(self):
        """The points being sampled as a tensor, or None."""
        return None if self._points_being_sampled is None else \
            self._tensor(self._points_being_sampled)

    def get_current_point(self):
        return np.copy(self._points_to_sample)

    def set_current_point(self, points_to_sample):
        self._points_to_sample = rows(points_to_sample)
        p = 0 if self._points_being_sampled is None else \
            self._points_being_sampled.shape[0]
        n_union = self.num_to_sample + p
        if self._normals is None or self._normals.shape[1] != n_union:
            self._normals = self._draw_normals(
                self._generator, self._num_mc_iterations, n_union,
                device=self.device, dtype=self.dtype)
