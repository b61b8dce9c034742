"""The numpy/tensor boundary of the compatibility layer and its autograd
hook."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


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
