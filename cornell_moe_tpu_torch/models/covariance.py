"""Stationary covariance kernels as (F0, P, Q) fields of the scaled distance.

Counterpart of ``cornell_moe_tpu/models/covariance.py`` for value channels.
Every stationary kernel is three smooth scalar fields of the squared scaled
distance ``s = sum_i (x_i - y_i)^2 / l_i^2``:

    F0(s) = k(x, y),   P(s) = -2 dF0/ds,   Q(s) = -2 dP/ds.

Hyperparameters are ``[alpha, l_1, ..., l_d]`` with optional leading batch
axes: a (S, 1 + d) tensor is an ensemble of S kernels, and every function
below broadcasts over those axes (the JAX package vmaps instead).

Dispatch rule of :func:`build_covariance_matrix_with_noise`: CUDA, float32,
value-only channels and a known kernel go through the hand-written kernel
``ops.kernels.covariance_with_noise``; float64 and CPU tensors take its plain
version.  Derivative channels are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from cornell_moe_tpu_torch.ops import kernels

_SQRT5 = math.sqrt(5.0)


def safe_sqrt(s: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero (not NaN) derivative at s == 0."""
    pos = s > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), 0.0)


def _value_only(*derivative_lists) -> None:
    if any(len(tuple(d)) for d in derivative_lists):
        raise NotImplementedError(
            "derivative-observation channels are not ported yet; the port "
            "covers value channels only")


@dataclasses.dataclass
class StationaryCovariance:
    """A stationary kernel defined by its amplitude-free fields.

    ``unit_f0`` and ``unit_p`` are the fields with alpha = 1 (and, for P,
    without the constant ``p_scale``), the form the CUDA kernels evaluate.
    """

    hyperparameters: torch.Tensor   # (..., 1 + dim)

    name = ""
    p_scale = 1.0

    @property
    def alpha(self) -> torch.Tensor:
        return self.hyperparameters[..., 0]

    @property
    def lengths(self) -> torch.Tensor:
        return self.hyperparameters[..., 1:]

    @property
    def dim(self) -> int:
        return self.hyperparameters.shape[-1] - 1

    def _scaled(self, field: torch.Tensor) -> torch.Tensor:
        """alpha broadcast against a field whose leading axes are the
        hyperparameters' batch axes."""
        a = self.alpha
        return a.reshape(a.shape + (1,) * (field.dim() - a.dim())) * field

    @staticmethod
    def unit_f0(s):
        raise NotImplementedError

    @staticmethod
    def unit_p(s):
        raise NotImplementedError

    def f0(self, s: torch.Tensor) -> torch.Tensor:
        return self._scaled(self.unit_f0(s))

    def p(self, s: torch.Tensor) -> torch.Tensor:
        return self._scaled(self.p_scale * self.unit_p(s))


class SquareExponential(StationaryCovariance):
    """k = alpha * exp(-s / 2)."""

    name = "square_exponential"

    @staticmethod
    def unit_f0(s):
        return torch.exp(-0.5 * s)

    @staticmethod
    def unit_p(s):
        return torch.exp(-0.5 * s)


class MaternNu2p5(StationaryCovariance):
    """Matérn nu=5/2: k = alpha (1 + sqrt5 r + 5 s / 3) exp(-sqrt5 r)."""

    name = "matern_2.5"
    p_scale = 5.0 / 3.0

    @staticmethod
    def unit_f0(s):
        r = safe_sqrt(s)
        return (1.0 + _SQRT5 * r + (5.0 / 3.0) * s) * torch.exp(-_SQRT5 * r)

    @staticmethod
    def unit_p(s):
        r = safe_sqrt(s)
        return (1.0 + _SQRT5 * r) * torch.exp(-_SQRT5 * r)


COVARIANCE_TYPES = {
    "square_exponential": SquareExponential,
    "matern_2.5": MaternNu2p5,
}


def make_covariance(name: str, hyperparameters) -> StationaryCovariance:
    return COVARIANCE_TYPES[name](
        hyperparameters=torch.as_tensor(hyperparameters))


def pairwise_sq_dist(cov: StationaryCovariance, x1: torch.Tensor,
                     x2: torch.Tensor) -> torch.Tensor:
    """s over all point pairs: x1 (..., n1, d), x2 (..., n2, d) ->
    (..., n1, n2), broadcasting the hyperparameters' batch axes."""
    inv_l2 = 1.0 / cov.lengths[..., None, None, :] ** 2
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return torch.sum(diff * diff * inv_l2, dim=-1)


def build_block_covariance(cov: StationaryCovariance, x1: torch.Tensor,
                           derivatives1: Sequence[int], x2: torch.Tensor,
                           derivatives2: Sequence[int]) -> torch.Tensor:
    """Cross-covariance k(x1, x2) over value channels: (..., n1, n2)."""
    _value_only(derivatives1, derivatives2)
    return cov.f0(pairwise_sq_dist(cov, x1, x2))


def build_covariance_matrix_with_noise(
        cov: StationaryCovariance, points: torch.Tensor,
        derivatives: Sequence[int], noise_vec: torch.Tensor
        ) -> torch.Tensor:
    """K + diag(noise_vec) over value channels.

    ``points`` is (n, d), shared by every kernel of the batch;
    ``noise_vec`` is the total per-point diagonal noise, (..., n) with the
    hyperparameters' batch axes (or broadcastable to it).  Returns
    (..., n, n).
    """
    _value_only(derivatives)
    h = cov.hyperparameters
    batch = h.shape[:-1]
    n = points.shape[0]
    hypers = h.reshape(-1, h.shape[-1])
    noise = torch.broadcast_to(noise_vec, batch + (n,)).reshape(-1, n)
    if points.is_cuda and points.dtype == torch.float32 and \
            cov.name in COVARIANCE_TYPES:
        k = kernels.covariance_with_noise(
            points.contiguous(), hypers.contiguous(), noise.contiguous(),
            cov.name)
    else:
        k = kernels.covariance_with_noise_plain(points, hypers, noise,
                                                cov.name)
    return k.reshape(batch + (n, n))
