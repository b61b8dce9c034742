"""Stationary covariance kernels as (F0, P, Q) fields of the scaled distance,
with derivative-observation blocks.

Counterpart of ``cornell_moe_tpu/models/covariance.py``.  Every stationary
kernel is three smooth scalar fields of the squared scaled distance
``s = sum_i (x_i - y_i)^2 / l_i^2``:

    F0(s) = k(x, y)
    P(s)  = -2 dF0/ds     so  dk/dx_i       = -P t_i
    Q(s)  = -2 dP/ds      so  d2k/dx_i dy_j = P delta_ij / l_i^2 - Q t_i t_j

with ``t_i = (x_i - y_i) / l_i^2``.  Each point carries ``1 + m`` channels
``[value, df/dx_{i_1}, ..., df/dx_{i_m}]`` and matrices are point-major,
channel-minor.

Hyperparameters are ``[alpha, l_1, ..., l_d]`` with optional leading batch
axes: a (S, 1 + d) tensor is an ensemble of S kernels, and every function
below broadcasts over those axes (the JAX package vmaps instead).

Dispatch rule of :func:`build_covariance_matrix_with_noise`
(:func:`uses_covariance_kernel`): CUDA, float32, value-only channels and a
known kernel go through the hand-written kernel
``ops.kernels.covariance_with_noise``; everything else, derivative channels
included, takes the plain build, as the JAX package's Pallas gate does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.ops import kernels, programs

_SQRT5 = math.sqrt(5.0)


def safe_sqrt(s: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero (not NaN) derivative at s == 0."""
    pos = s > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), 0.0)


def channels(derivatives: Sequence[int]) -> Tuple[int, ...]:
    """The derivative indices as a tuple of ints."""
    return tuple(int(i) for i in derivatives)


@dataclasses.dataclass
class StationaryCovariance:
    """A stationary kernel defined by its amplitude-free fields.

    ``unit_f0``, ``unit_p`` and ``unit_q`` are the fields with alpha = 1
    (and, for P and Q, without the constants ``p_scale`` and ``q_scale``),
    the form the CUDA kernels evaluate.
    """

    hyperparameters: torch.Tensor   # (..., 1 + dim)

    name = ""
    p_scale = 1.0
    q_scale = 1.0

    @property
    def alpha(self) -> torch.Tensor:
        return self.hyperparameters[..., 0]

    @property
    def lengths(self) -> torch.Tensor:
        return self.hyperparameters[..., 1:]

    @property
    def num_hyperparameters(self) -> int:
        return self.hyperparameters.shape[-1]

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

    @staticmethod
    def unit_q(s):
        raise NotImplementedError

    def f0(self, s: torch.Tensor) -> torch.Tensor:
        return self._scaled(self.unit_f0(s))

    def p(self, s: torch.Tensor) -> torch.Tensor:
        return self._scaled(self.p_scale * self.unit_p(s))

    def q(self, s: torch.Tensor) -> torch.Tensor:
        return self._scaled(self.q_scale * self.unit_q(s))

    # The scalar methods take one point pair per kernel: x and y (...,
    # dim), their leading axes those of the hyperparameters' batch (or
    # broadcasting against them), as the JAX package's methods vmapped.

    def scaled_square_dist(self, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
        """s = sum_i (x_i - y_i)^2 / l_i^2, (...)."""
        diff = x - y
        return torch.sum(diff * diff / self.lengths ** 2, dim=-1)

    def covariance(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """k(x, y), (...)."""
        return self.f0(self.scaled_square_dist(x, y))

    def grad_covariance(self, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
        """dk(x, y) / dx = -P(s) (x - y) / l^2, (..., dim)."""
        t = (x - y) / self.lengths ** 2
        return -self.p(self.scaled_square_dist(x, y))[..., None] * t

    def hyperparameter_grad_covariance(self, x: torch.Tensor,
                                       y: torch.Tensor) -> torch.Tensor:
        """d k(x, y) / d hyperparameters, (1 + dim,), by forward-mode
        autograd (``torch.func.jacfwd``)."""
        return torch.func.jacfwd(
            lambda h: type(self)(hyperparameters=h).covariance(x, y))(
                self.hyperparameters)


class SquareExponential(StationaryCovariance):
    """k = alpha * exp(-s / 2)."""

    name = "square_exponential"

    @staticmethod
    def unit_f0(s):
        return torch.exp(-0.5 * s)

    @staticmethod
    def unit_p(s):
        return torch.exp(-0.5 * s)

    @staticmethod
    def unit_q(s):
        return torch.exp(-0.5 * s)


class MaternNu2p5(StationaryCovariance):
    """Matérn nu=5/2: k = alpha (1 + sqrt5 r + 5 s / 3) exp(-sqrt5 r)."""

    name = "matern_2.5"
    p_scale = 5.0 / 3.0
    q_scale = 25.0 / 3.0

    @staticmethod
    def unit_f0(s):
        r = safe_sqrt(s)
        return (1.0 + _SQRT5 * r + (5.0 / 3.0) * s) * torch.exp(-_SQRT5 * r)

    @staticmethod
    def unit_p(s):
        r = safe_sqrt(s)
        return (1.0 + _SQRT5 * r) * torch.exp(-_SQRT5 * r)

    @staticmethod
    def unit_q(s):
        return torch.exp(-_SQRT5 * safe_sqrt(s))


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
    """Cross-covariance over channels: (..., n1 (1+m1), n2 (1+m2)).

    The (point i, channel a) x (point j, channel b) entry is k(x_i, y_j)
    for a = b = 0, dk/dx_{d1[a-1]} for b = 0, dk/dy_{d2[b-1]} for a = 0 and
    d2k/dx_{d1[a-1]} dy_{d2[b-1]} otherwise.
    """
    d1, d2 = channels(derivatives1), channels(derivatives2)
    if not d1 and not d2:
        return cov.f0(pairwise_sq_dist(cov, x1, x2))
    inv_l2 = 1.0 / cov.lengths[..., None, None, :] ** 2
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    t = diff * inv_l2
    s = torch.sum(diff * t, dim=-1)
    f0, p = cov.f0(s), cov.p(s)
    q = cov.q(s) if d1 and d2 else None
    rows = [[f0] + [p * t[..., j] for j in d2]]
    for i in d1:
        rows.append([-p * t[..., i]] + [
            (p * inv_l2[..., i] if i == j else 0.0) - q * t[..., i] * t[..., j]
            for j in d2])
    block = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-3)
    n1, n2 = block.shape[-4], block.shape[-2]
    return block.reshape(block.shape[:-4] + (n1 * len(rows),
                                             n2 * (1 + len(d2))))


def build_covariance_matrix(cov: StationaryCovariance, points: torch.Tensor,
                            derivatives: Sequence[int]) -> torch.Tensor:
    """Training covariance K over (value + derivative) channels."""
    return build_block_covariance(cov, points, derivatives, points,
                                  derivatives)


def hyperparameter_grad_covariance_matrix(
        cov: StationaryCovariance, points: torch.Tensor,
        derivatives: Sequence[int]) -> torch.Tensor:
    """dK/dtheta of an unbatched kernel over (value + derivative) channels,
    (1 + dim, N, N), by forward-mode autograd of the block builder
    (``torch.func.jacfwd``)."""
    jac = torch.func.jacfwd(lambda h: build_covariance_matrix(
        type(cov)(hyperparameters=h), points, derivatives))(
            cov.hyperparameters)                       # (N, N, 1 + dim)
    return torch.movedim(jac, -1, 0)


def noise_diagonal(noise_variance, point_noise, batch, n: int, c: int,
                   like: torch.Tensor) -> torch.Tensor:
    """The diagonal noise of an n-point, c-channel system, (batch + (n c,)):
    the per-channel ``noise_variance`` (..., c) tiled over the points, plus
    ``point_noise`` (..., n, c) per point and channel when given."""
    kw = dict(dtype=like.dtype, device=like.device)
    nv = torch.as_tensor(noise_variance, **kw)
    diag = torch.broadcast_to(nv, batch + (c,))[..., None, :].expand(
        batch + (n, c))
    if point_noise is not None:
        diag = diag + torch.as_tensor(point_noise, **kw)
    return torch.broadcast_to(diag, batch + (n, c)).reshape(batch + (n * c,))


# Kernel C's switch, the module-wide counterpart of the JAX package's
# ``use_pallas`` argument: "auto" takes the covariance kernel where
# :func:`uses_covariance_kernel` allows it, "never" the plain build.  The
# fit's programs read it when they are captured, so its value is part of
# every program's key (``programs.keyed_switch``).
USE_PALLAS = "auto"
programs.keyed_switch("covariance.USE_PALLAS", lambda: USE_PALLAS)


def uses_covariance_kernel(device_type: str, dtype: torch.dtype,
                           derivatives: Sequence[int],
                           kernel_name: str) -> bool:
    """Kernel C's gate: CUDA, float32, value channels only, a kernel it
    knows, ``USE_PALLAS`` "auto"."""
    return config.switch_on("covariance.USE_PALLAS", USE_PALLAS) and \
        device_type == "cuda" and dtype == torch.float32 and \
        not channels(derivatives) and kernel_name in COVARIANCE_TYPES


def build_covariance_matrix_with_noise(
        cov: StationaryCovariance, points: torch.Tensor,
        derivatives: Sequence[int], noise_variance,
        point_noise: Optional[torch.Tensor] = None,
        use_pallas: str = "auto") -> torch.Tensor:
    """K + diag(noise) over channels.

    ``points`` is (n, d), shared by every kernel of the batch;
    ``noise_variance`` is per channel, (..., 1 + m) with the
    hyperparameters' batch axes (or broadcastable to them), tiled over the
    points; ``point_noise`` (n, 1 + m), or with batch axes, is added per
    point and channel (the shape-bucketing mechanism).  ``use_pallas``,
    the JAX package's per-call switch: "never" takes the plain build,
    "auto" kernel C where :func:`uses_covariance_kernel` allows it (which
    also reads ``USE_PALLAS``); any other value raises ``ValueError``.
    Returns (..., N, N), N = n (1 + m).
    """
    ds = channels(derivatives)
    h = cov.hyperparameters
    batch = h.shape[:-1]
    n = points.shape[0]
    diag = noise_diagonal(noise_variance, point_noise, batch, n,
                          1 + len(ds), points)
    if config.switch_on("use_pallas", use_pallas) and \
            uses_covariance_kernel(points.device.type, points.dtype, ds,
                                   cov.name):
        k = kernels.covariance_with_noise(
            points.contiguous(), h.reshape(-1, h.shape[-1]).contiguous(),
            diag.reshape(-1, n).contiguous(), cov.name)
        return k.reshape(batch + (n, n))
    return build_covariance_matrix(cov, points, ds) + torch.diag_embed(diag)
