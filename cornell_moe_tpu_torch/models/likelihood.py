"""GP log marginal likelihood (value channels).

Counterpart of ``log_marginal_likelihood`` in
``cornell_moe_tpu/models/likelihood.py``:

    LML = -1/2 y^T K^-1 y - 1/2 log det K - n/2 log 2 pi.

This is the plain path (always the plain covariance matrix, Cholesky and
solves), differentiable, and the oracle of the fused LML kernel
(``ops.kernels.lml_fused``).  The covariance's hyperparameters may carry
batch axes; the result then has those axes.
"""

from __future__ import annotations

import math

import torch

from cornell_moe_tpu_torch.models.covariance import StationaryCovariance
from cornell_moe_tpu_torch.ops import kernels, linalg


def log_marginal_likelihood(covariance: StationaryCovariance,
                            noise_variance, points, values,
                            derivatives=(), point_noise=None
                            ) -> torch.Tensor:
    """Zero-mean LML; ``point_noise`` (n, 1) adds per-point noise
    (shape-bucket padding shifts the LML by a theta-independent constant).
    """
    if len(tuple(derivatives)):
        raise NotImplementedError("value channels only")
    x = torch.as_tensor(points)
    y = torch.as_tensor(values, dtype=x.dtype, device=x.device).reshape(-1)
    n = x.shape[0]
    h = covariance.hyperparameters
    batch = h.shape[:-1]
    noise_vec = torch.as_tensor(noise_variance, dtype=x.dtype,
                                device=x.device).reshape(batch + (1,))
    noise_vec = noise_vec.expand(batch + (n,))
    if point_noise is not None:
        noise_vec = noise_vec + torch.as_tensor(point_noise).reshape(n)
    k = kernels.covariance_with_noise_plain(
        x, h.reshape(-1, h.shape[-1]), noise_vec.reshape(-1, n),
        covariance.name).reshape(batch + (n, n))
    chol = linalg.cholesky(k)
    alpha = linalg.cho_solve(chol, y.expand(batch + (n,)))
    return (-0.5 * torch.sum(y * alpha, dim=-1)
            - 0.5 * linalg.log_det_from_chol(chol)
            - 0.5 * n * math.log(2.0 * math.pi))
