"""Numerics constants and device/dtype helpers.

Counterpart of ``cornell_moe_tpu/config.py``.  Every function of the port
works in the dtype and on the device of its inputs; these helpers only pick
the defaults for entry points that create tensors from numpy data.
"""

from __future__ import annotations

import os

import torch

# Jitter on the diagonal of the union posterior covariance inside the MC-EI
# estimator (the reference's hard-coded 1.0e-6).
EI_VARIANCE_JITTER = 1.0e-6

# Minimum standard deviation guard of the analytic 1,0-EI formulas.
MINIMUM_STD_DEV = 1.0e-14

# Relative diagonal jitter (times the walker's amplitude) for the float32
# training-covariance Cholesky of the ensemble fit.
F32_CHOLESKY_JITTER = 1.0e-6


def default_device() -> torch.device:
    """``cuda:0``, or ``cuda:LOCAL_RANK`` on a rank of a ``torchrun``
    launch: the device of an entry point given none.  Raises
    ``RuntimeError`` when no CUDA card is present: the CPU is taken only
    when the caller asks for it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: pass device='cpu' to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def default_dtype(device) -> torch.dtype:
    """float32 on a CUDA device (the fast path), float64 on the CPU
    (the precision the parity tests hold the port to)."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64
