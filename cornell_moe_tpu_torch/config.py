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

# The low-precision fantasy solve of the batched KG estimator
# (``ops.linalg.fantasy_solves_rhs_grad_only(inv_chol_lowp=)``): L^-1 applied
# as a bfloat16 copy with float32 products, refined once against the float32
# factor.  The JAX package built it to halve the bytes of the fantasy
# solves, evaluated it, and rejected it as a default: one bf16 correction
# leaves va a small relative error, and the fantasy variance prior - va^T va,
# a difference far smaller than |va|^2 on a converged model, inherits it
# many times over, enough to move the KG pick.  "never" (the default) keeps
# the float32 solve; "always" takes the bf16 route for float32 inputs, so the
# route stays available and tested.  Any other value leaves it off: the JAX
# package turns it on by itself only on a TPU, which the port never runs on.
# The KG programs read it when they are captured, so its value is part of
# every program's key (``ops.programs.keyed_switch``).
KG_FANTASY_LOWP = "never"


def kg_fantasy_lowp_enabled(dtype) -> bool:
    """Whether the batched KG's fantasy solve takes the bf16 route for
    inputs of ``dtype``: only under ``KG_FANTASY_LOWP`` "always" and only
    for float32."""
    return KG_FANTASY_LOWP == "always" and dtype == torch.float32


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


def placement(device=None, dtype=None):
    """(device, dtype) of an entry point: ``device`` as given, else
    :func:`default_device`; ``dtype`` as given, else
    :func:`default_dtype` of that device."""
    device = default_device() if device is None else torch.device(device)
    return device, default_dtype(device) if dtype is None else dtype


SWITCH_VALUES = ("auto", "never")


def switch_on(name: str, value: str) -> bool:
    """A kernel or program switch (``LML_PALLAS``, ``DESCENT_PALLAS``,
    ``USE_PALLAS``, ``CAPTURE``): True for "auto", False for "never";
    any other value raises ``ValueError``.  "always" does not carry over
    from the JAX package: no CUDA kernel runs on a CPU tensor."""
    if value not in SWITCH_VALUES:
        raise ValueError(f"{name} must be one of {SWITCH_VALUES}, got "
                         f"{value!r}")
    return value == "auto"
