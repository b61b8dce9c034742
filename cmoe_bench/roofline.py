"""Least times of the port's counted work on one NVIDIA H100 SXM: a frozen
copy of ``chip_smoke.py``'s bound arithmetic and peaks, so that no later
change to the program moves the yardstick.

Peaks at the 700 W limit (data sheet, dense): float32 outside the tensor
cores, TF32 on the tensor cores, HBM, and the special-function (MUFU)
units, 16 per SM per clock on 132 SMs at 1.98 GHz; for work in float64,
float64 outside and on the tensor cores.  A bound is the largest of the
times its pipes need, since they run at once, so a share of it cannot
pass 100% while the work is counted as the algorithm needs it.

Work in float64 (``dtype`` "float64") counts its elements at 8 bytes, its
products on the float64 tensor cores, and its other operations, square
roots and exponentials among them at one operation each (fewer than the
card executes for them, so the least time stays a floor), at the float64
rate.
"""

from __future__ import annotations

FP32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12
MUFU_OPS = 16 * 132 * 1.98e9
FP64_FLOPS, FP64_MMA_FLOPS = 34e12, 67e12


def bound64(nbytes, ops=0.0, matmul=0.0) -> dict:
    """As :func:`bound` for work in float64: ops, float64 operations
    outside the tensor cores; matmul, FLOP of matrix products on them."""
    pipes = {"fp64": ops / FP64_FLOPS * 1e3,
             "fp64_mma": matmul / FP64_MMA_FLOPS * 1e3,
             "hbm": nbytes / HBM_BYTES * 1e3}
    pipe = max(pipes, key=pipes.get)
    return {"ms": pipes[pipe], "by": "bytes" if pipe == "hbm" else
            "operations", "pipe": pipe, "pipes_ms": pipes}


def bound(nbytes, fp32=0.0, matmul=0.0, mufu=0.0) -> dict:
    """The least time the card could take for a piece of work: the largest
    of its pipes' times.  fp32: float32 operations outside the tensor
    cores; matmul: FLOP of matrix products, at float32 accuracy on the
    tensor cores as 3xTF32 (three TF32 products each); mufu: special-
    function operations (sqrt, exp); nbytes: each input read once, each
    output written once, at the HBM rate.  Returns {"ms", "by" ("bytes" or
    "operations"), "pipe", "pipes_ms"}."""
    pipes = {"fp32": fp32 / FP32_FLOPS * 1e3,
             "tf32x3": 3 * matmul / TF32_FLOPS * 1e3,
             "mufu": mufu / MUFU_OPS * 1e3,
             "hbm": nbytes / HBM_BYTES * 1e3}
    pipe = max(pipes, key=pipes.get)
    return {"ms": pipes[pipe], "by": "bytes" if pipe == "hbm" else
            "operations", "pipe": pipe, "pipes_ms": pipes}


def mufu_per_field(kernel_name: str) -> int:
    """Special-function operations per field value: the Matern field's
    sqrt and exp, the squared exponential's exp."""
    return 2 if kernel_name == "matern_2.5" else 1


def block_ops(channels: int) -> int:
    """Operations per point pair beyond the value entry's, with
    ``channels`` (1 + m) channels a point: each further entry of the
    pair's (1 + m)^2 block at 2 (a field times a scaled difference, or a
    product of two and a subtraction), fewer than it takes, so the least
    time stays a floor; 0 for values alone."""
    return 2 * (channels * channels - 1)


def covariance_bound(s, n, d, kernel_name, dtype="float32",
                     channels=1) -> dict:
    """An ensemble's K + noise, (S, N, N), N = n channels: per point pair
    3d FP32 FLOP of distance, 8 of the field, 1 for the amplitude,
    :func:`block_ops` for the further channels' entries, and the field's
    MUFU operations (shared by a pair's block); the output dominates the
    bytes."""
    side = n * channels
    elements = s * side * side + n * d + s * (1 + d) + s * side
    ops, mufu = s * n * n * (3 * d + 9 + block_ops(channels)), \
        s * n * n * mufu_per_field(kernel_name)
    if dtype == "float64":
        return bound64(8 * elements, ops=ops + mufu)
    return bound(4 * elements, fp32=ops, mufu=mufu)


def lml_bound(w, np_, d, kernel_name, dtype="float32", channels=1) -> dict:
    """The log marginal likelihood of w walkers at Np (padded)
    observations of ``channels`` (1 + m) channels each, K's side N =
    Np channels: the K build (Np^2 (3d + 9 + :func:`block_ops`) FP32 FLOP
    and the field's MUFU operations), the Cholesky factorization (N^3 / 3
    FLOP, its trailing updates matrix products; N square roots), forward
    substitution (N^2 FLOP, Np^2 of them counted); the scaled points,
    amplitude, noise, y in and two values out."""
    side = np_ * channels
    elements = w * d * np_ + w + 2 * w * side + 2 * w
    ops, mufu = w * np_ * np_ * (3 * d + 10 + block_ops(channels)), w * (
        np_ * np_ * mufu_per_field(kernel_name) + side)
    if dtype == "float64":
        return bound64(8 * elements, ops=ops + mufu, matmul=w * side ** 3 / 3)
    return bound(4 * elements, fp32=ops, matmul=w * side ** 3 / 3, mufu=mufu)
