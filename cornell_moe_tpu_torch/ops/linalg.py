"""Dense linear-algebra primitives for the GP core.

Counterpart of ``cornell_moe_tpu/ops/linalg.py``.  Cholesky factors, solves
and matmuls go to ``torch.linalg`` / ``torch.matmul`` (full float32 on the
card: the package turns TF32 off at import).  Batched variants operate over
leading axes.

Failure convention: a factorization that fails returns NaNs, as JAX's
``jnp.linalg.cholesky`` does, so callers can test ``isfinite`` the same way
the reference package does.  On CUDA tensors :func:`cholesky` uses
``torch.linalg.cholesky_ex``, which reports failure in a tensor instead of
synchronizing with the host on every call.
"""

from __future__ import annotations

import torch


def add_jitter(matrix: torch.Tensor, jitter) -> torch.Tensor:
    """Add ``jitter`` (a float or a tensor broadcasting over the batch axes)
    to the diagonal of the (..., n, n) matrix."""
    n = matrix.shape[-1]
    eye = torch.eye(n, dtype=matrix.dtype, device=matrix.device)
    if isinstance(jitter, torch.Tensor):
        jitter = jitter[..., None, None]
    return matrix + jitter * eye


def cholesky(matrix: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Lower Cholesky factor with optional diagonal jitter; NaN on failure."""
    if isinstance(jitter, torch.Tensor) or jitter:
        matrix = add_jitter(matrix, jitter)
    chol, info = torch.linalg.cholesky_ex(matrix)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def solve_triangular(chol: torch.Tensor, rhs: torch.Tensor, *,
                     lower: bool = True, trans: bool = False
                     ) -> torch.Tensor:
    """Solve ``L x = rhs`` (or ``L^T x = rhs`` with ``trans``)."""
    if trans:
        return torch.linalg.solve_triangular(
            chol.transpose(-1, -2), rhs, upper=lower)
    return torch.linalg.solve_triangular(chol, rhs, upper=not lower)


def _as_matrix(rhs: torch.Tensor, ndim_chol: int):
    """Vector right-hand sides become one-column matrices."""
    if rhs.dim() == ndim_chol - 1:
        return rhs[..., None], True
    return rhs, False


def cho_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = rhs`` given the lower Cholesky factor of A."""
    b, vec = _as_matrix(rhs, chol.dim())
    y = solve_triangular(chol, b, lower=True)
    x = solve_triangular(chol, y, lower=True, trans=True)
    return x[..., 0] if vec else x


def log_det_from_chol(chol: torch.Tensor) -> torch.Tensor:
    """log det(A) = 2 * sum(log(diag(L))) for A = L L^T."""
    return 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def spd_solve(matrix: torch.Tensor, rhs: torch.Tensor, jitter=0.0
              ) -> torch.Tensor:
    """Solve an SPD system through its Cholesky factor (with optional
    diagonal jitter); NaN where the factorization fails."""
    return cho_solve(cholesky(matrix, jitter=jitter), rhs)


def batched_cholesky(matrices: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Cholesky over leading batch axes (the hyperparameter ensemble's):
    :func:`cholesky`, NaN for each matrix whose factorization fails."""
    return cholesky(matrices, jitter=jitter)


def solve_lower_with_refinement(chol: torch.Tensor, inv_chol: torch.Tensor,
                                rhs: torch.Tensor, iterations: int = 1
                                ) -> torch.Tensor:
    """L x = rhs via explicit-inverse matmul + iterative refinement."""
    x = inv_chol @ rhs
    for _ in range(iterations):
        r = rhs - chol @ x
        x = x + inv_chol @ r
    return x


def cho_solve_with_refinement(chol: torch.Tensor, inv_chol: torch.Tensor,
                              rhs: torch.Tensor, iterations: int = 1
                              ) -> torch.Tensor:
    """(L L^T) x = rhs via Gram matmuls + iterative refinement."""
    inv_t = inv_chol.transpose(-1, -2)

    def apply_inv(b):
        return inv_t @ (inv_chol @ b)

    x = apply_inv(rhs)
    for _ in range(iterations):
        r = rhs - chol @ (chol.transpose(-1, -2) @ x)
        x = x + apply_inv(r)
    return x


class _FantasySolves(torch.autograd.Function):
    """(va, w) = (refined L^-1 rhs, L^-T va) with the 2-matmul backward.

    Forward: va keeps one residual refinement; w applies the explicit
    inverse transpose once.  Backward transposes the unrefined operators:

        ct_va_total = ct_va + L^-1 ct_w
        ct_rhs      = L^-T ct_va_total

    and gives the factors zero gradient by contract.
    """

    @staticmethod
    def forward(ctx, chol, inv_chol, rhs):
        va = solve_lower_with_refinement(chol, inv_chol, rhs)
        w = inv_chol.transpose(-1, -2) @ va
        ctx.save_for_backward(inv_chol)
        return va, w

    @staticmethod
    def backward(ctx, ct_va, ct_w):
        (inv_chol,) = ctx.saved_tensors
        ct_va_total = ct_va + inv_chol @ ct_w
        ct_rhs = inv_chol.transpose(-1, -2) @ ct_va_total
        return None, None, ct_rhs


def _bdot(a_lowp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a_lowp @ b with b rounded to a_lowp's dtype (bfloat16) and every
    product and sum in float32, the result float32 (the JAX package's
    ``preferred_element_type=jnp.float32``).  On the card one
    ``torch.bmm(..., out_dtype=torch.float32)`` over the flattened batch
    (a refusal raises); on the CPU, which has no such product, the rounded
    operands multiply as float32, where each product of two bfloat16 values
    is exact."""
    b = b.to(a_lowp.dtype)
    if a_lowp.device.type != "cuda":
        return torch.matmul(a_lowp.float(), b.float())
    lead = torch.broadcast_shapes(a_lowp.shape[:-2], b.shape[:-2])
    a3 = a_lowp.expand(lead + a_lowp.shape[-2:]).reshape(
        (-1,) + a_lowp.shape[-2:])
    b3 = b.expand(lead + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=torch.float32)
    return out.reshape(lead + out.shape[-2:])


class _FantasySolvesMixed(torch.autograd.Function):
    """:class:`_FantasySolves` with L^-1 applied as a bfloat16 copy
    (:func:`_bdot`: float32 products and sums):

        va0 = L^-1_bf16 rhs_bf16
        r   = rhs - L va0                 (float32, full precision)
        va  = va0 + L^-1_bf16 r_bf16
        w   = L^-T_bf16 va_bf16

    The float32 residual measures va0's rounding error and the correction
    takes most of it out, so va keeps about the square of the bfloat16
    product error; w carries that error once.  Backward, with the same
    bfloat16 operators transposed:

        ct_va_total = ct_va + L^-1_bf16 ct_w
        ct_rhs      = L^-T_bf16 ct_va_total

    and the factors get zero gradient by contract.
    """

    @staticmethod
    def forward(ctx, chol, inv_chol_lowp, rhs):
        va0 = _bdot(inv_chol_lowp, rhs)
        r = rhs - chol @ va0
        va = va0 + _bdot(inv_chol_lowp, r)
        w = _bdot(inv_chol_lowp.transpose(-1, -2), va)
        ctx.save_for_backward(inv_chol_lowp)
        return va, w

    @staticmethod
    def backward(ctx, ct_va, ct_w):
        (inv_chol_lowp,) = ctx.saved_tensors
        ct_va_total = ct_va + _bdot(inv_chol_lowp, ct_w)
        ct_rhs = _bdot(inv_chol_lowp.transpose(-1, -2), ct_va_total)
        return None, None, ct_rhs


def fantasy_solves_rhs_grad_only(chol: torch.Tensor, inv_chol: torch.Tensor,
                                 rhs: torch.Tensor,
                                 inv_chol_lowp: torch.Tensor = None):
    """(va, w) = (refined L^-1 rhs, K^-1 rhs); gradients flow via rhs ONLY.

    ``chol`` and ``inv_chol`` are treated as constants (detached here), as
    in the reference's ``fantasy_solves_rhs_grad_only``.  With
    ``inv_chol_lowp`` (a bfloat16 copy of ``inv_chol``; float32 ``chol``
    and ``rhs``) the pair takes the mixed-precision chain of
    :class:`_FantasySolvesMixed`, and ``inv_chol`` is not read.
    """
    if inv_chol_lowp is None:
        return _FantasySolves.apply(chol.detach(), inv_chol.detach(), rhs)
    return _FantasySolvesMixed.apply(chol.detach(), inv_chol_lowp.detach(),
                                     rhs)


def cholesky_small(a: torch.Tensor, max_unrolled: int = 16) -> torch.Tensor:
    """Cholesky of tiny SPD matrices (..., k, k), unrolled column by column.

    Elementwise over the batch, so autograd gives the textbook Cholesky
    derivative chain; falls back to :func:`cholesky` for larger k.
    """
    k = a.shape[-1]
    if k > max_unrolled:
        return cholesky(a)
    zero = torch.zeros_like(a[..., 0, 0])
    col: list[list] = [[None] * k for _ in range(k)]
    for j in range(k):
        s = a[..., j, j]
        for p in range(j):
            s = s - col[j][p] * col[j][p]
        d = torch.sqrt(s)
        col[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, k):
            s = a[..., i, j]
            for p in range(j):
                s = s - col[i][p] * col[j][p]
            col[i][j] = s * inv_d
    rows = [torch.stack([col[i][j] if j <= i else zero for j in range(k)],
                        dim=-1) for i in range(k)]
    return torch.stack(rows, dim=-2)


def solve_triangular_small(l: torch.Tensor, rhs: torch.Tensor, *,
                           trans: bool = False,
                           max_unrolled: int = 16) -> torch.Tensor:
    """Solve L x = rhs (or L^T x = rhs) for tiny lower-triangular L.

    ``l`` is (..., k, k), ``rhs`` is (..., k, m); substitution is unrolled
    into k batched elementwise steps.
    """
    k = l.shape[-1]
    if k > max_unrolled:
        return solve_triangular(l, rhs, lower=True, trans=trans)
    x: list = [None] * k
    order = range(k) if not trans else range(k - 1, -1, -1)
    for j in order:
        s = rhs[..., j, :]
        if not trans:
            for p in range(j):
                s = s - l[..., j, p, None] * x[p]
        else:
            for p in range(j + 1, k):
                s = s - l[..., p, j, None] * x[p]
        x[j] = s / l[..., j, j, None]
    return torch.stack(x, dim=-2)


def symmetrize(matrix: torch.Tensor) -> torch.Tensor:
    return 0.5 * (matrix + matrix.transpose(-1, -2))


def chol_update_append(chol: torch.Tensor, cross_cov: torch.Tensor,
                       new_block: torch.Tensor) -> torch.Tensor:
    """Grow a Cholesky factor when appending rows/cols to an SPD matrix.

    Given L (..., n, n) with A = L L^T, the cross-covariance B (..., n, q)
    and the new diagonal block C (..., q, q), returns the (..., n+q, n+q)
    lower factor of [[A, B], [B^T, C]] without refactorizing A:

        L' = [[L, 0], [S^T, chol(C - S^T S)]],  S = L^-1 B.
    """
    s = solve_triangular(chol, cross_cov, lower=True)            # (.., n, q)
    s_t = s.transpose(-1, -2)
    chol_schur = cholesky(new_block - s_t @ s)
    top = torch.cat([chol, torch.zeros_like(s)], dim=-1)
    return torch.cat([top, torch.cat([s_t, chol_schur], dim=-1)], dim=-2)


def lower_triangular_only(matrix: torch.Tensor) -> torch.Tensor:
    """Zero the strict upper triangle (ZeroUpperTriangle counterpart)."""
    return torch.tril(matrix)
