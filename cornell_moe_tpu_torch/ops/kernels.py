"""The hand-written CUDA kernels of the port, their plain PyTorch versions,
and their launch counts.

Four kernels, each the Hopper counterpart of one Pallas kernel of
``cornell_moe_tpu/ops/pallas_kernels.py``, and one that replaces none
(sources in ``csrc/``):

* :func:`descent_run` — the KG inner posterior-mean descent, every
  (ensemble member, union, MC draw) at once, in two instances chosen by
  shape (:func:`descent_run_instance`): the moment contraction on the
  tensor cores in 3xTF32 (``csrc/descent_run_mma.cu``) where the Wr moment
  rows fit one 16-row tile, and the FMA instance
  (``csrc/descent_run.cu``, :func:`descent_run_fma`) above that.
* :func:`descent_grad` — one ascent direction of that descent per launch
  (the per-step route, where ``optimizers.gradient_ascent_batch`` takes the
  steps), in two instances chosen by the same rule
  (:func:`descent_grad_instance`): the tensor-core one
  (``csrc/descent_grad_mma.cu``), which shares its staging and contraction
  with descent_run's (``csrc/field_mma.cuh``), and the FMA one
  (``csrc/descent_grad.cu``, :func:`descent_grad_fma`), which shares its
  field gradient with descent_run_fma (``csrc/field_grad.cuh``).
* :func:`lml_fused` (``csrc/lml_fused.cu``) — K build + Cholesky + forward
  substitution + (quad, logdet) per MCMC walker: one thread-block cluster
  per walker with K in distributed shared memory, and above the clusters'
  capacity the same cluster kernel with K in an L2-resident global
  scratch, :func:`lml_fused_global`; in float32 or float64, the inputs'
  dtype (the only kernel with a float64 instance).
* :func:`covariance_with_noise` (``csrc/covariance_with_noise.cu``) —
  K + diag(noise) for every member of the GP ensemble, each pair of 64 x 64
  tiles computed once and written twice (K is symmetric bit for bit).
* :func:`lml_chol_f64` (``csrc/lml_chol_f64.cu``) — the LML's (quad,
  half logdet) of a few large float64 systems K already assembled, by a
  tiled Cholesky factorization in place on the FP64 tensor cores with the
  forward solve riding in it: the float64 chain's route where kernel B's
  gate is closed (derivative channels, more than 896 observations).

The main path (``BayesianOptimizer(method="KG")``) launches descent_run,
lml_fused and covariance_with_noise; descent_grad serves the per-step
route only.

Wrapper rule: a CPU tensor goes to the plain version, a CUDA tensor launches
the kernel or raises (wrong dtype, layout or shape, an input that requires
grad, a failed launch).  A, C and D take float32; B float32 or float64;
lml_chol_f64 float64.  There is no fallback.  None of the five sits under
a gradient, so none has a backward kernel.

Each wrapper adds one to its launch counter where it launches its kernel
and nowhere else, the counter ``kernels.<name>`` of the port's registry
(``utils.logging_utils.count``): ``lml_fused`` counts B's cluster
instance, ``lml_fused_global`` its large-Np instance, ``lml_fused_f64``
and ``lml_fused_global_f64`` the same two in float64, ``descent_run`` A's
tensor-core instance and ``descent_run_fma`` its FMA instance,
``descent_grad`` D's tensor-core instance and ``descent_grad_fma`` its FMA
instance, ``lml_chol_f64`` the tiled Cholesky.  A reader takes their
growth from a snapshot (``logging_utils.growth``).  A replayed CUDA graph
(``ops.programs``) runs no wrapper: the program adds the growth of the
registry it recorded at capture at each replay.
"""

from __future__ import annotations

import functools

import torch

from cornell_moe_tpu_torch.ops.domains import box_limit_update
from cornell_moe_tpu_torch.utils import logging_utils

KERNEL_CODES = {"matern_2.5": 0, "square_exponential": 1}


def _unit_fields(kernel_name: str):
    from cornell_moe_tpu_torch.models.covariance import COVARIANCE_TYPES
    return COVARIANCE_TYPES[kernel_name]


def _on_card(name: str, kernel_name, dtypes=(torch.float32,),
             **tensors) -> bool:
    """Validate a wrapper's inputs; True to launch, False for the plain
    version (CPU tensors).  On the card the inputs share one dtype of
    ``dtypes``.  ``kernel_name`` None: the kernel evaluates no covariance
    field."""
    if kernel_name is not None and kernel_name not in KERNEL_CODES:
        raise ValueError(f"{name}: unknown kernel {kernel_name!r}")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    for arg, t in tensors.items():
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: input {arg!r} requires grad, but the kernel has "
                "no backward")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    first = next(iter(tensors.values())).dtype
    for arg, t in tensors.items():
        if t.dtype not in dtypes or t.dtype != first:
            raise TypeError(f"{name}: {arg!r} must be one of {dtypes} and "
                            f"match the other inputs' {first}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg!r} must be contiguous")
    return True


def _expect(name: str, arg: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg!r} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _launch(name: str, fn, *args, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _lib():
    from cornell_moe_tpu_torch.ops import _build
    return _build.library()


# ---------------------------------------------------------------------------
# C: covariance + noise
# ---------------------------------------------------------------------------

def covariance_with_noise(points: torch.Tensor, hypers: torch.Tensor,
                          noise: torch.Tensor,
                          kernel_name: str = "matern_2.5") -> torch.Tensor:
    """alpha_s k(x / l_s, x / l_s) + diag(noise_s) for S kernels.

    points (n, d), hypers (S, 1 + d) = [alpha, lengths], noise (S, n) total
    per-point diagonal noise.  Returns (S, n, n).
    """
    name = "covariance_with_noise"
    if not _on_card(name, kernel_name, points=points, hypers=hypers,
                    noise=noise):
        return covariance_with_noise_plain(points, hypers, noise,
                                           kernel_name)
    n, d = points.shape
    s = hypers.shape[0]
    _expect(name, "hypers", hypers, (s, 1 + d))
    _expect(name, "noise", noise, (s, n))
    out = torch.empty((s, n, n), device=points.device, dtype=torch.float32)
    _launch(name, _lib().cmoe_covariance_with_noise, points.data_ptr(),
            hypers.data_ptr(), noise.data_ptr(), out.data_ptr(), s, n, d,
            KERNEL_CODES[kernel_name], device=points.device)
    logging_utils.count("kernels.covariance_with_noise")
    return out


def covariance_with_noise_plain(points, hypers, noise,
                                kernel_name="matern_2.5"):
    """Plain version of :func:`covariance_with_noise`: the value-channel
    ``build_block_covariance`` plus the noise diagonal."""
    from cornell_moe_tpu_torch.models import covariance as cov_mod
    cov = cov_mod.COVARIANCE_TYPES[kernel_name](hyperparameters=hypers)
    k = cov_mod.build_block_covariance(cov, points, (), points, ())
    return k + torch.diag_embed(noise)


# ---------------------------------------------------------------------------
# B: fused LML (K build + Cholesky + forward substitution + logdet)
# ---------------------------------------------------------------------------

LML_PANEL = 32             # csrc/lml_fused.cu LML_PANEL
LML_CLUSTER = 8            # CTAs per walker, csrc/lml_fused.cu LML_CLUSTER
SMEM_PER_BLOCK = 232_448   # shared memory one H100 block may opt into


def lml_cta_tiles(np_: int, cluster: int = LML_CLUSTER) -> int:
    """32 x 32 tiles of K's lower triangle in the fullest CTA at Np: CTA r
    holds tile rows r, r + cluster, ..., tile row i holding i + 1 tiles."""
    nt = -(-np_ // LML_PANEL)
    return max(sum(i + 1 for i in range(r, nt, cluster))
               for r in range(cluster))


def lml_layout_bytes(np_: int, itemsize: int = 4, cluster: int = LML_CLUSTER,
                     tiles_on_chip: bool = True,
                     pbuf_on_chip: bool = True) -> int:
    """Shared memory of each CTA in bytes, at ``itemsize`` bytes an element
    (``lml_layout`` in ``csrc/lml_fused.cu``): the fullest CTA's tiles of
    K and the panel column (Np - 32 rows), each where it is on chip, then
    L11, z, its y slices and a 4-element carry."""
    nt = -(-np_ // LML_PANEL)
    tiles = lml_cta_tiles(np_, cluster) if tiles_on_chip else 0
    pbuf = max(nt - 1, 0) if pbuf_on_chip else 0
    return itemsize * ((tiles + pbuf) * LML_PANEL ** 2 +
                       LML_PANEL * (LML_PANEL + 1) + LML_PANEL +
                       len(range(0, nt, cluster)) * LML_PANEL + 4)


def lml_cluster_smem_bytes(np_: int, cluster: int = LML_CLUSTER,
                           itemsize: int = 4) -> int:
    """Shared memory of each CTA of the cluster instance at Np: K's tiles
    and the panel column both on chip."""
    return lml_layout_bytes(np_, itemsize, cluster)


def lml_global_pbuf_on_chip(np_: int, itemsize: int = 4) -> bool:
    """Whether the large-Np instance keeps its panel column in shared
    memory at Np (up to Np = 1792 in float32, 896 in float64); above, it
    joins K in the scratch."""
    return lml_layout_bytes(np_, itemsize, tiles_on_chip=False) <= \
        SMEM_PER_BLOCK


def lml_global_smem_bytes(np_: int, itemsize: int = 4) -> int:
    """Shared memory of each CTA of the large-Np instance at Np."""
    return lml_layout_bytes(np_, itemsize, tiles_on_chip=False,
                            pbuf_on_chip=lml_global_pbuf_on_chip(np_,
                                                                 itemsize))


def lml_global_scratch_floats(np_: int, itemsize: int = 4) -> int:
    """The large-Np instance's global scratch per walker, in elements of
    ``itemsize`` bytes: a region of the fullest CTA's tile count for each
    of its 8 CTAs, and the panel column's Np - 32 rows where they are off
    chip."""
    nt = -(-np_ // LML_PANEL)
    pbuf = 0 if lml_global_pbuf_on_chip(np_, itemsize) else max(nt - 1, 0)
    return (LML_CLUSTER * lml_cta_tiles(np_) + pbuf) * LML_PANEL ** 2


@functools.lru_cache(maxsize=None)
def lml_cluster_capacity(cluster: int = LML_CLUSTER,
                         itemsize: int = 4) -> int:
    """Largest Np the cluster instance takes: its fullest CTA must fit in
    one block's shared memory (640 in float32, 384 in float64)."""
    np_ = LML_PANEL
    while lml_cluster_smem_bytes(np_ + LML_PANEL, cluster,
                                 itemsize) <= SMEM_PER_BLOCK:
        np_ += LML_PANEL
    return np_


LML_CLUSTER_CAPACITY = lml_cluster_capacity()


def lml_fused_instance(np_: int, itemsize: int = 4) -> str:
    """Which instance of kernel B the wrapper launches at Np and
    ``itemsize`` (4: float32, 8: float64): ``"cluster"`` (K in distributed
    shared memory) up to :func:`lml_cluster_capacity`, ``"global"`` (K in
    global scratch) above it."""
    return "cluster" if np_ <= lml_cluster_capacity(itemsize=itemsize) \
        else "global"


def _lml_shapes(name, us, alpha, noise, y, n_real, kernel_name):
    """None for CPU tensors (the plain version), else (W, d, Np)."""
    if not _on_card(name, kernel_name, (torch.float32, torch.float64),
                    us=us, alpha=alpha, noise=noise, y=y):
        return None
    w, d, np_ = us.shape
    _expect(name, "alpha", alpha, (w,))
    _expect(name, "noise", noise, (w, np_))
    _expect(name, "y", y, (w, np_))
    if not 0 < n_real <= np_:
        raise ValueError(f"{name}: n_real {n_real} outside (0, {np_}]")
    return w, d, np_


def _f64(t: torch.Tensor) -> str:
    """The suffix of B's float64 entry points and counters."""
    return "_f64" if t.dtype == torch.float64 else ""


def lml_fused(us: torch.Tensor, alpha: torch.Tensor, noise: torch.Tensor,
              y: torch.Tensor, n_real: int,
              kernel_name: str = "matern_2.5"):
    """(y^T K^-1 y, sum log diag chol K) per walker, summed over the first
    ``n_real`` rows only.

    us (W, d, Np) scaled points, alpha (W,), noise (W, Np) total diagonal
    noise, y (W, Np), all float32 or all float64.  K_w = alpha_w k(us_w) +
    diag(noise_w).  Any Np.  Returns (quad (W,), logdet (W,)) in the
    inputs' dtype; NaN where the factorization fails.

    Two instances of kernel B, chosen by Np and the dtype alone
    (:func:`lml_fused_instance`), both one 8-CTA cluster per walker with
    the same arithmetic: up to :func:`lml_cluster_capacity` (640 in
    float32, 384 in float64) the cluster instance, K in distributed shared
    memory and no scratch; above it :func:`lml_fused_global`, K in an
    L2-resident global scratch.  Float64 inputs launch the float64
    instances, float64 throughout.
    """
    name = "lml_fused"
    shapes = _lml_shapes(name, us, alpha, noise, y, n_real, kernel_name)
    if shapes is None:
        return lml_fused_plain(us, alpha, noise, y, n_real, kernel_name)
    w, d, np_ = shapes
    if lml_fused_instance(np_, us.element_size()) == "global":
        return lml_fused_global(us, alpha, noise, y, n_real, kernel_name)
    dev, suffix = us.device, _f64(us)
    quad = torch.empty((w,), device=dev, dtype=us.dtype)
    logdet = torch.empty((w,), device=dev, dtype=us.dtype)
    _launch(name, getattr(_lib(), "cmoe_lml_fused_cluster" + suffix),
            us.data_ptr(), alpha.data_ptr(), noise.data_ptr(), y.data_ptr(),
            quad.data_ptr(), logdet.data_ptr(), w, d, np_, int(n_real),
            KERNEL_CODES[kernel_name], device=dev)
    logging_utils.count("kernels.lml_fused" + suffix)
    return quad, logdet


def lml_fused_global(us: torch.Tensor, alpha: torch.Tensor,
                     noise: torch.Tensor, y: torch.Tensor, n_real: int,
                     kernel_name: str = "matern_2.5"):
    """Kernel B's large-Np instance at any Np: the cluster instance's
    kernel with K's tiles in a global scratch of
    :func:`lml_global_scratch_floats` elements per walker (12.6 MB at W =
    8, Np = 768 in float32, and at Np = 512 in float64), which the 50 MB L2
    holds, and the panel column on chip up to Np = 1792 (896 in float64).
    Equal to the cluster instance bit for bit where both run.
    :func:`lml_fused` takes it above the cluster capacity; arguments and
    results as there."""
    name = "lml_fused_global"
    shapes = _lml_shapes(name, us, alpha, noise, y, n_real, kernel_name)
    if shapes is None:
        return lml_fused_plain(us, alpha, noise, y, n_real, kernel_name)
    w, d, np_ = shapes
    dev, suffix = us.device, _f64(us)
    scratch = torch.empty(
        (w, lml_global_scratch_floats(np_, us.element_size())), device=dev,
        dtype=us.dtype)
    quad = torch.empty((w,), device=dev, dtype=us.dtype)
    logdet = torch.empty((w,), device=dev, dtype=us.dtype)
    _launch(name, getattr(_lib(), "cmoe_lml_fused_global" + suffix),
            us.data_ptr(), alpha.data_ptr(), noise.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), quad.data_ptr(), logdet.data_ptr(), w, d,
            np_, int(n_real), KERNEL_CODES[kernel_name], device=dev)
    logging_utils.count("kernels.lml_fused_global" + suffix)
    return quad, logdet


def lml_cluster_occupancy(w: int, np_: int,
                          cluster: int = LML_CLUSTER) -> int:
    """cudaOccupancyMaxActiveClusters of the float32 cluster kernel for W
    walkers at Np with clusters of ``cluster`` CTAs (above 8: the
    non-portable size) on the current card."""
    import ctypes
    out = ctypes.c_int(0)
    rc = _lib().cmoe_lml_fused_cluster_occupancy(
        w, cluster, lml_cluster_smem_bytes(np_, cluster), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"lml_cluster_occupancy: CUDA error {rc}")
    return out.value


def lml_global_occupancy(w: int, np_: int, itemsize: int = 4) -> int:
    """cudaOccupancyMaxActiveClusters of the large-Np instance for W
    walkers at Np and ``itemsize`` on the current card."""
    import ctypes
    out = ctypes.c_int(0)
    entry = "cmoe_lml_fused_global_occupancy" + (
        "_f64" if itemsize == 8 else "")
    rc = getattr(_lib(), entry)(w, np_, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"lml_global_occupancy: CUDA error {rc}")
    return out.value


def lml_fused_plain(us, alpha, noise, y, n_real, kernel_name="matern_2.5"):
    """Plain version of :func:`lml_fused`: K build, ``cholesky_ex`` and a
    triangular solve, masked to ``n_real``."""
    diff = us[:, :, :, None] - us[:, :, None, :]
    s = torch.sum(diff * diff, dim=1)
    k = alpha[:, None, None] * _unit_fields(kernel_name).unit_f0(s) + \
        torch.diag_embed(noise)
    chol, info = torch.linalg.cholesky_ex(k)
    z = torch.linalg.solve_triangular(chol, y[..., None], upper=False)[..., 0]
    mask = (torch.arange(us.shape[-1], device=us.device) < n_real).to(
        us.dtype)
    quad = torch.sum(z * z * mask, dim=-1)
    logdet = torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)) * mask, dim=-1)
    bad = info != 0
    nan = torch.full_like(quad, float("nan"))
    return torch.where(bad, nan, quad), torch.where(bad, nan, logdet)


# ---------------------------------------------------------------------------
# The tiled float64 Cholesky of the chain's plain-route LML
# ---------------------------------------------------------------------------

CHOL_TILE = 64             # csrc/lml_chol_f64.cu CHOL_T


def lml_chol_scratch(w: int, n: int) -> tuple:
    """The kernel's scratch at W walkers of side n (``csrc/lml_chol_f64.cu``):
    (doubles, ints).  Per walker and tile column, L_jj^-1 (64 x 64), z_j and
    the border b_j (64 each) and the column's two sums; the tiles' counters
    and the task queue, which start at zero."""
    nt = -(-n // CHOL_TILE)
    return (w * nt * (CHOL_TILE * CHOL_TILE + 2 * CHOL_TILE + 2),
            w * nt * nt + 1)


def lml_chol_f64(k: torch.Tensor, y: torch.Tensor):
    """(quad, half_logdet) of the systems K_w = L_w L_w^T: quad_w =
    |L_w^-1 y_w|^2 and half_logdet_w = sum_i log (L_w)_ii, each (W,).

    k (W, N, N) holds K + diag(noise), of which only the lower triangle is
    read; y is (N,) or (W, N).  NaN for a walker whose factorization meets
    a pivot that is not positive and finite.  On the card, k and y are
    float64 and contiguous, and k is factored in place (its lower triangle
    holds L_w on return): one launch of the tiled Cholesky
    (``csrc/lml_chol_f64.cu``), whose border row carries the forward solve,
    so no transposed solve runs.  CPU tensors take :func:`lml_chol_plain`,
    which leaves k as it is.
    """
    name = "lml_chol_f64"
    if k.dim() != 3 or k.shape[1] != k.shape[2]:
        raise ValueError(f"{name}: k must be (W, N, N), got "
                         f"{tuple(k.shape)}")
    w, n = k.shape[0], k.shape[-1]
    if tuple(y.shape) not in ((n,), (w, n)):
        raise ValueError(f"{name}: y has shape {tuple(y.shape)}, expected "
                         f"({n},) or ({w}, {n})")
    if not _on_card(name, None, (torch.float64,), k=k, y=y):
        return lml_chol_plain(k, y)
    dev = k.device
    doubles, ints = lml_chol_scratch(w, n)
    scratch = torch.empty((doubles,), device=dev, dtype=torch.float64)
    counters = torch.zeros((ints,), device=dev, dtype=torch.int32)
    nt = -(-n // CHOL_TILE)
    linv, zbuf, bbuf, quadp, ldp = scratch.split(
        [w * nt * CHOL_TILE * CHOL_TILE, w * nt * CHOL_TILE,
         w * nt * CHOL_TILE, w * nt, w * nt])
    quad = torch.empty((w,), device=dev, dtype=torch.float64)
    half_logdet = torch.empty((w,), device=dev, dtype=torch.float64)
    _launch(name, _lib().cmoe_lml_chol_f64, k.data_ptr(), y.data_ptr(),
            n if y.dim() == 2 else 0, linv.data_ptr(), zbuf.data_ptr(),
            bbuf.data_ptr(), quadp.data_ptr(), ldp.data_ptr(),
            counters.data_ptr(), quad.data_ptr(), half_logdet.data_ptr(), w,
            n, device=dev)
    logging_utils.count("kernels.lml_chol_f64")
    return quad, half_logdet


def lml_chol_plain(k: torch.Tensor, y: torch.Tensor):
    """Plain version of :func:`lml_chol_f64`: ``cholesky_ex``, one forward
    solve and the sum of the log diagonal, NaN where ``info`` reports a
    failed factorization; k is not changed."""
    chol, info = torch.linalg.cholesky_ex(k)
    yb = y.expand(k.shape[:-1])
    z = torch.linalg.solve_triangular(chol, yb[..., None], upper=False)
    quad = torch.sum(z[..., 0] ** 2, dim=-1)
    half_logdet = torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    bad = info != 0
    nan = torch.full_like(quad, float("nan"))
    return torch.where(bad, nan, quad), torch.where(bad, nan, half_logdet)


# ---------------------------------------------------------------------------
# A: KG inner posterior-mean descent
# ---------------------------------------------------------------------------

DESCENT_MAX_D, DESCENT_MAX_Q, DESCENT_MAX_WR = 8, 16, 64


def descent_shapes_supported(d: int, q: int) -> bool:
    """Whether the descent kernels (A and D) take d dimensions and q union
    points: d <= 8, q <= 16 and Wr = (1 + q)(1 + d) <= 64."""
    return d <= DESCENT_MAX_D and q <= DESCENT_MAX_Q and \
        (1 + q) * (1 + d) <= DESCENT_MAX_WR


def _descent_shapes(name, xs, ws, wt, beta, z, us):
    """Check the descent operands' shapes against xs (S, B, d, M) and z
    (q, M) and the kernels' limits; returns (S, B, d, M, q, Np, Wr)."""
    s, b, d, m = xs.shape
    q = z.shape[0]
    np_ = ws.shape[-1]
    wr = (1 + q) * (1 + d)
    _expect(name, "ws", ws, (s, d, np_))
    _expect(name, "wt", wt, (s, b, wr, np_))
    _expect(name, "beta", beta, (s, b, q, m))
    _expect(name, "z", z, (q, m))
    _expect(name, "us", us, (s, b, q, d))
    if not descent_shapes_supported(d, q):
        raise ValueError(f"{name}: d <= 8, q <= 16 and (1+q)(1+d) <= 64 "
                         f"supported, got d={d}, q={q}")
    return s, b, d, m, q, np_, wr


MMA_ROWS = 16              # csrc/field_mma.cuh MMA_ROWS: Wr <= 16
MMA_WARPS = 4              # csrc/field_mma.cuh MMA_WARPS
MMA_UQ = 16                # csrc/field_mma.cuh MMA_UQ
MMA_ABUF = 40              # csrc/field_mma.cuh MMA_ABUF


def descent_mma_smem_bytes(d: int, q: int, np_: int) -> int:
    """Shared memory of a block of A's and D's tensor-core instances at (d,
    q, Np): the Wr W rows at a row stride of 8 (mod 32) floats, ws, the
    union points and each warp's Wr x MMA_ABUF exchange buffer
    (``cmoe_mma_smem_bytes`` in ``csrc/field_mma.cuh``)."""
    np8 = -(-np_ // 8) * 8
    ldw = np8 + (40 - np8 % 32) % 32
    wr = (1 + q) * (1 + d)
    return 4 * (wr * ldw + d * np8 + MMA_UQ + MMA_WARPS * wr * MMA_ABUF)


def descent_run_instance(d: int, q: int, np_: int) -> str:
    """Which instance of kernel A :func:`descent_run` launches: ``"mma"``
    where the Wr = (1 + q)(1 + d) moment rows fit one 16-row tensor-core
    tile and its staged operands fit one block, ``"fma"`` otherwise."""
    wr = (1 + q) * (1 + d)
    return "mma" if wr <= MMA_ROWS and \
        descent_mma_smem_bytes(d, q, np_) <= SMEM_PER_BLOCK else "fma"


def descent_mma_occupancy(d: int, q: int, m: int, np_: int,
                          kernel_name: str) -> int:
    """Blocks of the tensor-core instance resident on one SM of the
    current card at these shapes
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes
    out = ctypes.c_int(0)
    rc = _lib().cmoe_descent_run_mma_occupancy(
        d, q, m, np_, KERNEL_CODES[kernel_name], ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"descent_mma_occupancy: CUDA error {rc}")
    return out.value


def _descent_run_args(name, xs0, ws, wt, beta, z, us, geom, kernel_name,
                      steps, restarts, avg_n):
    """None for CPU tensors (the plain version), else (S, B, d, M, q, Np,
    Wr) after checking the shapes and the schedule."""
    if not _on_card(name, kernel_name, xs0=xs0, ws=ws, wt=wt, beta=beta,
                    z=z, us=us, geom=geom):
        return None
    shapes = _descent_shapes(name, xs0, ws, wt, beta, z, us)
    _expect(name, "geom", geom, (shapes[0], 3, shapes[2]))
    if not (0 <= avg_n <= steps and restarts >= 1):
        raise ValueError(f"{name}: need 0 <= avg_n <= steps, restarts >= 1")
    return shapes


def _launch_descent_run(name, entry, xs0, ws, wt, beta, z, us, geom,
                        kernel_name, shapes, steps, restarts, avg_n, gamma,
                        pre_mult, mrc) -> torch.Tensor:
    s, b, d, m, q, np_, wr = shapes
    out = torch.empty_like(xs0)
    _launch(name, entry, xs0.data_ptr(), ws.data_ptr(), wt.data_ptr(),
            beta.data_ptr(), z.data_ptr(), us.data_ptr(), geom.data_ptr(),
            out.data_ptr(), s, b, d, m, np_, q, wr, int(steps),
            int(restarts), int(avg_n), float(gamma), float(pre_mult),
            float(mrc), KERNEL_CODES[kernel_name], device=xs0.device)
    return out


def descent_run(xs0: torch.Tensor, ws: torch.Tensor, wt: torch.Tensor,
                beta: torch.Tensor, z: torch.Tensor, us: torch.Tensor,
                geom: torch.Tensor, kernel_name: str, steps: int,
                restarts: int, avg_n: int, gamma: float, pre_mult: float,
                mrc: float) -> torch.Tensor:
    """Whole inner descent for S members x B unions x M draws; returns the
    final scaled points (S, B, d, M).

    xs0 (S, B, d, M) scaled starts; ws (S, d, Np) scaled training points;
    wt (S, B, Wr, Np) moment weights c*[K^-1 y | V | (those) * ws_dd] with
    Wr = (1 + q)(1 + d); beta (S, B, q, M) c-scaled fantasy betas;
    z (q, M) normals^T; us (S, B, q, d) scaled union points;
    geom (S, 3, d) rows [lower / l, upper / l, 1 / l^2].  ``restarts``
    rounds of ``steps`` GD steps at rate ``pre_mult (i+1)^-gamma`` with
    LimitUpdate clamping (``mrc``) and Polyak averaging of the last
    ``avg_n`` steps (0 = off) followed by a clip.

    Launches the tensor-core instance where :func:`descent_run_instance`
    says ``"mma"`` (the main path's d = 2, q = 4 among them), else
    :func:`descent_run_fma`.
    """
    name = "descent_run"
    shapes = _descent_run_args(name, xs0, ws, wt, beta, z, us, geom,
                               kernel_name, steps, restarts, avg_n)
    if shapes is None:
        return descent_run_plain(xs0, ws, wt, beta, z, us, geom,
                                 kernel_name, steps, restarts, avg_n, gamma,
                                 pre_mult, mrc)
    tail = (steps, restarts, avg_n, gamma, pre_mult, mrc)
    d, q, np_ = shapes[2], shapes[4], shapes[5]
    if descent_run_instance(d, q, np_) == "fma":
        return descent_run_fma(xs0, ws, wt, beta, z, us, geom, kernel_name,
                               *tail)
    out = _launch_descent_run(name, _lib().cmoe_descent_run_mma, xs0, ws, wt,
                              beta, z, us, geom, kernel_name, shapes, *tail)
    logging_utils.count("kernels.descent_run")
    return out


def descent_run_fma(xs0: torch.Tensor, ws: torch.Tensor, wt: torch.Tensor,
                    beta: torch.Tensor, z: torch.Tensor, us: torch.Tensor,
                    geom: torch.Tensor, kernel_name: str, steps: int,
                    restarts: int, avg_n: int, gamma: float,
                    pre_mult: float, mrc: float) -> torch.Tensor:
    """Kernel A's FMA instance at any shape (d <= 8, q <= 16, Wr <= 64):
    one thread per draw, the contraction in float32 FMA.
    :func:`descent_run` takes it above one tensor-core tile; arguments and
    result as there."""
    name = "descent_run_fma"
    shapes = _descent_run_args(name, xs0, ws, wt, beta, z, us, geom,
                               kernel_name, steps, restarts, avg_n)
    if shapes is None:
        return descent_run_plain(xs0, ws, wt, beta, z, us, geom,
                                 kernel_name, steps, restarts, avg_n, gamma,
                                 pre_mult, mrc)
    out = _launch_descent_run(name, _lib().cmoe_descent_run_fma, xs0, ws, wt,
                              beta, z, us, geom, kernel_name, shapes, steps,
                              restarts, avg_n, gamma, pre_mult, mrc)
    logging_utils.count("kernels.descent_run_fma")
    return out


def descent_run_plain(xs0, ws, wt, beta, z, us, geom, kernel_name, steps,
                      restarts, avg_n, gamma, pre_mult, mrc):
    """Plain version of :func:`descent_run`: the analytic moment gradient
    driven by the gradient_ascent_batch schedule, in scaled coordinates."""
    lo = geom[:, None, 0, :, None]
    hi = geom[:, None, 1, :, None]
    il2 = geom[:, None, 2, :, None]
    xs = xs0
    for _ in range(max(int(restarts), 1)):
        traj = []
        for i in range(int(steps)):
            g = descent_grad_plain(xs, ws, wt, beta, z, us, kernel_name)
            g = torch.where(torch.isfinite(g), g, 0.0)
            rate = float(pre_mult) * (i + 1.0) ** (-float(gamma))
            xs = xs + box_limit_update(lo, hi, mrc, xs, rate * g * il2)
            if avg_n:
                traj = (traj + [xs])[-int(avg_n):]
        if avg_n and traj:
            xs = torch.minimum(torch.maximum(
                torch.mean(torch.stack(traj), dim=0), lo), hi)
    return xs


# ---------------------------------------------------------------------------
# D: one ascent direction of the KG inner descent
# ---------------------------------------------------------------------------

def descent_grad_instance(d: int, q: int, np_: int) -> str:
    """Which instance of kernel D :func:`descent_grad` launches: ``"mma"``
    or ``"fma"`` by :func:`descent_run_instance`'s rule, since D's
    tensor-core instance stages A's operands in A's layout."""
    return descent_run_instance(d, q, np_)


def _launch_descent_grad(name, entry, shapes, xs, ws, wt, beta, z, us,
                         kernel_name) -> torch.Tensor:
    """Launch ``entry`` at shapes (:func:`_descent_shapes`); returns g (S,
    B, d, M)."""
    s, b, d, m, q, np_, wr = shapes
    out = torch.empty_like(xs)
    _launch(name, entry, xs.data_ptr(), ws.data_ptr(), wt.data_ptr(),
            beta.data_ptr(), z.data_ptr(), us.data_ptr(), out.data_ptr(), s,
            b, d, m, np_, q, wr, KERNEL_CODES[kernel_name], device=xs.device)
    return out


def descent_grad(xs: torch.Tensor, ws: torch.Tensor, wt: torch.Tensor,
                 beta: torch.Tensor, z: torch.Tensor, us: torch.Tensor,
                 kernel_name: str) -> torch.Tensor:
    """Ascent direction of -mu' in scaled coordinates at the draws' points
    xs (S, B, d, M); returns (S, B, d, M).

    The operands are :func:`descent_run`'s: ws (S, d, Np), wt (S, B, Wr,
    Np), beta (S, B, q, M), z (q, M), us (S, B, q, d).  Any M and Np.

    Launches the tensor-core instance, whose direction at x is the one
    :func:`descent_run`'s tensor-core instance forms at x, where
    :func:`descent_grad_instance` says ``"mma"`` (the main path's d = 2,
    q = 4 among them), else :func:`descent_grad_fma`.
    """
    name = "descent_grad"
    if not _on_card(name, kernel_name, xs=xs, ws=ws, wt=wt, beta=beta, z=z,
                    us=us):
        return descent_grad_plain(xs, ws, wt, beta, z, us, kernel_name)
    shapes = _descent_shapes(name, xs, ws, wt, beta, z, us)
    if descent_grad_instance(shapes[2], shapes[4], shapes[5]) == "fma":
        return descent_grad_fma(xs, ws, wt, beta, z, us, kernel_name)
    out = _launch_descent_grad(name, _lib().cmoe_descent_grad_mma, shapes,
                               xs, ws, wt, beta, z, us, kernel_name)
    logging_utils.count("kernels.descent_grad")
    return out


def descent_grad_fma(xs: torch.Tensor, ws: torch.Tensor, wt: torch.Tensor,
                     beta: torch.Tensor, z: torch.Tensor, us: torch.Tensor,
                     kernel_name: str) -> torch.Tensor:
    """Kernel D's FMA instance at any shape (d <= 8, q <= 16, Wr <= 64):
    one thread per draw, the contraction in float32 FMA.
    :func:`descent_grad` takes it above one tensor-core tile; arguments and
    result as there."""
    name = "descent_grad_fma"
    if not _on_card(name, kernel_name, xs=xs, ws=ws, wt=wt, beta=beta, z=z,
                    us=us):
        return descent_grad_plain(xs, ws, wt, beta, z, us, kernel_name)
    out = _launch_descent_grad(
        name, _lib().cmoe_descent_grad_fma,
        _descent_shapes(name, xs, ws, wt, beta, z, us), xs, ws, wt, beta, z,
        us, kernel_name)
    logging_utils.count("kernels.descent_grad_fma")
    return out


def descent_grad_plain(xs, ws, wt, beta, z, us, kernel_name):
    """Plain version of :func:`descent_grad`: the moment contraction as one
    batched matmul over the materialized (S, B, Np, M) field."""
    unit_p = _unit_fields(kernel_name).unit_p
    sh = xs.shape
    q, d = z.shape[0], sh[2]
    diff = ws[:, None, :, :, None] - xs[:, :, :, None, :]   # (S,B,d,Np,M)
    phi = unit_p(torch.sum(diff * diff, dim=2))             # (S,B,Np,M)
    a = wt @ phi                                            # (S,B,Wr,M)
    s0 = a[:, :, 0] - torch.sum(a[:, :, 1:1 + q] * z, dim=2)
    ax = a[:, :, 1 + q:].reshape(sh[0], sh[1], 1 + q, d, sh[3])
    sx = ax[:, :, 0] - torch.sum(ax[:, :, 1:] * z[:, None, :], dim=2)
    g = xs * s0[:, :, None] - sx
    du = xs[:, :, None] - us[..., None]                     # (S,B,q,d,M)
    pb = unit_p(torch.sum(du * du, dim=3)) * beta           # (S,B,q,M)
    return g + torch.sum(pb[:, :, :, None] * du, dim=2)
