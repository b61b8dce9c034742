"""The port's CUDA kernels against their plain versions, on the card.

``chip_smoke.py`` checks each kernel at the main path's shapes; these tests
cover what it does not reach: ragged sizes, the squared-exponential field,
the covariance's symmetry and diagonal, both instances of the fused LML
(the cluster one against the large-Np one), both instances of the descent
and of the descent direction (tensor-core and FMA) and their generic
(d, q) instances, their dispatch and their non-finite blocks, failed LML
factorizations, the wrappers' refusals on CUDA tensors, the KG descent's
gate, which sends the shapes the descent kernels do not take,
derivative-observed states and fidelity dims to the plain route and reads
a union's width with its points being sampled (q + p), and
kernels B and C at the shapes of the cf-KG and PES paths, and C's
per-call switch (``use_pallas``).  They need
a CUDA card (marker ``cuda``) and skip without one.  On the card, without JAX installed:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

Tolerances: covariance at rtol 2e-4 / atol 2e-5 against the float32 plain
version (tests/test_pallas_kernels.py:26); the fused LML at rtol 5e-4
against the plain version on the same inputs in float32 and in float64
(tests/test_pallas_descent.py:168-171), and the cluster instance against
the large-Np instance at rtol 1e-6 and bit for bit (one kernel, the same
arithmetic per element in the same order; only where K's tiles live
differs); descent endpoints against the
float64 plain version, at most 1% of them more than 5e-5 of the domain
width apart (tests/test_pallas_descent.py:64-65; the rest part where
float32 rounding flips a clamped step); one descent direction against the
float64 plain version no further than 2e-5 max(max|g|, 1)
(tests/test_pallas_descent.py:48) or 1.5x the float32 plain version's own
deviation, and against the float32 plain version within that bound
wherever the float32 plain version is itself within it of float64.
"""

import numpy as np
import pytest
import torch

from cornell_moe_tpu_torch.models.mcmc import PAD_NOISE
from cornell_moe_tpu_torch.ops import kernels
from cornell_moe_tpu_torch.utils import logging_utils as lu

pytestmark = pytest.mark.cuda
COVARIANCES = ["matern_2.5", "square_exponential"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _c(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


def _launches(before):
    """Each kernel's launches since ``before`` (an ``lu.counters()``
    snapshot): the growth of its counter ``kernels.<name>``."""
    return {n[len("kernels."):]: v for n, v in lu.growth(before).items()
            if n.startswith("kernels.")}


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("n", [1, 3, 63, 64, 65, 100, 130, 511, 512, 520,
                               768])
@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_covariance_kernel_matches_plain(dev, rng, kernel, n, d):
    """Tiles of 64: n 63 and 65 end in a ragged tile, n 511 and 65 also in
    rows that are not 16-byte aligned (scalar stores).  K equals its
    transpose bit for bit (each off-diagonal tile is computed once and
    written twice), and its diagonal is alpha unit_f0(0) + noise, with
    unit_f0(0) = 1."""
    s = 3
    points = _c(rng.random((n, d)), dev)
    hypers = _c(np.concatenate([0.5 + rng.random((s, 1)),
                                0.2 + rng.random((s, d))], axis=1), dev)
    noise = np.full((s, n), 1e-2)
    noise[:, n - n // 10:] = PAD_NOISE
    noise = _c(noise, dev)
    before = lu.counters()
    got = kernels.covariance_with_noise(points, hypers, noise, kernel)
    ref = kernels.covariance_with_noise_plain(points, hypers, noise, kernel)
    torch.cuda.synchronize()
    assert _launches(before).get("covariance_with_noise", 0) == 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)
    assert torch.equal(got, got.transpose(-1, -2))
    assert torch.equal(torch.diagonal(got, dim1=-2, dim2=-1),
                       hypers[:, :1] + noise)


def _lml_inputs(rng, w, d, np_, n_real, lengths, noise_level):
    x = rng.random((n_real, d))
    us = np.empty((w, d, np_))
    us[:, :, :n_real] = x.T[None] / lengths[:, :, None]
    # padding columns at huge distinct offsets, as the log-posterior pads
    us[:, :, n_real:] = 1e6 * (np.arange(np_ - n_real) + 1.0)
    alpha = 0.5 + rng.random(w)
    noise = np.full((w, np_), noise_level)
    noise[:, n_real:] = PAD_NOISE
    y = np.zeros((w, np_))
    y[:, :n_real] = np.sin(3 * x[:, 0]) + x[:, -1]
    return us, alpha, noise, y


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("np_", [100, 128, 384, 512, 520, 672])
@pytest.mark.parametrize("w", [1, 8, 16])
def test_lml_kernel_matches_plain(dev, rng, kernel, np_, w):
    """Np <= 640 takes the cluster instance (520: a ragged 8-row last
    panel), which must also agree with the large-Np instance on the same
    inputs at rtol 1e-6; Np = 672 takes the large-Np instance."""
    d, n_real = 3, np_ - 7
    lengths = 0.3 + 0.4 * rng.random((w, d))
    args = [_c(a, dev) for a in _lml_inputs(rng, w, d, np_, n_real,
                                            lengths, 1e-2)]
    instance = kernels.lml_fused_instance(np_)
    assert instance == ("global" if np_ == 672 else "cluster")
    before = lu.counters()
    got = kernels.lml_fused(*args, n_real, kernel)
    torch.cuda.synchronize()
    counter = "lml_fused" if instance == "cluster" else "lml_fused_global"
    assert _launches(before) == {counter: 1}
    ref = kernels.lml_fused_plain(*args, n_real, kernel)
    ref_64 = kernels.lml_fused_plain(*[a.double() for a in args], n_real,
                                     kernel)
    for g, r, r64 in zip(got, ref, ref_64):
        torch.testing.assert_close(g, r, rtol=5e-4, atol=0.0)
        torch.testing.assert_close(g.double(), r64, rtol=5e-4, atol=0.0)
    if instance == "cluster":
        for g, r in zip(got, kernels.lml_fused_global(*args, n_real,
                                                      kernel)):
            torch.testing.assert_close(g, r, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("np_,bad_row", [(512, 0), (512, 101), (520, 515),
                                         (672, 650), (1824, 1800)],
                         ids=["first_tile", "cta3_tile_row",
                              "ragged_last_panel", "large_np",
                              "large_np_panel_off_chip"])
def test_lml_kernel_failure_is_nan(dev, rng, np_, bad_row):
    """Walkers whose K is not positive definite get NaN, as the plain
    version's failed factorization does; the others are unaffected.  The
    bad pivot sits in the first tile, in tile row 3 (owned by CTA 3), in
    the ragged last panel, and in the large-Np instance, with its panel
    column on chip (672) and in the scratch (1824)."""
    w, d, n_real = 4, 2, np_ - 4
    lengths = 0.3 + 0.4 * rng.random((w, d))
    us, alpha, noise, y = _lml_inputs(rng, w, d, np_, n_real, lengths, 1e-2)
    noise[[1, 3], bad_row] = -10.0
    args = [_c(a, dev) for a in (us, alpha, noise, y)]
    got = kernels.lml_fused(*args, n_real)
    ref = kernels.lml_fused_plain(*args, n_real)
    for g, r in zip(got, ref):
        assert bool(torch.isnan(g[[1, 3]]).all())
        assert bool(torch.isnan(r[[1, 3]]).all())
        torch.testing.assert_close(g[[0, 2]], r[[0, 2]], rtol=5e-4, atol=0.0)


def test_lml_cluster_layout_and_occupancy(dev):
    """The kernel's shared-memory layout is the one the wrapper sizes its
    choice by, for both instances, and so is the large-Np instance's
    scratch; every walker's cluster of the main path fits at once, at Np
    512 and at main_path_768's Np 768."""
    lib = kernels._lib()
    for np_ in (100, 384, 512, 520, kernels.LML_CLUSTER_CAPACITY):
        assert lib.cmoe_lml_fused_cluster_smem_bytes(np_) == \
            kernels.lml_cluster_smem_bytes(np_)
    for np_ in (384, 656, 672, 768, 896, 1008, 1792, 1793, 1824):
        assert lib.cmoe_lml_fused_global_smem_bytes(np_) == \
            kernels.lml_global_smem_bytes(np_)
        assert lib.cmoe_lml_fused_global_scratch_floats(np_) == \
            kernels.lml_global_scratch_floats(np_)
    assert kernels.lml_cluster_occupancy(8, 512) >= 8
    assert kernels.lml_global_occupancy(8, 768) >= 8


LARGE_NPS = [656, 672, 700, 768, 896, 1008, 1824]


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("np_", LARGE_NPS)
@pytest.mark.parametrize("w", [1, 8, 16])
def test_lml_large_np_instance_matches_plain(dev, rng, kernel, np_, w):
    """Kernel B's large-Np instance, which the wrapper takes above the
    cluster capacity: K's tiles in the global scratch, the panel column on
    chip up to Np 1792 and in the scratch at 1824; ragged last panels at
    656, 700 and 1824.  Against the plain version in float32 and float64
    at rtol 5e-4, one launch of its counter each time."""
    d, n_real = 3, np_ - 7
    lengths = 0.3 + 0.4 * rng.random((w, d))
    args = [_c(a, dev) for a in _lml_inputs(rng, w, d, np_, n_real,
                                            lengths, 1e-2)]
    assert kernels.lml_fused_instance(np_) == "global"
    assert kernels.lml_global_pbuf_on_chip(np_) == (np_ <= 1792)
    before = lu.counters()
    got = kernels.lml_fused(*args, n_real, kernel)
    torch.cuda.synchronize()
    assert _launches(before) == {"lml_fused_global": 1}
    ref = kernels.lml_fused_plain(*args, n_real, kernel)
    ref_64 = kernels.lml_fused_plain(*[a.double() for a in args], n_real,
                                     kernel)
    for g, r, r64 in zip(got, ref, ref_64):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, r, rtol=5e-4, atol=0.0)
        torch.testing.assert_close(g.double(), r64, rtol=5e-4, atol=0.0)


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("np_", [384, 512, 640])
@pytest.mark.parametrize("w", [1, 8, 16])
def test_lml_instances_equal_bit_for_bit(dev, rng, kernel, np_, w):
    """Where both instances run (up to the cluster capacity, 640) the
    large-Np instance equals the cluster instance bit for bit: one kernel,
    each element's arithmetic in the same order, only the tiles' memory
    differing."""
    d, n_real = 2, np_ - 5
    lengths = 0.3 + 0.4 * rng.random((w, d))
    args = [_c(a, dev) for a in _lml_inputs(rng, w, d, np_, n_real,
                                            lengths, 1e-2)]
    assert kernels.lml_fused_instance(np_) == "cluster"
    cluster = kernels.lml_fused(*args, n_real, kernel)
    large = kernels.lml_fused_global(*args, n_real, kernel)
    torch.cuda.synchronize()
    for a, b in zip(cluster, large):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


def _descent_inputs(rng, s, b, d, q, m, np_):
    lengths = 0.3 + 0.4 * rng.random((s, d))
    ws = rng.random((s, np_, d)) / lengths[:, None, :]
    wr = (1 + q) * (1 + d)
    wt = 0.3 * rng.standard_normal((s, b, wr, np_))
    beta = rng.standard_normal((s, b, q, m))
    z = rng.standard_normal((q, m))
    us = rng.random((s, b, q, d)) / lengths[:, None, None, :]
    geom = np.stack([np.zeros((s, d)), 1.0 / lengths, 1.0 / lengths**2],
                    axis=1)
    xs0 = rng.random((s, b, d, m)) / lengths[:, None, :, None]
    return (xs0, ws.transpose(0, 2, 1), wt, beta, z, us, geom), lengths


def _check_descent_endpoints(got, ref, lengths, dev):
    """At most 1% of the endpoints more than 5e-5 of the domain width from
    the float64 descent, all finite and inside the box."""
    scale = torch.as_tensor(lengths, device=dev)[:, None, :, None]
    err = ((got.double() - ref) * scale).abs()       # domain-width units
    assert torch.isfinite(got).all()
    assert float((err > 5e-5).double().mean()) <= 0.01, float(err.max())
    hi = (1.0 / scale) * (1 + 1e-6)
    assert bool(((got.double() >= 0) & (got.double() <= hi)).all())


def _launched(before, name):
    assert _launches(before) == {name: 1}


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("d,q,m,np_", [(3, 2, 50, 70), (2, 4, 40, 130)])
@pytest.mark.parametrize("schedule", [(6, 2, 3), (1, 1, 0)],
                         ids=["cold", "warm"])
def test_descent_kernel_matches_float64_plain(dev, rng, kernel, d, q, m,
                                              np_, schedule):
    """The FMA instance (descent_run_fma): (3, 2) runs its generic
    instance, (2, 4) the main path's."""
    s, b = 2, 3
    steps, restarts, avg_n = schedule
    arrays, lengths = _descent_inputs(rng, s, b, d, q, m, np_)
    tail = (kernel, steps, restarts, avg_n, 0.3, 1.0, 0.1)
    before = lu.counters()
    got = kernels.descent_run_fma(*[_c(a, dev) for a in arrays], *tail)
    ref = kernels.descent_run_plain(
        *[_c(a, dev, torch.float64) for a in arrays], *tail)
    torch.cuda.synchronize()
    _launched(before, "descent_run_fma")
    _check_descent_endpoints(got, ref, lengths, dev)


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("d,q", [(2, 4), (3, 3), (1, 1)],
                         ids=["d2q4", "d3q3_wr16", "d1q1"])
@pytest.mark.parametrize("np_", [70, 130, 512, 520])
@pytest.mark.parametrize("m", [40, 128, 200])
@pytest.mark.parametrize("schedule", [(6, 1, 3), (1, 1, 0)],
                         ids=["cold", "warm"])
def test_descent_mma_kernel_matches_float64_plain(dev, rng, kernel, d, q,
                                                  np_, m, schedule):
    """The tensor-core instance, which descent_run takes at Wr <= 16: (2, 4)
    its main-path instance, (3, 3) and (1, 1) its generic one; Np 70, 130
    and 520 end in a ragged k-tile, M 40 and 200 in a partial warp."""
    s, b = 2, 3
    steps, restarts, avg_n = schedule
    arrays, lengths = _descent_inputs(rng, s, b, d, q, m, np_)
    tail = (kernel, steps, restarts, avg_n, 0.3, 1.0, 0.1)
    assert kernels.descent_run_instance(d, q, np_) == "mma"
    before = lu.counters()
    got = kernels.descent_run(*[_c(a, dev) for a in arrays], *tail)
    ref = kernels.descent_run_plain(
        *[_c(a, dev, torch.float64) for a in arrays], *tail)
    torch.cuda.synchronize()
    _launched(before, "descent_run")
    _check_descent_endpoints(got, ref, lengths, dev)


def test_descent_nonfinite_block_stands_still_in_both_instances(dev, rng):
    """A NaN in one block's K^-1 y row of W (as where the fantasy factor
    fails): every direction of that block is NaN, so every draw keeps its
    start (then the Polyak mean and the clip), bit for bit as in the FMA
    instance; the other blocks are untouched by it."""
    arrays, lengths = _descent_inputs(rng, 2, 3, 2, 4, 128, 512)
    arrays[2][1, 2, 0, 100] = np.nan
    args = [_c(a, dev) for a in arrays]
    tail = ("matern_2.5", 6, 1, 3, 0.3, 1.0, 0.1)
    got = kernels.descent_run(*args, *tail)
    fma = kernels.descent_run_fma(*args, *tail)
    ref = kernels.descent_run_plain(
        *[_c(a, dev, torch.float64) for a in arrays], *tail)
    assert torch.equal(got[1, 2], fma[1, 2])
    torch.testing.assert_close(got[1, 2], args[0][1, 2], rtol=1e-6, atol=0.0)
    keep = torch.ones(got.shape[:2], dtype=torch.bool, device=dev)
    keep[1, 2] = False
    for si in range(2):
        rows = keep[si]
        _check_descent_endpoints(got[si][rows][None], ref[si][rows][None],
                                 lengths[si:si + 1], dev)


def test_descent_run_dispatches_wide_moments_to_the_fma_instance(dev, rng):
    """Wr = 20 (d 3, q 4) does not fit one tensor-core tile: descent_run
    launches the FMA instance, by the counters."""
    arrays, lengths = _descent_inputs(rng, 2, 3, 3, 4, 40, 130)
    assert kernels.descent_run_instance(3, 4, 130) == "fma"
    tail = ("square_exponential", 6, 1, 3, 0.3, 1.0, 0.1)
    before = lu.counters()
    got = kernels.descent_run(*[_c(a, dev) for a in arrays], *tail)
    torch.cuda.synchronize()
    _launched(before, "descent_run_fma")
    ref = kernels.descent_run_plain(
        *[_c(a, dev, torch.float64) for a in arrays], *tail)
    _check_descent_endpoints(got, ref, lengths, dev)


def test_descent_mma_layout_matches_the_wrapper(dev):
    """The kernel's shared-memory count is the one the instance choice
    uses."""
    lib = kernels._lib()
    for d, q in ((1, 1), (2, 4), (3, 3), (7, 1), (1, 7)):
        for np_ in (1, 70, 130, 512, 520, 3000):
            assert lib.cmoe_descent_run_mma_smem_bytes(d, q, np_) == \
                kernels.descent_mma_smem_bytes(d, q, np_)
    assert kernels.descent_mma_occupancy(2, 4, 128, 512, "matern_2.5") >= 4


def _check_direction(got, args, arrays, kernel, dev, where=None):
    """One direction against the float64 plain version, no further than
    2e-5 max(max|g|, 1) or 1.5x the float32 plain version's deviation, and
    against the float32 plain version within that bound where the float32
    plain version is itself within it of float64; compared where `where`
    (default: everywhere) holds."""
    ref = kernels.descent_grad_plain(*args, kernel)
    ref_64 = kernels.descent_grad_plain(
        *[_c(a, dev, torch.float64) for a in arrays[:6]], kernel)
    if where is None:
        where = torch.ones_like(got, dtype=torch.bool)
    got, ref, ref_64 = got[where], ref[where], ref_64[where]
    bound = 2e-5 * max(ref_64.abs().max().item(), 1.0)
    dev_plain = (ref.double() - ref_64).abs().max().item()
    assert (got.double() - ref_64).abs().max().item() <= \
        max(bound, 1.5 * dev_plain)
    if dev_plain <= bound:
        assert (got - ref).abs().max().item() <= bound


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("d,q,m,np_", [(3, 2, 50, 70), (2, 4, 128, 512),
                                       (2, 4, 40, 1000)])
def test_descent_grad_kernel_matches_plain(dev, rng, kernel, d, q, m, np_):
    """The FMA instance (descent_grad_fma): (3, 2) runs its generic
    instance, (2, 4) the main path's; Np = 1000 stages 68 KB, above the
    default 48 KB of shared memory."""
    s, b = 2, 3
    arrays, _ = _descent_inputs(rng, s, b, d, q, m, np_)
    args = [_c(a, dev) for a in arrays[:6]]
    before = lu.counters()
    got = kernels.descent_grad_fma(*args, kernel)
    torch.cuda.synchronize()
    _launched(before, "descent_grad_fma")
    _check_direction(got, args, arrays, kernel, dev)


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("d,q", [(2, 4), (3, 3), (1, 1)],
                         ids=["d2q4", "d3q3_wr16", "d1q1"])
@pytest.mark.parametrize("np_", [70, 130, 512, 520])
@pytest.mark.parametrize("m", [40, 128, 200])
def test_descent_grad_mma_kernel_matches_float64_plain(dev, rng, kernel, d,
                                                       q, np_, m):
    """The tensor-core instance, which descent_grad takes at Wr <= 16:
    (2, 4) its main-path instance, (3, 3) and (1, 1) its generic one; Np
    70, 130 and 520 end in a ragged k-tile, M 40 and 200 in a partial
    warp."""
    arrays, _ = _descent_inputs(rng, 2, 3, d, q, m, np_)
    args = [_c(a, dev) for a in arrays[:6]]
    assert kernels.descent_grad_instance(d, q, np_) == "mma"
    before = lu.counters()
    got = kernels.descent_grad(*args, kernel)
    torch.cuda.synchronize()
    _launched(before, "descent_grad")
    assert torch.isfinite(got).all()
    _check_direction(got, args, arrays, kernel, dev)


def test_descent_grad_mma_nonfinite_operands_stay_where_they_are(dev, rng):
    """A NaN in one block's K^-1 y row of W makes every direction of that
    block non-finite, and a NaN beta its draw's direction, as in the plain
    version; every other direction holds the rule."""
    arrays, _ = _descent_inputs(rng, 2, 3, 2, 4, 128, 512)
    arrays[2][1, 2, 0, 100] = np.nan
    arrays[3][0, 1, 2, 5] = np.nan
    args = [_c(a, dev) for a in arrays[:6]]
    got = kernels.descent_grad(*args, "matern_2.5")
    ref = kernels.descent_grad_plain(*args, "matern_2.5")
    bad = torch.zeros_like(got, dtype=torch.bool)
    bad[1, 2] = True
    bad[0, 1, :, 5] = True
    assert torch.equal(~torch.isfinite(got), bad)
    assert torch.equal(~torch.isfinite(ref), bad)
    _check_direction(got, args, arrays, "matern_2.5", dev, where=~bad)


def test_descent_grad_dispatches_wide_moments_to_the_fma_instance(dev, rng):
    """Wr = 20 (d 3, q 4) does not fit one tensor-core tile: descent_grad
    launches the FMA instance, by the counters."""
    arrays, _ = _descent_inputs(rng, 2, 3, 3, 4, 40, 130)
    args = [_c(a, dev) for a in arrays[:6]]
    assert kernels.descent_grad_instance(3, 4, 130) == "fma"
    before = lu.counters()
    got = kernels.descent_grad(*args, "square_exponential")
    torch.cuda.synchronize()
    _launched(before, "descent_grad_fma")
    _check_direction(got, args, arrays, "square_exponential", dev)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev, rng):
    s, n, d = 2, 16, 2
    points = _c(rng.random((n, d)), dev)
    hypers = _c(np.ones((s, 1 + d)), dev)
    noise = _c(np.full((s, n), 1e-2), dev)
    before = lu.counters()
    with pytest.raises(TypeError):
        kernels.covariance_with_noise(points.double(), hypers.double(),
                                      noise.double())
    with pytest.raises(ValueError):
        kernels.covariance_with_noise(points.T.contiguous().T, hypers, noise)
    with pytest.raises(RuntimeError):
        kernels.covariance_with_noise(points.clone().requires_grad_(), hypers,
                                      noise)
    with pytest.raises(ValueError):
        kernels.covariance_with_noise(points, hypers, noise[:, :-1])
    with pytest.raises(ValueError):
        kernels.lml_fused(points.T[None].contiguous(), hypers[:1, 0],
                          noise[:1], noise[:1], n + 1)
    desc = [_c(a, dev) for a in _descent_inputs(rng, 2, 3, 2, 4, 16, n)[0][:6]]
    with pytest.raises(TypeError):
        kernels.descent_grad(*[a.double() for a in desc], "matern_2.5")
    with pytest.raises(ValueError):
        kernels.descent_grad(desc[0].transpose(-1, -2).contiguous(
        ).transpose(-1, -2), *desc[1:], "matern_2.5")
    with pytest.raises(ValueError):
        kernels.descent_grad(desc[0], *desc[1:3], desc[3][..., :-1],
                             *desc[4:], "matern_2.5")
    with pytest.raises(RuntimeError):
        kernels.descent_grad(desc[0].clone().requires_grad_(), *desc[1:],
                             "matern_2.5")
    wide = [_c(a, dev) for a in _descent_inputs(rng, 1, 1, 9, 1, 8, n)[0][:6]]
    with pytest.raises(ValueError):
        kernels.descent_grad(*wide, "matern_2.5")
    assert _launches(before) == {}


@pytest.mark.parametrize("d,q,ds,nf,launches", [
    (2, 4, (), 0, 1), (9, 2, (), 0, 0), (4, 12, (), 0, 0), (2, 17, (), 0, 0),
    (2, 2, (0, 1), 0, 0), (3, 4, (), 1, 0)],
    ids=["main", "d9", "wr65", "q17", "derivatives", "fidelity"])
def test_kg_batch_descent_gate_on_the_card(dev, rng, d, q, ds, nf, launches):
    """Kernel A's gate on the card: one cold KG batch launches descent_run
    at the main path's (d, q) and takes the plain route at d = 9, at Wr =
    (1 + q)(1 + d) = 65, at q = 17, on a derivative-observed state (d-KG),
    where it raised or would be wrong before, and with a fidelity dim
    (cf-KG); the KG values agree with the float64 CPU path within 1e-3
    max(1, max |f64|)."""
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.bayes_opt import DEFAULT_SGD_PARAMS_PS
    from cornell_moe_tpu_torch.models import mcmc
    from cornell_moe_tpu_torch.ops.domains import TensorProductDomain

    s, n, b, m = 2, 24, 2, 8
    x = rng.random((n, d))
    y = np.stack([np.sin(3 * x[:, 0]) + x[:, 1], 3 * np.cos(3 * x[:, 0]),
                  np.ones(n)], axis=1)[:, :1 + len(ds)]
    hypers = np.concatenate([np.ones((s, 1)), 0.4 + 0.4 * np.sqrt(d / 2) *
                             rng.random((s, d))], axis=1)
    noises = np.full((s, 1 + len(ds)), 1e-2)
    unions = rng.random((b, q, d))
    normals = rng.standard_normal((m, q * (1 + len(ds))))
    discrete = rng.random((s, 5, d - nf))
    vals = {}
    for where, dt in ((dev, torch.float32), ("cpu", torch.float64)):
        def t(a):
            return torch.as_tensor(a, device=where, dtype=dt)
        states = mcmc.fit_gp_ensemble("matern_2.5", t(hypers), t(noises), x,
                                      y, ds)
        dom = TensorProductDomain.from_bounds([[0.0, 1.0]] * (d - nf),
                                              device=where, dtype=dt)
        torch.cuda.synchronize()
        before = lu.counters()
        v = kg.knowledge_gradient_batch(
            states, t(unions), t(discrete), t(normals), dom,
            DEFAULT_SGD_PARAMS_PS, t(np.full(s, y[:, 0].min())),
            derivatives_to_sample=ds, num_fidelity=nf)
        torch.cuda.synchronize()
        counts = _launches(before)
        assert counts.get("descent_run", 0) + \
            counts.get("descent_run_fma", 0) == \
            (launches if where == dev else 0)
        vals[str(where)] = v.double().cpu()
    got, ref = vals[str(dev)], vals["cpu"]
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-3 * max(1.0, ref.abs().max())


@pytest.mark.parametrize("q,p,width", [(3, 1, 4), (16, 1, 17)],
                         ids=["q3_p1", "q16_p1"])
def test_kg_descent_gate_reads_the_union_width_on_the_card(dev, rng, q, p,
                                                           width):
    """The ensemble KG multistart with points being sampled (warm route)
    on the card: every descent_run launch carries unions of the width
    q + p, and a union of 17 points (q + p > 16) takes the plain route;
    the picks are q finite points inside the domain."""
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.bayes_opt import DEFAULT_SGD_PARAMS_PS
    from cornell_moe_tpu_torch.models import mcmc
    from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
    from cornell_moe_tpu_torch.ops.optimizers import \
        GradientDescentParameters

    s, n, d = 2, 24, 2
    f32 = dict(device=dev, dtype=torch.float32)
    x = rng.random((n, d))
    states = mcmc.fit_gp_ensemble(
        "matern_2.5", _c(np.concatenate([np.ones((s, 1)), 0.3 + 0.3 *
                                         rng.random((s, d))], axis=1), dev),
        torch.full((s, 1), 1e-2, **f32), x,
        (np.sin(3 * x[:, 0]) + x[:, 1])[:, None])
    dom = TensorProductDomain.from_bounds([[0.0, 1.0]] * d, **f32)
    widths = []
    descent_run = kernels.descent_run

    def recording(xs0, ws, wt, beta, z, us, *args, **kw):
        widths.append(us.shape[2])
        return descent_run(xs0, ws, wt, beta, z, us, *args, **kw)

    before = lu.counters()
    kernels.descent_run = recording
    try:
        pts = kg.multistart_knowledge_gradient_mcmc_optimization(
            torch.Generator(device=dev).manual_seed(0), states, dom, q,
            GradientDescentParameters(num_multistarts=4, max_num_steps=3,
                                      max_num_restarts=1, pre_mult=0.4,
                                      max_relative_change=0.5),
            DEFAULT_SGD_PARAMS_PS, _c(rng.random((s, 5, d)), dev),
            points_being_sampled=_c(rng.random((p, d)), dev),
            num_mc_iterations=8)
        torch.cuda.synchronize()
    finally:
        kernels.descent_run = descent_run
    counts = _launches(before)
    assert pts.shape == (q, d) and bool(torch.isfinite(pts).all())
    assert bool(dom.check_point_inside(pts).all())
    if width <= 16:
        assert counts.get("descent_run", 0) + \
            counts.get("descent_run_fma", 0) == len(widths) > 0
        assert set(widths) == {width}
    else:
        assert counts.get("descent_run", 0) + \
            counts.get("descent_run_fma", 0) == 0


@pytest.mark.parametrize("kernel,s,n,d", [
    ("matern_2.5", 16, 512, 3), ("square_exponential", 100, 60, 6),
    ("square_exponential", 100, 61, 6)],
    ids=["cfkg_fit", "pes_fit", "pes_refit"])
def test_covariance_kernel_at_the_new_paths_shapes(dev, rng, kernel, s, n, d):
    """C at the cf-KG ensemble fit's shape (S 16, n 512 with 12 PAD_NOISE
    rows, d 3) and the PES fits' (M 100 SE kernels, n 60 and 61, d 6, no
    size window in the port's gate): against the plain version, symmetric
    bit for bit, one launch."""
    points = _c(rng.random((n, d)), dev)
    hypers = _c(np.concatenate([0.5 + rng.random((s, 1)),
                                0.2 + rng.random((s, d))], axis=1), dev)
    noise = np.full((s, n), 1e-3)
    if n == 512:
        noise[:, 500:] = PAD_NOISE
    noise = _c(noise, dev)
    before = lu.counters()
    got = kernels.covariance_with_noise(points, hypers, noise, kernel)
    torch.cuda.synchronize()
    assert _launches(before).get("covariance_with_noise", 0) == 1
    torch.testing.assert_close(
        got, kernels.covariance_with_noise_plain(points, hypers, noise,
                                                 kernel),
        rtol=2e-4, atol=2e-5)
    assert torch.equal(got, got.transpose(-1, -2))


def test_use_pallas_argument_closes_c_for_one_call(dev, rng):
    """``build_covariance_matrix_with_noise(use_pallas=)``: "auto" launches
    C once, "never" takes the plain build with no launch, within C's
    tolerance of "auto"; "always" raises ``ValueError``."""
    from cornell_moe_tpu_torch.models import covariance as cov_mod
    cov = cov_mod.make_covariance("matern_2.5", _c(np.concatenate(
        [0.5 + rng.random((4, 1)), 0.2 + rng.random((4, 2))], axis=1), dev))
    points, noise = _c(rng.random((100, 2)), dev), _c(np.full((4, 1), 1e-3),
                                                      dev)
    out = {}
    for value in ("auto", "never"):
        before = lu.counters()
        out[value] = cov_mod.build_covariance_matrix_with_noise(
            cov, points, (), noise, use_pallas=value)
        torch.cuda.synchronize()
        assert _launches(before).get("covariance_with_noise", 0) == (
            value == "auto")
    torch.testing.assert_close(out["never"], out["auto"], rtol=2e-4,
                               atol=2e-5)
    with pytest.raises(ValueError):
        cov_mod.build_covariance_matrix_with_noise(cov, points, (), noise,
                                                   use_pallas="always")


@pytest.mark.parametrize("w", [8, 16])
def test_lml_kernel_at_the_cfkg_chain_shapes(dev, rng, w):
    """B at the cf-KG chain's shapes: W 8 (a half-ensemble) and 16, Np 512
    with 500 real points and the chain's padding (the first point repeated
    with PAD_NOISE, every row counted as the chain counts them), d 3,
    Matern: against the plain version in float32 and
    float64 at rtol 5e-4 and the large-Np instance at rtol 1e-6."""
    np_, n_real, d = 512, 500, 3
    x = rng.random((np_, d)) * [15.0, 20.0, 0.95] + [0.0, -5.0, 0.05]
    x[n_real:] = x[0]
    lengths = (0.3 + 0.4 * rng.random((w, d))) * [15.0, 20.0, 0.95]
    noise = np.full((w, np_), 1e-2)
    noise[:, n_real:] = PAD_NOISE
    y = np.zeros((w, np_))
    y[:, :n_real] = np.sin(x[:n_real, 0] / 3.0) + x[:n_real, 2]
    args = [_c(a, dev) for a in (x.T[None] / lengths[:, :, None],
                                 0.8 + rng.random(w), noise, y)]
    before = lu.counters()
    got = kernels.lml_fused(*args, np_, "matern_2.5")
    torch.cuda.synchronize()
    assert _launches(before).get("lml_fused", 0) == 1
    ref = kernels.lml_fused_plain(*args, np_, "matern_2.5")
    ref_64 = kernels.lml_fused_plain(*[a.double() for a in args], np_,
                                     "matern_2.5")
    large = kernels.lml_fused_global(*args, np_, "matern_2.5")
    for g, r, r64, big in zip(got, ref, ref_64, large):
        torch.testing.assert_close(g, r, rtol=5e-4, atol=0.0)
        torch.testing.assert_close(g.double(), r64, rtol=5e-4, atol=0.0)
        torch.testing.assert_close(g, big, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("n", [516, 520])
def test_covariance_kernel_at_the_heuristic_refit_shapes(dev, rng, kernel,
                                                         n):
    """C at heuristic q-EI's refit of one GP (S 1, d 2): the main path's
    500 points bucketed to 512 with 12 PAD_NOISE rows, then n - 512
    fantasy slots (PAD_NOISE until filled, one filled at 1e-3): against
    the plain version, symmetric bit for bit, one launch."""
    points = _c(rng.random((n, 2)) * [15.0, 20.0] + [0.0, -5.0], dev)
    hypers = _c([[1.3, 4.0, 6.0]], dev)
    noise = np.full((1, n), 1e-2)
    noise[:, 500:] = PAD_NOISE
    noise[:, 512] = 1e-3
    noise = _c(noise, dev)
    before = lu.counters()
    got = kernels.covariance_with_noise(points, hypers, noise, kernel)
    torch.cuda.synchronize()
    assert _launches(before).get("covariance_with_noise", 0) == 1
    torch.testing.assert_close(
        got, kernels.covariance_with_noise_plain(points, hypers, noise,
                                                 kernel),
        rtol=2e-4, atol=2e-5)
    assert torch.equal(got, got.transpose(-1, -2))


def test_map_fit_launches_no_lml_kernel_on_the_card(dev, rng):
    """optimize() on the card in float32 takes the plain log posterior:
    no launch of B, while the chain's log posterior on the same data
    launches it and the MAP member's fit launches C."""
    from cornell_moe_tpu_torch.models.mcmc import \
        GaussianProcessLogLikelihoodMCMC
    from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

    x = rng.random((40, 2))
    data = HistoricalData(2)
    data.append_historical_data(x, np.sin(3 * x[:, 0]) + x[:, 1])
    model = GaussianProcessLogLikelihoodMCMC(
        data, bucket=16, n_hypers=8, standardize=True, device=dev,
        dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(0))
    before = lu.counters()
    model.optimize(num_restarts=2)
    torch.cuda.synchronize()
    counts = _launches(before)
    assert counts.get("lml_fused", 0) == \
        counts.get("lml_fused_global", 0) == 0
    assert counts.get("covariance_with_noise", 0) > 0
    assert model.num_mcmc == 1 and np.isfinite(model.hypers).all()
    model.compute_log_likelihood(model.hypers[0])
    torch.cuda.synchronize()
    assert _launches(before).get("lml_fused", 0) == 1
