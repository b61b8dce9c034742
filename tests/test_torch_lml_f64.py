"""Kernel B's float64 instance on the card: against the plain version in
float64, its failed factorizations, the instance the wrapper takes by Np
and dtype, the layout the kernel uses, the chain's captured segment and
its launches, and its SASS.

A float64 model on the card sends its walkers to B's float64 instance
(``models/mcmc.py`` ``uses_lml_kernel``): the cluster instance up to Np
384, above it the large-Np instance (K in the L2-resident scratch; the
benchmark's Np 512 among them).  quad and logdet are held to the plain
version's (``cholesky_ex`` and a triangular solve, float64) at rtol 1e-10:
two float64 factorizations of a K whose condition number is about 1e5
part by about that times the float64 epsilon.  They need a CUDA card
(marker ``cuda``) and skip without one.  On the card, without JAX:

    python -m pytest tests/test_torch_lml_f64.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.models.mcmc import PAD_NOISE
from cornell_moe_tpu_torch.ops import kernels, programs
from cornell_moe_tpu_torch.utils import logging_utils as lu
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

pytestmark = pytest.mark.cuda
F64 = torch.float64
COVARIANCES = ["matern_2.5", "square_exponential"]
RTOL = 1e-10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _c(a, dev, dtype=F64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


def _lml_inputs(rng, w, d, np_, n_real, noise_level=1e-2):
    """Walkers of random length scales on n_real points in the unit cube,
    and the log posterior's padding: columns at huge distinct offsets with
    PAD_NOISE."""
    lengths = 0.3 + 0.4 * rng.random((w, d))
    x = rng.random((n_real, d))
    us = np.empty((w, d, np_))
    us[:, :, :n_real] = x.T[None] / lengths[:, :, None]
    us[:, :, n_real:] = 1e6 * (np.arange(np_ - n_real) + 1.0)
    alpha = 0.5 + rng.random(w)
    noise = np.full((w, np_), noise_level)
    noise[:, n_real:] = PAD_NOISE
    y = np.zeros((w, np_))
    y[:, :n_real] = np.sin(3 * x[:, 0]) + x[:, -1]
    return us, alpha, noise, y


def _launches(before):
    """Each kernel's launches since ``before`` (an ``lu.counters()``
    snapshot): the growth of its counter ``kernels.<name>``."""
    return {n[len("kernels."):]: v for n, v in lu.growth(before).items()
            if n.startswith("kernels.")}


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("np_", [96, 384, 416, 512, 520, 768, 896])
@pytest.mark.parametrize("w", [1, 8, 16])
def test_float64_instance_matches_plain(dev, rng, kernel, np_, w):
    """Np <= 384 takes the float64 cluster instance (which must equal the
    large-Np instance bit for bit there), above it the large-Np instance
    (520: a ragged last panel; 896: the gate's upper end, the panel column
    still on chip); n_real = Np - 7.  One launch of the float64 counter
    each time, outputs in float64."""
    d, n_real = 3, np_ - 7
    args = [_c(a, dev) for a in _lml_inputs(rng, w, d, np_, n_real)]
    instance = kernels.lml_fused_instance(np_, 8)
    assert instance == ("cluster" if np_ <= 384 else "global")
    before = lu.counters()
    got = kernels.lml_fused(*args, n_real, kernel)
    torch.cuda.synchronize()
    counter = "lml_fused_f64" if instance == "cluster" else \
        "lml_fused_global_f64"
    assert _launches(before) == {counter: 1}
    ref = kernels.lml_fused_plain(*args, n_real, kernel)
    for g, r in zip(got, ref):
        assert g.dtype == F64 and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, r, rtol=RTOL, atol=0.0)
    if instance == "cluster":
        for g, r in zip(got, kernels.lml_fused_global(*args, n_real,
                                                      kernel)):
            assert torch.equal(g, r)


@pytest.mark.parametrize("np_,bad_row", [(384, 0), (384, 300), (512, 101),
                                         (520, 515), (1008, 1000)],
                         ids=["cluster_first_tile", "cluster_cta1_row",
                              "large_np", "ragged_last_panel",
                              "large_np_panel_off_chip"])
def test_float64_failure_is_nan(dev, rng, np_, bad_row):
    """Walkers whose K is not positive definite get NaN in both outputs,
    as the plain float64 version's failed factorization; the others agree
    with it at rtol 1e-10."""
    w, d, n_real = 4, 2, np_ - 4
    us, alpha, noise, y = _lml_inputs(rng, w, d, np_, n_real)
    noise[[1, 3], bad_row] = -10.0
    args = [_c(a, dev) for a in (us, alpha, noise, y)]
    got = kernels.lml_fused(*args, n_real)
    ref = kernels.lml_fused_plain(*args, n_real)
    for g, r in zip(got, ref):
        assert bool(torch.isnan(g[[1, 3]]).all())
        assert bool(torch.isnan(r[[1, 3]]).all())
        torch.testing.assert_close(g[[0, 2]], r[[0, 2]], rtol=RTOL,
                                   atol=0.0)


def test_float64_layout_and_instance_choice(dev, rng):
    """The kernel's float64 layout is the one the wrapper sizes its choice
    by; the instance follows from (Np, dtype): at Np 384 float64 takes the
    cluster instance, at 416 and 512 the large-Np one, while float32 keeps
    the cluster instance at 512; the benchmark's half-ensemble fits at
    once.  Mixed dtypes are refused."""
    lib = kernels._lib()
    for np_ in (96, 384):
        assert lib.cmoe_lml_fused_cluster_smem_bytes_f64(np_) == \
            kernels.lml_cluster_smem_bytes(np_, itemsize=8)
    for np_ in (416, 512, 768, 896, 912, 1008):
        assert lib.cmoe_lml_fused_global_smem_bytes_f64(np_) == \
            kernels.lml_global_smem_bytes(np_, 8)
        assert lib.cmoe_lml_fused_global_scratch_f64(np_) == \
            kernels.lml_global_scratch_floats(np_, 8)
    assert lib.cmoe_lml_fused_global_smem_bytes_f64(512) == 132_128
    assert kernels.lml_global_occupancy(8, 512, 8) >= 8
    for np_, dtype, counter in ((384, F64, "lml_fused_f64"),
                                (416, F64, "lml_fused_global_f64"),
                                (512, F64, "lml_fused_global_f64"),
                                (512, torch.float32, "lml_fused")):
        args = [_c(a, dev, dtype) for a in _lml_inputs(rng, 2, 2, np_,
                                                       np_)]
        before = lu.counters()
        kernels.lml_fused(*args, np_)
        torch.cuda.synchronize()
        assert _launches(before) == {counter: 1}
    us, alpha, noise, y = [_c(a, dev) for a in _lml_inputs(rng, 2, 2, 64,
                                                           64)]
    with pytest.raises(TypeError):
        kernels.lml_fused(us, alpha.float(), noise, y, 64)


def test_float64_instances_use_no_float32_arithmetic(dev):
    """The float64 instantiations of the kernel (cluster, large-Np, and
    large-Np with the panel column off chip) hold DFMA and no float32 or
    TF32 arithmetic: no FFMA, FADD, FMUL, float32 conversion, tensor-core
    product or float32 special function (the float64 ones start from
    MUFU.RSQ64H and MUFU.RCP64H)."""
    from cornell_moe_tpu_torch.ops import _build
    from cornell_moe_tpu_torch.tools import sass_loops

    funcs = sass_loops.disassemble(_build.build())
    f64 = {n: c for n, c in funcs.items()
           if "cmoe_lml_fused_cluster_kernelId" in n}
    f32 = {n: c for n, c in funcs.items()
           if "cmoe_lml_fused_cluster_kernelIf" in n}
    assert len(f64) == 3 and len(f32) == 3
    for name, code in f64.items():
        ops = {op for _, op, _ in code}
        assert "DFMA" in ops and "MUFU.RSQ64H" in ops, name
        bad = {op for op in ops
               if op.split(".")[0] in ("FFMA", "FADD", "FMUL", "F2F", "HMMA",
                                       "FMNMX", "FCHK")
               or (op.startswith("MUFU") and not op.endswith("64H"))}
        assert not bad, (name, sorted(bad))


def _f64_model(dev, n=500):
    """A float64 model on the card at the benchmark's Np (500 points
    bucketed to 512): 16 walkers, the whole chain of 64 steps after a
    64-step burn-in."""
    rng = np.random.default_rng(0)
    x = rng.random((n, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2 + 0.01 * rng.standard_normal(n)
    data = HistoricalData(2)
    data.append_historical_data(x, y)
    return tmcmc.GaussianProcessLogLikelihoodMCMC(
        data, n_hypers=16, noisy=True, bucket=16, standardize=True,
        chain_gate_tol=None, burnin_steps=64, chain_length=64, device=dev,
        dtype=F64, generator=torch.Generator(device=dev).manual_seed(0))


def _chain_replays(cache) -> int:
    return sum(p.replays for k, p in cache.programs().items()
               if k[0] == "chain")


def test_captured_float64_chain_segment_counts_its_launches(dev,
                                                            monkeypatch):
    """A float64 retrain at Np 512 runs its 64-step chain as one captured
    segment: its replay counts 128 launches of B's float64 large-Np
    instance (one half-ensemble of 8 walkers a half-step) and the chain's
    start one more (16 walkers), nothing else; the walkers equal
    CAPTURE = "never"'s bit for bit, with the same launches."""
    out = []
    for capture in ("auto", "never"):
        monkeypatch.setattr(programs, "CAPTURE", capture)
        model = _f64_model(dev)
        model.train()
        torch.cuda.synchronize()
        replays = _chain_replays(model.program_cache)
        before = lu.counters()
        model.train()
        torch.cuda.synchronize()
        assert _launches(before) == {"lml_fused_global_f64": 129}
        assert _chain_replays(model.program_cache) - replays == \
            (1 if capture == "auto" else 0)
        out.append(model.p0.cpu().numpy())
    np.testing.assert_array_equal(out[0], out[1])


def test_float64_log_posterior_through_the_kernel_and_never(dev,
                                                            monkeypatch):
    """The float64 log posterior of 16 walkers launches B's float64
    instance once under LML_PALLAS "auto" and nothing under "never" (the
    plain LML), with the same values at rtol 1e-10 (-inf where both are);
    the MAP fit's force_plain launches nothing."""
    model = _f64_model(dev)
    x, y, pn = model._padded_data()
    thetas = model.prior.sample_from_prior(
        torch.Generator(device=dev).manual_seed(1), 16, device=dev,
        dtype=F64).clamp(-5.0, 5.0)
    before = lu.counters()
    via_kernel = model.log_posterior(thetas, x, y, pn)
    torch.cuda.synchronize()
    assert _launches(before) == {"lml_fused_global_f64": 1}
    before = lu.counters()
    forced = model.log_posterior(thetas, x, y, pn, force_plain=True)
    monkeypatch.setattr(tmcmc, "LML_PALLAS", "never")
    plain = model.log_posterior(thetas, x, y, pn)
    torch.cuda.synchronize()
    assert _launches(before) == {}
    assert torch.equal(forced, plain)
    fin = torch.isfinite(plain)
    assert bool(fin.any())
    assert torch.equal(torch.isfinite(via_kernel), fin)
    torch.testing.assert_close(via_kernel[fin], plain[fin], rtol=RTOL,
                               atol=0.0)
