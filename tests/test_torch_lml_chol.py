"""The tiled float64 Cholesky of the chain's plain-route LML
(``ops.kernels.lml_chol_f64``, ``csrc/lml_chol_f64.cu``): its plain
version against the plain LML, the log posterior's route to it, the
wrapper's refusals, and on the card the kernel against its plain version.

``lml_chol_plain`` (``cholesky_ex``, one forward solve, the log diagonal)
gives (quad, half_logdet) with LML = -quad / 2 - half_logdet - N log(2 pi)
/ 2, the plain LML's value over the same K.  The log posterior sends a
CUDA float64 walker batch there where kernel B's gate is closed
(derivative channels, more than 896 observations) and the plain LML
elsewhere (``mcmc.lml_route``).  The card tests need a CUDA card (marker
``cuda``) and skip without one; on the card, without JAX:

    python -m pytest tests/test_torch_lml_chol.py -q --noconftest

The kernel's factorization runs in another order than cuSOLVER's, so the
two part by about K's condition number (about 1e5 here) times the float64
epsilon: quad and half_logdet are held at rtol 1e-9.
"""

import math

import numpy as np
import pytest
import torch

from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models import likelihood as lik_mod
from cornell_moe_tpu_torch.models import mcmc
from cornell_moe_tpu_torch.ops import kernels
from cornell_moe_tpu_torch.utils import logging_utils as lu
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData
from cornell_moe_tpu_torch.utils.synthetic_functions import \
    BraninWithDerivatives

F64 = torch.float64
DS = (0, 1)
RTOL = 1e-9
LOG_2PI = math.log(2.0 * math.pi)


def branin_data(n, seed=25):
    """Points (n, 2) over Branin's domain and values (n, 3): the value and
    both partials."""
    fn = BraninWithDerivatives()
    dom = fn._search_domain
    rng = np.random.default_rng(seed)
    x = rng.uniform(dom[:, 0], dom[:, 1], (n, 2))
    return x, np.stack([fn.evaluate_true(p) for p in x])


def walkers(w, seed=7):
    """Walkers (W, 6) [log a, log l (2), log noise (3)] inside the prior's
    support."""
    rng = np.random.default_rng(seed)
    return torch.tensor(np.concatenate([
        rng.uniform(-0.5, 0.5, (w, 1)), rng.uniform(-1.0, 1.0, (w, 2)),
        rng.uniform(-6.0, -2.0, (w, 3))], axis=1), dtype=F64)


def model(x, values, derivatives=DS, bucket=16, device="cpu"):
    data = HistoricalData(dim=2, num_derivatives=len(derivatives))
    data.append_sample_points(list(zip(x, values)))
    return mcmc.GaussianProcessLogLikelihoodMCMC(
        data, derivatives=derivatives, noisy=True, bucket=bucket,
        standardize=True, n_hypers=4, device=device, dtype=F64,
        generator=torch.Generator(device=device).manual_seed(0))


def padded_system(w, n=20, seed=7):
    """The d-KG log posterior's system for W walkers: n points padded to
    the 16-point bucket (``point_noise`` PAD_NOISE on the pad), scaled
    values; (covariance, noise (W, 3), x, y, point_noise)."""
    m = model(*branin_data(n))
    x, y, pn = m._padded_data()
    hyps = torch.exp(walkers(w, seed))
    cov = cov_mod.COVARIANCE_TYPES["matern_2.5"](hyperparameters=hyps[:, :3])
    return cov, hyps[:, 3:], x, y, pn


def lml_from(quad, half_logdet, n):
    return -0.5 * quad - half_logdet - 0.5 * n * LOG_2PI


# --- the plain version against the plain LML --------------------------------

@pytest.mark.parametrize("w", [1, 8, 16])
def test_plain_version_is_the_plain_lml(w):
    cov, noise, x, y, pn = padded_system(w)
    assert pn is not None and float(pn.max()) == mcmc.PAD_NOISE
    yv, k = lik_mod.training_system(cov, noise, x, y, DS, pn)
    assert k.shape == (w, 96, 96) and yv.shape == (96,)
    k0 = k.clone()
    quad, half_logdet = kernels.lml_chol_plain(k, yv)
    assert torch.equal(k, k0)
    ref = lik_mod.log_marginal_likelihood(cov, noise, x, y, DS,
                                          point_noise=pn)
    torch.testing.assert_close(lml_from(quad, half_logdet, 96), ref,
                               rtol=1e-12, atol=0)
    # the wrapper takes it on CPU tensors, y (N,) or (W, N)
    for yy in (yv, yv.expand(w, 96).contiguous()):
        got = kernels.lml_chol_f64(k, yy)
        assert torch.equal(got[0], quad) and torch.equal(got[1], half_logdet)


@pytest.mark.parametrize("w", [1, 8, 16])
def test_tiled_lml_counts_and_equals_the_plain_lml(w):
    cov, noise, x, y, pn = padded_system(w)
    before = lu.counters()
    got = lik_mod.log_marginal_likelihood_tiled(cov, noise, x, y, DS,
                                                point_noise=pn)
    assert lu.growth(before).get("model.lml_plain", 0) == w
    ref = lik_mod.log_marginal_likelihood(cov, noise, x, y, DS,
                                          point_noise=pn)
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=0)


def test_plain_version_nan_where_cholesky_fails():
    cov, noise, x, y, pn = padded_system(4)
    yv, k = lik_mod.training_system(cov, noise, x, y, DS, pn)
    k[1, 40, 40] = -1.0
    k[3].fill_diagonal_(0.0)
    quad, half_logdet = kernels.lml_chol_plain(k, yv)
    info = torch.linalg.cholesky_ex(k)[1]
    assert (info != 0).tolist() == [False, True, False, True]
    assert torch.isnan(quad).tolist() == torch.isnan(half_logdet).tolist() \
        == [False, True, False, True]


# --- the log posterior's route ----------------------------------------------

def expected_route(device, dtype, derivatives, n, force_plain, switch):
    """The rule: kernel B where its gate is open (CUDA, value channels, n
    at most 896), else the tiled Cholesky for CUDA float64, else the plain
    LML; the plain LML under force_plain or LML_PALLAS "never"."""
    if force_plain or switch == "never" or device != "cuda":
        return "plain"
    if not derivatives and n <= 896:
        return "fused"
    return "chol" if dtype == F64 else "plain"


@pytest.mark.parametrize("switch", ["auto", "never"])
@pytest.mark.parametrize("force_plain", [False, True])
@pytest.mark.parametrize("n", [512, 896, 1008])
@pytest.mark.parametrize("derivatives", [(), DS])
@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_route(monkeypatch, device, dtype, derivatives, n, force_plain,
               switch):
    monkeypatch.setattr(mcmc, "LML_PALLAS", switch)
    assert mcmc.lml_route(device, dtype, derivatives, n, force_plain) == \
        expected_route(device, dtype, derivatives, n, force_plain, switch)


def test_route_refuses_an_unknown_switch_value(monkeypatch):
    """"always" does not carry over from the JAX package (no CUDA kernel
    runs on a CPU tensor): both gates raise."""
    monkeypatch.setattr(mcmc, "LML_PALLAS", "always")
    with pytest.raises(ValueError, match="LML_PALLAS"):
        mcmc.lml_route("cuda", F64, DS, 512)
    with pytest.raises(ValueError, match="LML_PALLAS"):
        mcmc.uses_chol_kernel("cuda", F64)
    assert mcmc.lml_route("cuda", F64, DS, 512, force_plain=True) == "plain"


@pytest.mark.parametrize("switch", ["auto", "never"])
def test_log_posterior_takes_the_tiled_route(monkeypatch, switch):
    """With the gate opened on the CPU (where the wrapper runs its plain
    version) the log posterior reaches ``lml_chol_f64`` once per batch,
    equal to the plain route, unless ``LML_PALLAS`` is "never" or
    ``force_plain``; a walker whose factorization fails gets -inf."""
    m = model(*branin_data(20))
    args = m._padded_data()
    thetas = walkers(6)
    plain = m.log_posterior(thetas, *args)
    calls = []
    chol = kernels.lml_chol_f64

    def recording(k, y):
        calls.append(tuple(k.shape))
        return chol(k, y)
    monkeypatch.setattr(mcmc, "LML_PALLAS", switch)
    monkeypatch.setattr(mcmc, "uses_chol_kernel",
                        lambda device_type, dtype: switch == "auto")
    monkeypatch.setattr(lik_mod.kernels, "lml_chol_f64", recording)
    got = m.log_posterior(thetas, *args)
    assert calls == ([(6, 96, 96)] if switch == "auto" else [])
    torch.testing.assert_close(got, plain, rtol=1e-12, atol=0)
    m.log_posterior(thetas, *args, force_plain=True)
    assert len(calls) == (switch == "auto")

    def breaking(cov, noise, x, y, derivatives, point_noise=None):
        yv, k = system(cov, noise, x, y, derivatives, point_noise)
        k[2].fill_diagonal_(-1.0)
        return yv, k
    system = lik_mod.training_system
    monkeypatch.setattr(lik_mod, "training_system", breaking)
    got = m.log_posterior(thetas, *args)
    if switch == "auto":
        assert torch.isneginf(got[2]) and torch.isfinite(got).sum() == 5
        keep = torch.arange(6) != 2
        torch.testing.assert_close(got[keep], plain[keep], rtol=1e-12,
                                   atol=0)


# --- the wrapper's refusals -------------------------------------------------

@pytest.mark.parametrize("shapes", [
    ((8, 96), (96,)),            # k not (W, N, N)
    ((8, 96, 64), (96,)),        # k not square
    ((2, 8, 96, 96), (96,)),     # more than one batch axis
    ((8, 96, 96), (95,)),        # y of another side
    ((8, 96, 96), (4, 96)),      # y of other walkers
    ((8, 96, 96), (8, 96, 1)),   # y of another rank
])
def test_wrapper_refuses_a_wrong_shape(shapes):
    kshape, yshape = shapes
    with pytest.raises(ValueError):
        kernels.lml_chol_f64(torch.zeros(kshape, dtype=F64),
                             torch.zeros(yshape, dtype=F64))


def test_wrapper_refuses_an_input_that_requires_grad():
    k = torch.eye(64, dtype=F64).expand(2, 64, 64).clone()
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.lml_chol_f64(k.requires_grad_(), torch.ones(64, dtype=F64))


def test_scratch_counts():
    """Per walker and tile column 64 x 64 + 2 x 64 + 2 doubles; W nt^2
    tile counters and the queue."""
    assert kernels.lml_chol_scratch(8, 1536) == (8 * 24 * 4226,
                                                 8 * 24 * 24 + 1)
    assert kernels.lml_chol_scratch(8, 1500) == kernels.lml_chol_scratch(
        8, 1536)
    assert kernels.lml_chol_scratch(1, 64) == (4226, 2)
    assert kernels.lml_chol_scratch(16, 1008) == (16 * 16 * 4226,
                                                  16 * 16 * 16 + 1)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def card_system(dev, w, np_, derivatives, seed=3):
    """K (W, N, N) and y (N,) of the log posterior on the card: np_ random
    points in the unit square, Matern 5/2 over 1 + len(derivatives)
    channels, walkers' noise 1e-3 to 1e-2 of the amplitude."""
    rng = np.random.default_rng(seed)
    c = 1 + len(derivatives)
    x = torch.tensor(rng.uniform(0, 1, (np_, 2)), dtype=F64, device=dev)
    vals = torch.tensor(rng.normal(size=(np_, c)), dtype=F64, device=dev)
    hyps = torch.tensor(np.exp(np.concatenate([
        rng.uniform(-0.5, 0.5, (w, 1)), rng.uniform(-1.5, -0.5, (w, 2))],
        axis=1)), device=dev)
    noise = torch.tensor(np.exp(rng.uniform(-7, -4.5, (w, c))), device=dev)
    cov = cov_mod.COVARIANCE_TYPES["matern_2.5"](hyperparameters=hyps)
    return lik_mod.training_system(cov, noise, x, vals, derivatives)


@pytest.mark.cuda
@pytest.mark.parametrize("w,np_,derivatives", [
    (8, 512, DS),         # the d-KG cell's N 1536
    (16, 512, DS),
    (8, 500, DS),         # ragged: N 1500
    (8, 1008, ()),        # value-only above B's gate
])
def test_kernel_against_plain(dev, w, np_, derivatives):
    y, k = card_system(dev, w, np_, derivatives)
    ref = kernels.lml_chol_plain(k, y)
    chol = torch.linalg.cholesky_ex(k)[0]
    kk = k.clone()
    before = lu.counters()
    got = kernels.lml_chol_f64(kk, y)
    assert lu.growth(before).get("kernels.lml_chol_f64", 0) == 1
    assert all(g.dtype == F64 and g.shape == (w,) for g in got)
    torch.testing.assert_close(got[0], ref[0], rtol=RTOL, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=RTOL, atol=0)
    # factored in place: the lower triangle holds L, the rest is K's
    torch.testing.assert_close(torch.tril(kk), chol, rtol=0, atol=1e-10)
    assert torch.equal(torch.triu(kk, 1), torch.triu(k, 1))
    # y per walker
    yw = y.expand(w, -1) * torch.linspace(0.5, 2.0, w, dtype=F64,
                                          device=dev)[:, None]
    got = kernels.lml_chol_f64(k.clone(), yw.contiguous())
    torch.testing.assert_close(got[0], kernels.lml_chol_plain(k, yw)[0],
                               rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_kernel_nan_where_cholesky_fails(dev):
    """A negative pivot fails ``cholesky_ex`` (its info); a NaN entry does
    not, but its NaN reaches the plain version's results: the kernel gives
    NaN for those four walkers and the plain values elsewhere."""
    y, k = card_system(dev, 8, 512, DS)
    for w, i in [(1, 3), (4, 700), (6, 1535)]:
        k[w, i, i] = -1.0
    k[7, 100, 100] = float("nan")
    ref = kernels.lml_chol_plain(k, y)
    got = kernels.lml_chol_f64(k.clone(), y)
    info = torch.linalg.cholesky_ex(k)[1] != 0
    assert info.tolist() == [i in (1, 4, 6) for i in range(8)]
    failed = torch.isnan(ref[1])
    assert failed.tolist() == [i in (1, 4, 6, 7) for i in range(8)]
    for g, r in zip(got, ref):
        assert torch.equal(torch.isnan(g), failed)
        torch.testing.assert_close(g[~failed], r[~failed], rtol=RTOL,
                                   atol=0)


@pytest.mark.cuda
def test_kernel_inputs_refused_on_the_card(dev):
    y, k = card_system(dev, 2, 64, ())
    with pytest.raises(TypeError):
        kernels.lml_chol_f64(k.float(), y.float())
    with pytest.raises(TypeError):
        kernels.lml_chol_f64(k, y.float())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.lml_chol_f64(k.transpose(1, 2), y)
    with pytest.raises(ValueError, match="several devices"):
        kernels.lml_chol_f64(k, y.cpu())


@pytest.mark.cuda
def test_kernel_graph_replay_equals_eager(dev):
    y, k0 = card_system(dev, 8, 512, DS)
    eager = kernels.lml_chol_f64(k0.clone(), y)
    k = k0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.lml_chol_f64(k.clone(), y)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.lml_chol_f64(k.clone(), y)
    for _ in range(3):
        k.copy_(k0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1],
                                                             eager[1])


@pytest.mark.cuda
def test_value_only_chain_above_b_gate_takes_the_kernel(dev):
    """A float64 value-only model of 900 points (912 padded, above B's
    896) sends its log posterior to the tiled Cholesky, equal to the
    plain LML (``force_plain``)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (900, 2))
    values = (np.sin(5 * x[:, 0]) + x[:, 1])[:, None]
    m = model(x, values, derivatives=(), device=str(dev))
    args = m._padded_data()
    assert args[0].shape[0] == 912
    thetas = torch.cat([walkers(8)[:, :3], walkers(8)[:, 3:4]],
                       dim=1).to(dev)
    before = lu.counters()
    got = m.log_posterior(thetas, *args)
    grew = lu.growth(before)
    assert grew.get("kernels.lml_chol_f64", 0) == 1
    assert grew.get("kernels.lml_fused_global_f64", 0) == 0
    ref = m.log_posterior(thetas, *args, force_plain=True)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=0)
