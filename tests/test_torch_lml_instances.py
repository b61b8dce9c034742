"""Kernel B's two instances: which one the wrapper takes at each Np, the
shared-memory and scratch counts that decide and size them, and the
model's gate, held to the JAX package's window.

The cluster instance keeps K's lower triangle in the 8 CTAs of a cluster,
32 x 32 tiles, tile row i in CTA i mod 8; beside its tiles each CTA holds
the panel column (Np - 32 rows), L11, z, its y slices and a 4-float
carry (``csrc/lml_fused.cu`` ``lml_layout``).  The wrapper takes it
while its fullest CTA fits in one block's 227 KB of shared memory.  Above
that the large-Np instance runs the same kernel with the tiles in a
global scratch (one region of the fullest CTA's size per CTA and walker)
and only the panel column and the small buffers on chip, up to Np = 1792;
above that the panel column joins the scratch (one copy per walker).
Float64 inputs launch the same kernel's float64 instance, whose elements
take 8 bytes: its cluster instance fits up to Np = 384, its large-Np
instance keeps the panel column on chip up to Np = 896.  These run on the
CPU: the choice depends on Np and the dtype alone, and a CPU tensor takes
the plain version.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import pallas_kernels as pk
from cornell_moe_tpu.utils.data_containers import HistoricalData as JHist
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import kernels
from cornell_moe_tpu_torch.utils import logging_utils as lu

torch.set_num_threads(1)
F64 = torch.float64
CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"


def test_instance_chosen_by_np_alone():
    cap = kernels.LML_CLUSTER_CAPACITY
    assert cap == kernels.lml_cluster_capacity() == 640
    assert all(kernels.lml_fused_instance(n) == "cluster"
               for n in range(1, cap + 1))
    assert all(kernels.lml_fused_instance(n) == "global"
               for n in range(cap + 1, 2048))
    assert all(kernels.lml_global_pbuf_on_chip(n) == (n <= 1792)
               for n in range(cap + 1, 2048))
    assert kernels.lml_cluster_smem_bytes(cap) <= kernels.SMEM_PER_BLOCK \
        < kernels.lml_cluster_smem_bytes(cap + 1)
    assert kernels.SMEM_PER_BLOCK == 227 * 1024


@pytest.mark.parametrize("np_,cluster,tiles,rows", [
    (512, 8, 24, 2),     # CTA 7 holds tile rows 7 and 15: 8 + 16 tiles
    (520, 8, 27, 3),     # 17 tile rows; CTA 0 holds 0, 8, 16: 1 + 9 + 17
    (608, 8, 33, 3),     # CTA 2 holds 2, 10, 18: 3 + 11 + 19
    (640, 8, 36, 3),     # CTA 3 holds 3, 11, 19: 4 + 12 + 20
    (672, 8, 39, 3),     # CTA 4 holds 4, 12, 20: 5 + 13 + 21
    (512, 16, 16, 1),    # CTA 15 holds tile row 15 alone
    (100, 8, 4, 1)])     # 4 tile rows; CTAs 4-7 hold none
def test_cluster_smem_bytes_count_the_fullest_cta(np_, cluster, tiles,
                                                  rows):
    nt = -(-np_ // 32)
    floats = (tiles + nt - 1) * 1024 + 32 * 33 + 32 + rows * 32 + 4
    assert kernels.lml_cluster_smem_bytes(np_, cluster) == 4 * floats


def test_python_constants_match_the_kernel_source():
    src = (CSRC / "lml_fused.cu").read_text()
    defines = dict(re.findall(r"#define (LML_\w+) (\d+)", src))
    assert int(defines["LML_PANEL"]) == kernels.LML_PANEL
    assert int(defines["LML_CLUSTER"]) == kernels.LML_CLUSTER


def test_cpu_tensors_take_the_plain_version_at_either_instance():
    rng = np.random.default_rng(0)
    before = lu.counters()
    for np_ in (40, kernels.LML_CLUSTER_CAPACITY + 8, 1800):
        x = rng.random((2, np_))
        us = torch.as_tensor(x[None] / 0.4, dtype=torch.float32)
        args = (us, torch.ones(1), torch.full((1, np_), 1e-2),
                torch.as_tensor(np.sin(3 * x[:1]), dtype=torch.float32),
                np_ - 3)
        ref = kernels.lml_fused_plain(*args)
        for fn in (kernels.lml_fused, kernels.lml_fused_global):
            for g, r in zip(fn(*args), ref):
                torch.testing.assert_close(g, r, rtol=0.0, atol=0.0)
    assert lu.growth(before).get("kernels.lml_fused", 0) == 0
    assert lu.growth(before).get("kernels.lml_fused_global", 0) == 0


@pytest.mark.parametrize("np_,tiles,pbuf_on_chip", [
    (672, 39, True),      # 21 tile rows; CTA 4 holds 4, 12, 20: 5 + 13 + 21
    (768, 48, True),      # 24 tile rows; CTA 7 holds 7, 15, 23: 8 + 16 + 24
    (896, 64, True),      # 28 tile rows; CTA 3 holds 3, 11, 19, 27
    (1008, 80, True),     # 32 tile rows; CTA 7 holds 7, 15, 23, 31
    (1792, 224, True),    # 56 tile rows: the last panel column on chip
    (1793, 232, False),   # 57 tile rows; CTA 0 holds 0, 8, ..., 56
    (1824, 232, False)])
def test_global_instance_smem_and_scratch_counts(np_, tiles, pbuf_on_chip):
    """The large-Np instance's shared memory per CTA (the panel column
    while it fits, L11, z, CTA 0's y slices, the carry) and its scratch per
    walker (8 regions of the fullest CTA's tiles, and the panel column
    where it is off chip)."""
    nt = -(-np_ // 32)
    assert kernels.lml_cta_tiles(np_) == tiles
    assert kernels.lml_global_pbuf_on_chip(np_) == pbuf_on_chip
    pbuf = nt - 1 if pbuf_on_chip else 0
    rows0 = len(range(0, nt, 8))
    smem = 4 * (pbuf * 1024 + 32 * 33 + 32 + rows0 * 32 + 4)
    assert kernels.lml_global_smem_bytes(np_) == smem <= \
        kernels.SMEM_PER_BLOCK
    assert kernels.lml_global_scratch_floats(np_) == \
        (8 * tiles + (0 if pbuf_on_chip else nt - 1)) * 1024
    # the cluster instance's count holds the same tiles on chip
    assert kernels.lml_cluster_smem_bytes(np_) == \
        4 * (tiles + nt - 1) * 1024 + 4 * (32 * 33 + 32 + rows0 * 32 + 4)


def test_global_instance_scratch_stays_in_l2_at_the_gate():
    """Up to the gate's upper end (Np 896) the scratch of the main path's
    half-ensemble (W = 8) fits the H100's 50 MB L2: 12.6 MB at Np 768."""
    assert 8 * 4 * kernels.lml_global_scratch_floats(768) == 12_582_912
    assert 8 * 4 * kernels.lml_global_scratch_floats(
        tmcmc.LML_MAX_OBS) < 50 * 10**6


def _jax_takes_lml_kernel(monkeypatch, n_obs: int) -> bool:
    """Whether the JAX package's chain log posterior sends a float32
    walker batch at ``n_obs`` observations to its fused LML kernel (its
    ``LML_PALLAS`` "always" makes the CPU take the TPU's route; the kernel
    is replaced by a recorder)."""
    calls = []

    def recorder(us, alphas, nv, yb, kernel_name, n_real, wb):
        calls.append(us.shape)
        w = us.shape[0]
        return jnp.zeros((w,), jnp.float32), jnp.zeros((w,), jnp.float32)

    monkeypatch.setattr(jmcmc, "LML_PALLAS", "always")
    monkeypatch.setattr(pk, "pallas_lml_fused", recorder)
    rng = np.random.default_rng(n_obs)
    x = rng.random((n_obs, 2))
    data = JHist(2)
    data.append_historical_data(x[:4], np.sin(3 * x[:4, 0]))
    model = jmcmc.GaussianProcessLogLikelihoodMCMC(data, n_hypers=2)
    thetas = jnp.asarray(0.1 * rng.standard_normal((2, 4)), jnp.float32)
    model._log_posterior_with_data()(
        thetas, jnp.asarray(x, jnp.float32),
        jnp.asarray(np.sin(3 * x[:, :1]), jnp.float32), None)
    return bool(calls)


@pytest.mark.parametrize("n_obs", [880, 896, 897, 912])
def test_lml_gate_window_matches_jax(monkeypatch, n_obs):
    """Kernel B's gate closes above 896 observations, as the JAX package's
    (``models/mcmc.py``: the plain LML for n_obs > 896); the kernel itself
    takes any Np."""
    expected = _jax_takes_lml_kernel(monkeypatch, n_obs)
    assert expected == (n_obs <= 896)
    assert tmcmc.uses_lml_kernel("cuda", torch.float32, (), n_obs) == \
        expected
    assert not tmcmc.uses_lml_kernel("cpu", torch.float32, (), n_obs)


def test_float64_instance_chosen_by_np_and_dtype():
    """At 8 bytes an element the cluster instance fits up to Np 384 (at
    Np 512 its fullest CTA would need 328,736 B), and the large-Np
    instance keeps its panel column on chip up to Np 896, the gate's upper
    end; float32 keeps its own instances at the same Np."""
    cap = kernels.lml_cluster_capacity(itemsize=8)
    assert cap == 384 and kernels.lml_cluster_capacity(itemsize=4) == 640
    assert all(kernels.lml_fused_instance(n, 8) == "cluster"
               for n in range(1, cap + 1))
    assert all(kernels.lml_fused_instance(n, 8) == "global"
               for n in range(cap + 1, 2048))
    assert all(kernels.lml_global_pbuf_on_chip(n, 8) == (n <= 896)
               for n in range(cap + 1, 2048))
    assert kernels.lml_cluster_smem_bytes(cap, itemsize=8) <= \
        kernels.SMEM_PER_BLOCK < kernels.lml_cluster_smem_bytes(
            cap + 1, itemsize=8)
    assert kernels.lml_cluster_smem_bytes(512, itemsize=8) == 328_736
    assert kernels.lml_fused_instance(512, 8) == "global"
    assert kernels.lml_fused_instance(512, 4) == "cluster"
    assert tmcmc.LML_MAX_OBS == 896


@pytest.mark.parametrize("np_,tiles,pbuf_on_chip", [
    (416, 18, True),      # 13 tile rows; CTA 4 holds 4, 12: 5 + 13
    (512, 24, True),      # the benchmark's Np: 132,128 B a CTA
    (520, 27, True),
    (768, 48, True),
    (896, 64, True),      # the gate's upper end: the panel column on chip
    (912, 68, False),     # 29 tile rows; CTA 4 holds 4, 12, 20, 28
    (1008, 80, False)])
def test_float64_global_instance_smem_and_scratch_counts(np_, tiles,
                                                         pbuf_on_chip):
    """The float64 large-Np instance's layout is float32's in elements, at
    8 bytes each: the panel column while it fits, L11, z, CTA 0's y slices
    and the carry in shared memory, 8 regions of the fullest CTA's tiles
    (and the panel column where it is off chip) in the scratch."""
    nt = -(-np_ // 32)
    pbuf = nt - 1 if pbuf_on_chip else 0
    rows0 = len(range(0, nt, 8))
    assert kernels.lml_cta_tiles(np_) == tiles
    assert kernels.lml_global_pbuf_on_chip(np_, 8) == pbuf_on_chip
    smem = 8 * (pbuf * 1024 + 32 * 33 + 32 + rows0 * 32 + 4)
    assert kernels.lml_global_smem_bytes(np_, 8) == smem <= \
        kernels.SMEM_PER_BLOCK
    assert kernels.lml_global_scratch_floats(np_, 8) == \
        (8 * tiles + (0 if pbuf_on_chip else nt - 1)) * 1024


def test_float64_instance_at_the_benchmark_shape():
    """At Np 512 in float64 (the chain's half-ensemble W 8, the start's W
    16) B takes the large-Np instance: 132,128 B of shared memory a CTA,
    a scratch of 12.6 MB at W 8 and 25.2 MB at W 16, inside the 50 MB L2
    up to the gate's Np 896 at W 8."""
    assert kernels.lml_global_smem_bytes(512, 8) == 132_128
    assert 8 * 8 * kernels.lml_global_scratch_floats(512, 8) == 12_582_912
    assert 16 * 8 * kernels.lml_global_scratch_floats(512, 8) == 25_165_824
    assert 8 * 8 * kernels.lml_global_scratch_floats(
        tmcmc.LML_MAX_OBS, 8) < 50 * 10**6


@pytest.mark.parametrize("n_obs", [880, 896, 897, 912])
def test_float64_lml_gate_window(monkeypatch, n_obs):
    """The float64 gate has float32's window (to 896 padded
    observations), on CUDA, for value channels alone; LML_PALLAS "never"
    closes it."""
    assert tmcmc.uses_lml_kernel("cuda", torch.float64, (), n_obs) == \
        (n_obs <= 896)
    assert not tmcmc.uses_lml_kernel("cpu", torch.float64, (), n_obs)
    assert not tmcmc.uses_lml_kernel("cuda", torch.float64, (0,), n_obs)
    monkeypatch.setattr(tmcmc, "LML_PALLAS", "never")
    assert not tmcmc.uses_lml_kernel("cuda", torch.float64, (), n_obs)


def test_cpu_float64_tensors_take_the_plain_version():
    """Float64 CPU tensors take the plain version at either instance's Np
    and launch nothing: every CPU parity test stays on the plain LML."""
    rng = np.random.default_rng(1)
    before = lu.counters()
    for np_ in (40, 400, 1000):
        x = rng.random((2, np_))
        args = (torch.as_tensor(x[None] / 0.4), torch.ones(1, dtype=F64),
                torch.full((1, np_), 1e-2, dtype=F64),
                torch.as_tensor(np.sin(3 * x[:1])), np_ - 3)
        ref = kernels.lml_fused_plain(*args)
        for fn in (kernels.lml_fused, kernels.lml_fused_global):
            for g, r in zip(fn(*args), ref):
                assert g.dtype == F64
                torch.testing.assert_close(g, r, rtol=0.0, atol=0.0)
    assert lu.growth(before) == {}
