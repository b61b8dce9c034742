"""Kernel B's two instances: which one the wrapper takes at each Np, and
the shared-memory count that decides it.

The cluster instance keeps K's lower triangle in the 8 CTAs of a cluster,
32 x 32 tiles, tile row i in CTA i mod 8; beside its tiles each CTA holds
the panel column (Np - 32 rows), L11, z, its y slices and a 4-float
carry (``csrc/lml_fused.cu`` ``lml_layout``).  The wrapper takes it
while its fullest CTA fits in one block's 227 KB of shared memory, and the
one-block-per-walker instance above that.  These run on the CPU: the
choice depends on Np alone, and a CPU tensor takes the plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cornell_moe_tpu_torch.ops import kernels

torch.set_num_threads(1)
CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"


def test_instance_chosen_by_np_alone():
    cap = kernels.LML_CLUSTER_CAPACITY
    assert cap == kernels.lml_cluster_capacity() == 640
    assert all(kernels.lml_fused_instance(n) == "cluster"
               for n in range(1, cap + 1))
    assert all(kernels.lml_fused_instance(n) == "global"
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
    kernels.reset_launch_counts()
    for np_ in (40, kernels.LML_CLUSTER_CAPACITY + 8):
        x = rng.random((2, np_))
        us = torch.as_tensor(x[None] / 0.4, dtype=torch.float32)
        args = (us, torch.ones(1), torch.full((1, np_), 1e-2),
                torch.as_tensor(np.sin(3 * x[:1]), dtype=torch.float32),
                np_ - 3)
        ref = kernels.lml_fused_plain(*args)
        for fn in (kernels.lml_fused, kernels.lml_fused_global):
            for g, r in zip(fn(*args), ref):
                torch.testing.assert_close(g, r, rtol=0.0, atol=0.0)
    assert kernels.launch_counts()["lml_fused"] == 0
    assert kernels.launch_counts()["lml_fused_global"] == 0
