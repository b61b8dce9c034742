"""Kernel A's tensor-core instance on the CPU: which instance the wrapper
takes at each shape, and a float32 emulation of the instance's arithmetic
held to the rule ``chip_smoke.py`` applies on the card.

The emulation (here, not in the package) follows ``csrc/descent_run_mma.cu``:
each operand x of the moment contraction a = W phi splits into
hi = x rounded to TF32 (13 low mantissa bits cleared, to nearest, ties away
from zero) and lo = x - hi read as TF32 (its 13 low bits dropped); per
8-point k-tile the three products hi*hi + hi*lo + lo*hi are summed exactly
and added to a float32 accumulator; the direction, the clamped step and the
Polyak averaging are ``kernels.descent_run_plain``'s.  On an ensemble fitted
at Np = 130 (a ragged last k-tile), S 2, B 8, M 32, d 2, q 4, both fields,
cold and warm, the emulated descent must stay within the per-quantile rule
of ``chip_smoke.py``: at every quantile of the endpoints' deviation from the
float64 descent (domain-width units), at most max(5e-5, 1.5 x the float32
plain descent's own).  A CPU tensor takes the plain version, so nothing here
launches a kernel.

The emulation covers the contraction only.  Its field phi is the exact
``unit_p``, where the kernel takes ``rsqrt.approx`` and ``ex2.approx``.  At
this size the rule's largest deviation is one draw whose clamped step
flips, and a change of phi by a float32 rounding or two moves that draw
either way: an emulated approximation would test the draw, not the design.
The approximations meet the rule only on the card (``chip_smoke.py`` at
the main path's size, and ``tests/test_torch_cuda_kernels.py``).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
from cornell_moe_tpu_torch.acquisition.expected_improvement import \
    draw_antithetic_normals
from cornell_moe_tpu_torch.bayes_opt import DEFAULT_SGD_PARAMS_PS
from cornell_moe_tpu_torch.models import mcmc
from cornell_moe_tpu_torch.ops import kernels, linalg

torch.set_num_threads(1)
CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
S, B, M, NP, D, Q = 2, 8, 32, 130, 2, 4


# kernel A's and kernel D's instance choices: D stages A's operands
INSTANCE_CHOICES = pytest.mark.parametrize(
    "choose", [kernels.descent_run_instance, kernels.descent_grad_instance],
    ids=["descent_run", "descent_grad"])


@INSTANCE_CHOICES
@pytest.mark.parametrize("d,q,instance", [(2, 4, "mma"), (3, 3, "mma"),
                                          (2, 5, "fma")],
                         ids=["wr15", "wr16", "wr18"])
def test_instance_chosen_by_moment_rows(choose, d, q, instance):
    assert choose(d, q, 512) == instance


@INSTANCE_CHOICES
def test_instance_falls_back_to_fma_above_the_shared_memory(choose):
    """The tensor-core instances stage the Wr W rows and ws per block; past
    one block's shared memory the wrappers take the FMA instances."""
    last = max(n for n in range(8, 4096, 8)
               if kernels.descent_mma_smem_bytes(2, 4, n) <=
               kernels.SMEM_PER_BLOCK)
    assert choose(2, 4, last) == "mma"
    assert choose(2, 4, last + 1) == "fma"


def test_main_path_block_fits_five_times_on_an_sm():
    """15 W rows at stride 520 (8 mod 32), ws (2, 512), 16 floats of union
    points and 4 warps' 15 x 40 exchange buffers: 44,960 bytes, so five
    blocks and their 1 KB reserves fit in an SM's 228 KB."""
    smem = kernels.descent_mma_smem_bytes(2, 4, 512)
    assert smem == 4 * (15 * 520 + 2 * 512 + 16 + 4 * 15 * 40) == 44_960
    assert 5 * (smem + 1024) <= 228 * 1024 < 6 * (smem + 1024)


def test_python_constants_match_the_kernel_source():
    """Each MMA_* constant that the instance choice reads is defined once
    in the CUDA sources (csrc/field_mma.cuh, which both tensor-core
    instances include), with the value the wrapper uses."""
    defines = [d for path in sorted(CSRC.glob("*.cu*"))
               for d in re.findall(r"#define (MMA_\w+) (\d+)",
                                   path.read_text())]
    for name in ("MMA_ROWS", "MMA_WARPS", "MMA_UQ", "MMA_ABUF"):
        values = [int(v) for n, v in defines if n == name]
        assert values == [getattr(kernels, name)], (name, values)


def _tf32_split(x):
    """(hi, lo) of float32 x as the kernel splits it, both as TF32 values."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def _mma_contract(wt, phi):
    """a = wt @ phi (float32) as the kernel forms it: 3xTF32 products,
    summed exactly per 8-point k-tile, accumulated in float32 over tiles."""
    np_ = wt.shape[-1]
    pad = -np_ % 8
    wt = torch.nn.functional.pad(wt, (0, pad))
    phi = torch.nn.functional.pad(phi, (0, 0, 0, pad))
    (wh, wl), (ph, pl) = _tf32_split(wt), _tf32_split(phi)
    acc = torch.zeros(wt.shape[:-1] + phi.shape[-1:], dtype=torch.float32)
    for k in range(0, np_ + pad, 8):
        sl = slice(k, k + 8)

        def mm(a, b):
            return a[..., sl].double() @ b[..., sl, :].double()

        acc = acc + (mm(wh, ph) + mm(wh, pl) + mm(wl, ph)).float()
    return acc


def _emulated_descent_grad(xs, ws, wt, beta, z, us, kernel_name):
    """kernels.descent_grad_plain with the contraction of _mma_contract."""
    unit_p = kernels._unit_fields(kernel_name).unit_p
    sh = xs.shape
    q = z.shape[0]
    diff = ws[:, None, :, :, None] - xs[:, :, :, None, :]
    phi = unit_p(torch.sum(diff * diff, dim=2))
    a = _mma_contract(wt, phi)
    s0 = a[:, :, 0] - torch.sum(a[:, :, 1:1 + q] * z, dim=2)
    ax = a[:, :, 1 + q:].reshape(sh[0], sh[1], 1 + q, sh[2], sh[3])
    sx = ax[:, :, 0] - torch.sum(ax[:, :, 1:] * z[:, None, :], dim=2)
    g = xs * s0[:, :, None] - sx
    du = xs[:, :, None] - us[..., None]
    pb = unit_p(torch.sum(du * du, dim=3)) * beta
    return g + torch.sum(pb[:, :, :, None] * du, dim=2)


def _problem(kernel_name):
    """The descent operands of a fitted 2-member float32 ensemble at Np =
    130 (bench-like hyperparameters and data), random unions and starts."""
    rng = np.random.default_rng(3)
    x = rng.random((NP, D))
    y = np.sin(3 * x[:, 0]) + np.cos(5 * x[:, 1]) + 0.01 * \
        rng.standard_normal(NP)
    y = (y - y.mean()) / y.std()
    f32 = dict(dtype=torch.float32)
    hypers = torch.as_tensor(np.stack([0.5 + 1.5 * rng.random(S),
                                       0.2 + 0.4 * rng.random(S),
                                       0.2 + 0.4 * rng.random(S)], axis=1),
                             **f32)
    states = mcmc.fit_gp_ensemble(kernel_name, hypers,
                                  torch.full((S, 1), 1e-2, **f32), x,
                                  y[:, None], jitter=1e-5)
    gen = torch.Generator().manual_seed(5)
    unions = torch.rand((B, Q, D), generator=gen, **f32)
    normals = draw_antithetic_normals(gen, M, Q, **f32)
    _, chol_u, v, _ = kg._build_fantasy_model_batch(states, unions)
    betas = linalg.solve_triangular_small(
        chol_u, normals.T.expand(S, B, Q, M), trans=True).transpose(-1, -2)
    lengths = states.covariance.lengths
    ops = kg._pack_descent_inputs(states, unions, v.detach(),
                                  betas.detach(), normals)
    geom = torch.stack([torch.zeros_like(lengths), 1.0 / lengths,
                        1.0 / lengths**2], dim=1).float().contiguous()
    x0 = torch.rand((S, B, M, D), generator=gen, **f32)
    xs0 = (x0 / lengths[:, None, None, :]).transpose(-1, -2).contiguous()
    return (xs0, *ops, geom), lengths.double()


def _quantiles(dev):
    d = dev.flatten()
    qs = torch.quantile(d, torch.tensor([0.5, 0.9, 0.99, 0.999],
                                        dtype=torch.float64))
    return torch.cat([qs, d.max()[None]])


@pytest.mark.parametrize("kernel_name", ["matern_2.5", "square_exponential"])
@pytest.mark.parametrize("label", ["cold", "warm"])
def test_emulated_mma_descent_holds_the_float64_rule(monkeypatch,
                                                     kernel_name, label):
    args, lengths = _problem(kernel_name)
    params = DEFAULT_SGD_PARAMS_PS if label == "cold" else \
        dataclasses.replace(DEFAULT_SGD_PARAMS_PS, max_num_steps=1,
                            num_steps_averaged=0)
    avg_n = params.num_steps_averaged if \
        0 < params.num_steps_averaged <= params.max_num_steps else 0
    tail = (kernel_name, params.max_num_steps, params.max_num_restarts,
            avg_n, params.gamma, params.pre_mult, params.max_relative_change)

    def to_unit(xs):        # (S, B, d, M) scaled -> unit-box coordinates
        return xs.double() * lengths[:, None, :, None]

    p64 = to_unit(kernels.descent_run_plain(*[a.double() for a in args],
                                            *tail))
    p32 = to_unit(kernels.descent_run_plain(*args, *tail))
    monkeypatch.setattr(kernels, "descent_grad_plain", _emulated_descent_grad)
    emu = to_unit(kernels.descent_run_plain(*args, *tail))
    assert torch.isfinite(emu).all()
    assert not torch.equal(emu, p32)             # the emulation did run
    k64 = _quantiles((emu - p64).abs())
    pp64 = _quantiles((p32 - p64).abs())
    assert bool((k64 <= torch.clamp(1.5 * pp64, min=5e-5)).all()), \
        (k64.tolist(), pp64.tolist())


def test_split_contraction_keeps_float32_accuracy():
    """On the problem's own W and field, 3xTF32 stays within a few float32
    roundings of float64 per moment, where one TF32 product does not."""
    (xs0, ws, wt, *_), _ = _problem("matern_2.5")
    diff = ws[:, None, :, :, None] - xs0[:, :, :, None, :]
    phi = kernels._unit_fields("matern_2.5").unit_p(
        torch.sum(diff * diff, dim=2))
    exact = wt.double() @ phi.double()
    scale = wt.double().abs() @ phi.double().abs()
    three = (_mma_contract(wt, phi).double() - exact).abs() / scale
    wh, _ = _tf32_split(wt)
    ph, _ = _tf32_split(phi)
    one = ((wh.double() @ ph.double()) - exact).abs() / scale
    assert three.max().item() < 4 * 2.0**-23
    assert one.max().item() > 30 * three.max().item()
