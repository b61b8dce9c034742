"""The port's real-function objectives (``utils/real_functions.py``)
against the JAX package's.

KISSGP at n_data 300, grid 60: the dataset, the interpolation weights and
the value with its 3 gradient channels equal to the JAX package's at rtol
1e-10 (both float64 on the CPU), and the gradient to central finite
differences at rtol 1e-4 (``tests/test_aux_subsystems.py:107-126``).
CIFAR10: the synthetic stand-in equal bit for bit, and one training run at
epochs 1 on 300 images equal to the JAX package's (the same torch network
and loop on the CPU).
"""

import numpy as np
import pytest
import torch

from cornell_moe_tpu.utils import real_functions as jrf
from cornell_moe_tpu_torch.utils import real_functions as trf

KISSGP_TOL = dict(rtol=1e-10, atol=0.0)


@pytest.fixture(scope="module")
def kissgp():
    return (jrf.KISSGP(n_data=300, grid_size=60),
            trf.KISSGP(n_data=300, grid_size=60))


@pytest.mark.parametrize("x", [[0.3, 0.2, -0.5], [-0.6931, 0.0, -2.3026],
                               [2.0, 1.0, -1.0], [-1.0, 3.0, 3.0]],
                         ids=["interior", "truth", "far", "corner"])
def test_kissgp_value_and_gradient_match_jax(kissgp, x):
    j, t = kissgp
    np.testing.assert_array_equal(t._y, j._y)
    np.testing.assert_array_equal(t._w, j._w)
    ref = j.evaluate(np.array(x))
    got = t.evaluate(np.array(x))
    assert got.shape == (4,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, **KISSGP_TOL)


def test_kissgp_gradient_is_the_finite_difference(kissgp):
    _, f = kissgp
    at_truth = f.evaluate(np.log(np.array([0.5, 1.0, 0.1])))
    elsewhere = f.evaluate(np.array([2.0, 1.0, -1.0]))
    assert at_truth[0] < elsewhere[0]
    x0 = np.array([0.3, 0.2, -0.5])
    eps = 1e-5
    g = f.evaluate(x0)[1:]
    for i in range(3):
        e = np.zeros(3)
        e[i] = eps
        fd = (f.evaluate(x0 + e)[0] - f.evaluate(x0 - e)[0]) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=1e-4)


def test_kissgp_settings_and_gates_match_jax():
    j, t = jrf.KISSGP(), trf.KISSGP()
    assert t._min_value == j._min_value == 13.488403
    for a in ("_dim", "_num_init_pts", "_sample_var", "_observations",
              "_num_fidelity"):
        assert getattr(t, a) == getattr(j, a), a
    np.testing.assert_array_equal(t._search_domain, j._search_domain)
    assert np.isnan(trf.KISSGP(n_data=50, grid_size=20)._min_value)
    plain = trf.KISSGP(n_data=50, grid_size=20, with_gradients=False)
    assert plain._observations == [] and plain.evaluate(np.zeros(3)).shape \
        == (1,)
    with pytest.raises((RuntimeError, ImportError)):
        trf.KISSGP(use_octave=True).evaluate(np.zeros(3))


def test_cifar10_synthetic_data_and_one_training_run_match_jax():
    j = jrf.CIFAR10(epochs=1, subset=300)
    t = trf.CIFAR10(epochs=1, subset=300)
    assert torch.equal(t._data[0], j._data[0])
    assert torch.equal(t._data[1], j._data[1])
    np.testing.assert_array_equal(t._search_domain, j._search_domain)
    x = np.array([-3.0, 64.0, 5.0, 5.0, 5.0])
    ref = j.evaluate(x)
    got = t.evaluate(x)
    assert got.shape == (6,) and 0.0 <= got[0] <= 1.0
    np.testing.assert_array_equal(got, ref)


def test_cifar10_without_data_or_fallback_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("CIFAR10_DIR", raising=False)
    for mod in (jrf, trf):
        with pytest.raises(RuntimeError, match="CIFAR-10 data not found"):
            mod.CIFAR10(data_dir=str(tmp_path), synthetic_fallback=False,
                        subset=10)
