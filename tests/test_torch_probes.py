"""The probe kernels' plain versions (K4 affine, K5 int8_dot, K6 dd_mul)
against the JAX-side references that scripts/probe_pallas.py asserts, on
the CPU, and the port's probe entry point run on CPU tensors.

The Pallas kernels P1-P3 themselves are closures inside the probe
functions, built with TPU memory spaces (pltpu.VMEM); they cannot run in
interpret mode here without editing scripts/probe_pallas.py, which stays
as it is.  So each plain version is held to what the probe checks its
kernel against: P1 x*2+1 (bit for bit), P2 the int32 product of the int8
operands (exact, also on ragged shapes), P3 redtime_tpu.dd.mul run
eagerly (bit for bit; see tests/test_torch_dd.py for why not under jit)
with hi + lo within 1e-13 relative of x*y.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per worker)
from redtime_tpu import dd as jdd
from redtime_tpu_torch import probes
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch.kernels import probes as kp


@pytest.mark.parametrize("n", [1, 8 * 128, 1000, 4099])
def test_affine_plain_equals_2x_plus_1(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
         ).astype(np.float32)
    before = counts.snapshot()
    got = kp.affine(torch.as_tensor(x)).numpy()
    assert counts.snapshot() == before
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x * np.float32(2) + np.float32(1))
    np.testing.assert_array_equal(
        got, np.asarray(jnp.asarray(x) * 2.0 + 1.0))


@pytest.mark.parametrize("M, K, N", [(128, 512, 256), (1, 1, 1),
                                     (67, 130, 33), (5, 3, 190),
                                     (2016, 1024, 256)])
def test_int8_dot_plain_is_the_exact_int32_product(M, K, N):
    rng = np.random.default_rng(M * K + N)
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    got = kp.int8_dot(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert got.dtype == np.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got,
                                  a.astype(np.int32) @ b.astype(np.int32))


def test_int8_dot_extremes_are_exact():
    """All -128 operands: every product is 2^14, the largest int8 term."""
    K = 4096
    a = torch.full((3, K), -128, dtype=torch.int8)
    b = torch.full((K, 2), -128, dtype=torch.int8)
    assert torch.all(kp.int8_dot(a, b) == K * 2 ** 14)


def test_dd_mul_plain_equals_jax_dd_mul():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 128)) * np.exp(rng.uniform(-8, 8, (8, 128)))
    y = rng.standard_normal((8, 128)) * np.exp(rng.uniform(-8, 8, (8, 128)))
    xh = x.astype(np.float32)
    xl = (x - xh).astype(np.float32)
    yh = y.astype(np.float32)
    yl = (y - yh).astype(np.float32)
    oh, ol = kp.dd_mul(*map(torch.as_tensor, (xh, xl, yh, yl)))
    rh, rl = jdd.mul(*map(jnp.asarray, (xh, xl, yh, yl)))
    np.testing.assert_array_equal(oh.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(ol.numpy(), np.asarray(rl))
    got = oh.numpy().astype(np.float64) + ol.numpy()
    assert np.abs(got / (x * y) - 1.0).max() < 1e-13


@pytest.mark.parametrize("probe", probes.PROBES, ids=lambda p: p.__name__)
def test_probe_entry_point_on_cpu_tensors(probe):
    """probe1-probe4 with their own inputs and criteria, through the plain
    versions; no kernel launch is counted."""
    before = counts.snapshot()
    out = probe("cpu")
    assert counts.snapshot() == before
    assert isinstance(out, dict)
    if probe is probes.probe3:
        assert out["max_rel_err"] < 1e-13
    if probe is probes.probe4:
        assert out["M"] == 2016 and out["max_abs_err"] == 0.0
