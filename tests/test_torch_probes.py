"""The probe kernels' plain versions (K4 affine, K5 int8_dot, K6 dd_mul,
K7 oz_fused) against the JAX-side references of scripts/probe_pallas.py,
on the CPU, and the port's probe entry point run on CPU tensors.

P1-P3 are built with TPU memory spaces (pltpu.VMEM) and cannot run in
interpret mode here without editing scripts/probe_pallas.py, which stays
as it is.  So each plain version is held to what the probe checks its
kernel against: P1 x*2+1 (bit for bit), P2 the int32 product of the int8
operands (exact, also on ragged shapes), P3 redtime_tpu.dd.mul run
eagerly (bit for bit; see tests/test_torch_dd.py for why not under jit)
with hi + lo within 1e-13 relative of x*y.

P4's kernel and its XLA path take plain BlockSpecs, so they run here: both
are taken from probe4's code object (closures over q = 7 and SA = 6) and
the kernel goes through pl.pallas_call(interpret=True) with pallas_path's
grid and BlockSpecs, traced under jax.enable_x64(False) as pallas_path
traces it.  oz_fused_plain equals the kernel bit for bit in oh and ol, and
oz_xla_path equals the jitted xla_path bit for bit, at probe4's inputs and
on one small grid.  Inputs with subnormal f32 words differ: XLA:CPU
flushes subnormals to zero, PyTorch (and K7 on the card) keeps them.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

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
    """probe1-probe4 and probe4_out_leg with their own inputs and
    criteria, through the plain versions; no kernel launch is counted."""
    before = counts.snapshot()
    out = probe("cpu")
    assert counts.snapshot() == before
    assert isinstance(out, dict)
    if probe is probes.probe3:
        assert out["max_rel_err"] < 1e-13
    if probe is probes.probe4:
        assert (out["M"], out["K"], out["O"]) == (2016, 1024, 256)
        assert out["agreement"] < 1e-13
    if probe is probes.probe4_out_leg:
        assert out["M"] == 2016 and out["max_abs_err"] == 0.0


ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _probe4_parts():
    """probe4's Pallas `kernel` and its jitted `xla_path`, rebuilt from
    probe4's code object with cells q = 7, SA = 6."""
    spec = importlib.util.spec_from_file_location(
        "probe_pallas", os.path.join(ROOT, "scripts", "probe_pallas.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cells = dict(q=kp.OZ_Q, SA=kp.OZ_SLICES)

    def inner(name):
        code = next(c for c in mod.probe4.__code__.co_consts
                    if isinstance(c, types.CodeType) and c.co_name == name)
        return types.FunctionType(
            code, mod.__dict__, name, None,
            tuple(types.CellType(cells[v]) for v in code.co_freevars))

    return inner("kernel"), jax.jit(inner("xla_path"))


def _pallas_interpret(kernel, xh, xl, ws, tm):
    """P4's kernel as pallas_path calls it (a grid of M / tm row tiles),
    in interpret mode."""
    M, K = xh.shape
    O = ws.shape[2]
    with jax.enable_x64(False):
        oh, ol = pl.pallas_call(
            kernel, grid=(M // tm,),
            out_shape=(jax.ShapeDtypeStruct((M, O), jnp.float32),) * 2,
            in_specs=[pl.BlockSpec((tm, K), lambda i: (i, 0))] * 2 +
                     [pl.BlockSpec((K, O), lambda i: (0, 0))] * 4,
            out_specs=(pl.BlockSpec((tm, O), lambda i: (i, 0)),) * 2,
            interpret=True)(jnp.asarray(xh), jnp.asarray(xl),
                            *[jnp.asarray(w) for w in ws])
    return np.asarray(oh), np.asarray(ol)


def _oz_inputs(M, K, O):
    """x f64 [M, K], its f32 split and ws int8 [4, K, O] as probe4 draws
    them (seed 2)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((M, K))
    ws = np.stack([rng.integers(-64, 64, (K, O)).astype(np.int8)
                   for _ in range(4)])
    xh = x.astype(np.float32)
    return x, xh, (x - xh).astype(np.float32), ws


# (M, K, O, row tile): probe4's grid (7 tiles of 288) and a small one
OZ_GRIDS = [(2016, 1024, 256, 288), (64, 256, 128, 32)]


@pytest.fixture(scope="module")
def probe4_parts():
    return _probe4_parts()


@pytest.mark.parametrize("M, K, O, tm", OZ_GRIDS)
def test_oz_fused_plain_equals_the_pallas_kernel(probe4_parts, M, K, O, tm):
    """oz_fused_plain against P4's Pallas kernel in interpret mode, bit
    for bit in oh and ol; no launch is counted."""
    x, xh, xl, ws = _oz_inputs(M, K, O)
    oh, ol = _pallas_interpret(probe4_parts[0], xh, xl, ws, tm)
    before = counts.snapshot()
    got = kp.oz_fused(*map(torch.as_tensor, (xh, xl, ws)))
    assert counts.snapshot() == before
    np.testing.assert_array_equal(got[0].numpy(), oh)
    np.testing.assert_array_equal(got[1].numpy(), ol)


@pytest.mark.parametrize("M, K, O, tm", OZ_GRIDS)
def test_oz_xla_path_equals_jax_xla_path(probe4_parts, M, K, O, tm):
    x, _, _, ws = _oz_inputs(M, K, O)
    ref = np.asarray(probe4_parts[1](jnp.asarray(x),
                                     [jnp.asarray(w) for w in ws]))
    got = kp.oz_xla_path(torch.as_tensor(x), torch.as_tensor(ws)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("M, K, O, tm", OZ_GRIDS)
def test_oz_fused_plain_agrees_with_the_xla_path(M, K, O, tm):
    """The double-double f32 sum against the f64 one: within 1e-13 of
    max|ref| (1.16e-15 at probe4's inputs)."""
    x, xh, xl, ws = _oz_inputs(M, K, O)
    oh, ol = kp.oz_fused_plain(*map(torch.as_tensor, (xh, xl, ws)))
    ref = kp.oz_xla_path(torch.as_tensor(x), torch.as_tensor(ws))
    err = (oh.double() + ol.double() - ref).abs().max() / ref.abs().max()
    assert float(err) < 1e-13


def test_oz_edge_rows_with_normal_words_equal_the_pallas_kernel(
        probe4_parts):
    """chip_smoke's rows at the edges of the row exponent: the zero row
    and the two rows at the upper clip bound are bit-equal to the Pallas
    kernel; the rows near the lower bound hold subnormal words, which
    XLA:CPU flushes, and are left out here."""
    import chip_smoke

    x, _, _, ws = _oz_inputs(64, 256, 128)
    x = chip_smoke.oz_edge_rows(x, np.random.default_rng(3))
    xh = x.astype(np.float32)
    xl = (x - xh).astype(np.float32)
    oh, ol = _pallas_interpret(probe4_parts[0], xh, xl, ws, 32)
    got = kp.oz_fused_plain(*map(torch.as_tensor, (xh, xl, ws)))
    keep = [0, 1, 2] + list(range(5, 64))
    np.testing.assert_array_equal(got[0].numpy()[keep], oh[keep])
    np.testing.assert_array_equal(got[1].numpy()[keep], ol[keep])
    assert np.all(got[0].numpy()[0] == 0.0)
    assert np.all(np.isfinite(got[0].numpy()))
