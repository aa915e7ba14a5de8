"""The port's double-double helpers (redtime_tpu_torch.dd) against the
JAX package's (redtime_tpu.dd), on the CPU.

Every function runs on the same f32 inputs in both packages and must give
the same bits.  The JAX functions run EAGERLY, one op at a time, as the
port's do: under jax.jit, XLA:CPU fuses the chain and contracts products
and sums into FMAs, which changes dd.mul's lo word (Dekker's transform
needs every operation rounded on its own).  Then the accuracy assertions
of tests/test_dd.py, repeated on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per worker)
from redtime_tpu import dd as jdd
from redtime_tpu_torch import dd

RNG = np.random.default_rng(7)


def _wide(shape, lo=-15, hi=15, rng=RNG):
    return rng.standard_normal(shape) * np.exp(rng.uniform(lo, hi, shape))


def _pair(x):
    """(hi, lo) f32 of f64 x, as numpy."""
    hi = x.astype(np.float32)
    return hi, (x - hi).astype(np.float32)


def _both(fn_name, *args):
    """fn_name on numpy args in both packages -> (port, jax) as numpy."""
    got = getattr(dd, fn_name)(*[torch.as_tensor(a) for a in args])
    ref = getattr(jdd, fn_name)(*[jnp.asarray(a) for a in args])
    as_tuple = lambda r: r if isinstance(r, tuple) else (r,)
    return ([np.asarray(g.numpy()) for g in as_tuple(got)],
            [np.asarray(r) for r in as_tuple(ref)])


def _f32_args(n_dd, n_f32):
    rng = np.random.default_rng(11)
    args = []
    for _ in range(n_dd):
        args += list(_pair(_wide((512,), -8, 8, rng)))
    for _ in range(n_f32):
        args.append(_wide((512,), -8, 8, rng).astype(np.float32))
    return args


def _ordered(a, b):
    """(big, small) with |big| >= |small| elementwise (fast_two_sum)."""
    swap = np.abs(a) < np.abs(b)
    return np.where(swap, b, a), np.where(swap, a, b)


@pytest.mark.parametrize("fn_name, args", [
    ("two_sum", _f32_args(0, 2)),
    ("fast_two_sum", list(_ordered(*_f32_args(0, 2)))),
    ("two_prod", _f32_args(0, 2)),
    ("add", _f32_args(2, 0)),
    ("add_f32", _f32_args(1, 1)),
    ("mul", _f32_args(2, 0)),
    ("mul_f32", _f32_args(1, 1)),
    ("neg", _f32_args(1, 0)),
    ("to_f64", _f32_args(1, 0)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_dd_matches_jax_bitwise(fn_name, args):
    got, ref = _both(fn_name, *args)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_scale_pow2_from_f64_from_i32_exp2i_match_jax_bitwise():
    hi, lo = _pair(_wide((256,)))
    for s in (np.float32(0.25), np.float32(1024.0)):
        got = dd.scale_pow2(torch.as_tensor(hi), torch.as_tensor(lo), s)
        ref = jdd.scale_pow2(jnp.asarray(hi), jnp.asarray(lo), s)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    got, ref = _both("from_f64", _wide((256,)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    ints = np.random.default_rng(3).integers(-2**31 + 1, 2**31 - 1, 4096,
                                             dtype=np.int64).astype(np.int32)
    got, ref = _both("from_i32", ints)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    e = np.arange(-125, 126, dtype=np.int32)
    for name in ("exp2i", "inv_pow2"):
        got, ref = _both(name, e)
        np.testing.assert_array_equal(got[0], ref[0])


def test_mul_is_exact_dekker_and_not_fma_contracted():
    """dd.mul's lo word is Dekker's, not the FMA residual: for products
    whose exact error needs the split, two_prod's e equals a*b - p
    exactly (checked in f64, where a f32 product is exact)."""
    a = _wide((4096,), -8, 8).astype(np.float32)
    b = _wide((4096,), -8, 8).astype(np.float32)
    p, e = dd.two_prod(torch.as_tensor(a), torch.as_tensor(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.numpy().astype(np.float64)
                                  + e.numpy().astype(np.float64), exact)


# --- the accuracy assertions of tests/test_dd.py, on the port

def _dd(x):
    return dd.from_f64(torch.as_tensor(x))


def _back(pair):
    return dd.to_f64(*pair).numpy()


def test_from_to_roundtrip():
    x = _wide((64,))
    rel = np.abs(_back(_dd(x)) - x) / np.abs(x)
    assert rel.max() < 2.0 ** -47


def test_add_mul_accuracy():
    a, b = _wide((256,)), _wide((256,))
    ah, al = _dd(a)
    bh, bl = _dd(b)
    rel_add = np.abs(_back(dd.add(ah, al, bh, bl)) - (a + b)) / \
        np.maximum(np.abs(a + b), 1e-300)
    rel_mul = np.abs(_back(dd.mul(ah, al, bh, bl)) - (a * b)) / np.abs(a * b)
    assert rel_add.max() < 2e-13
    assert rel_mul.max() < 2e-13


def test_mul_f32_and_pow2():
    a = _wide((128,))
    ah, al = _dd(a)
    c = np.float32(1.7)
    rel = np.abs(_back(dd.mul_f32(ah, al, torch.tensor(c))) - a * float(c)) \
        / np.abs(a * float(c))
    assert rel.max() < 2e-13
    sh, sl = dd.scale_pow2(ah, al, 0.25)
    assert np.array_equal(_back((sh, sl)), _back((ah, al)) * 0.25)


def test_accumulation_chain():
    terms = _wide((64, 512), lo=-3, hi=12)
    ref = terms.sum(axis=1)
    h = torch.zeros(64, dtype=torch.float32)
    lo = torch.zeros(64, dtype=torch.float32)
    for j in range(terms.shape[1]):
        th, tl = _dd(terms[:, j])
        h, lo = dd.add(h, lo, th, tl)
    err = np.abs(_back((h, lo)) - ref)
    assert (err / np.abs(terms).sum(axis=1)).max() < 1e-13


def test_from_i32_exact():
    o = torch.as_tensor(RNG.integers(-2**31 + 1, 2**31 - 1, 4096),
                        dtype=torch.int32)
    assert np.array_equal(_back(dd.from_i32(o)), o.numpy().astype(np.float64))
    # the residual of values that round up to 2^31 in f32
    top = torch.tensor([2**31 - 1, 2**31 - 64, -2**31], dtype=torch.int32)
    assert np.array_equal(_back(dd.from_i32(top)),
                          top.numpy().astype(np.float64))


def test_exp2i_exact():
    e = torch.arange(-125, 128, dtype=torch.int32)
    got = dd.exp2i(e).numpy().astype(np.float64)
    assert np.array_equal(got, 2.0 ** np.arange(-125, 128, dtype=np.float64))
    inv = dd.inv_pow2(torch.arange(-125, 126, dtype=torch.int32)).numpy()
    assert np.array_equal(inv.astype(np.float64),
                          2.0 ** -np.arange(-125, 126, dtype=np.float64))
