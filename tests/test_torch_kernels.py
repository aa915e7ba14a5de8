"""The hand kernels' wrappers (K1 out_leg, K2 pz_leg, K3 rk_finish, K4
affine, K5 int8_dot, K6 dd_mul, K7 oz_fused, K8 rhs_tail, K9
engine_front, K10 tab_leg) and
chip_smoke.py's inputs.  This file
imports no JAX, so its `cuda` tests also run on a GPU machine that has
none:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

On the CPU every wrapper takes its plain version and counts no launch; a
tensor on any other device never reaches the plain version.  On the card
each kernel is held to its plain version: K1 and K2 within the f64
dot-product forward-error bound (they sum in another order), K3
(rk_finish and rk_stage, which round every operation alone as their plain
versions do; CUDA's pow is the routine torch.pow runs) and K4-K7 bit for
bit, K8 within 1e-13 of each (lane, row)'s scale (its plain version's
three small matrix products sum in cuBLAS's order), K9 and K10 within
their stated forward-error bounds (engine_front.error_bound,
tab_leg.error_bound).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from redtime_tpu_torch import background as bg
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch import ode as tode
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch.kernels import engine_front as k9
from redtime_tpu_torch import probes
from redtime_tpu_torch.kernels import out_leg as k1
from redtime_tpu_torch.kernels import probes as kp
from redtime_tpu_torch.kernels import pz_leg as k2
from redtime_tpu_torch.kernels import rhs_tail as k8
from redtime_tpu_torch.kernels import rk_finish as k3
from redtime_tpu_torch.kernels import tab_leg as k10

EPS = np.finfo(np.float64).eps
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_wrappers_validate_and_cpu_takes_plain():
    rng = np.random.default_rng(5)
    tab = torch.as_tensor(rng.standard_normal((2, 2, 3, 3, 16)))
    G = torch.as_tensor(rng.standard_normal((3, 16, 5)))
    before = counts.snapshot()
    J = k1.out_leg(tab, G)
    torch.testing.assert_close(J, k1.out_leg_plain(tab, G), rtol=0, atol=0)
    assert J.shape == (2, 3, 3, 3, 5)
    # direct check of the contraction on one element
    ref = (tab[1, 0, 2, 1] * tab[1, 1, 2, 0] / 16) @ G[2, :, 4]
    assert abs(float(J[1, 2, 1, 0, 4] - ref)) < 1e-14
    with pytest.raises(TypeError):
        k1.out_leg(tab.float(), G.float())
    with pytest.raises(ValueError):
        k1.out_leg(tab, G[:2])
    with pytest.raises(ValueError):
        k1.out_leg(tab.transpose(3, 4), G)
    T = torch.as_tensor(rng.standard_normal((7, 4, 16)))
    P = torch.as_tensor(rng.standard_normal((2, 3, 16)))
    kf = torch.as_tensor(rng.standard_normal(4))
    PZ = k2.pz_leg(T, P, kf, 6)
    assert PZ.shape == (2, 7, 3, 3, 4)
    ref = kf[1] * (T[5, 1] @ P[1, 2]) * P[1, 0, 7]
    assert abs(float(PZ[1, 5, 2, 0, 1] - ref)) < 1e-14
    with pytest.raises(ValueError):
        k2.pz_leg(T, P[:, :2], kf, 6)
    with pytest.raises(ValueError):
        k2.pz_leg(T, P, kf, 13)
    # the plain path on CPU tensors never counts as a kernel launch
    assert counts.snapshot() == before


def test_engine_G_is_padded_and_plain_ignores_the_pitch():
    """engine_consts builds G as a view of a zero-padded buffer whose row
    pitch is a multiple of 8 f64, so the kernel reads G's rows in 16-byte
    copies.  out_leg_plain gives the same bits on it as on a contiguous
    copy; on the CPU the wrapper takes either, and its kernel check raises
    on a G whose rows the kernel cannot read so: an odd row pitch (O =
    nk+1 contiguous) or a stride along O."""
    cfg = TCfg(nk=16)
    G = tf.engine_consts(cfg, "cpu").G
    K, O = 2 * cfg.npts, cfg.nk + 1
    assert G.shape == (tf.NFAM, K, O)
    assert G.stride() == (K * 24, 24, 1)
    assert torch.equal(G, torch.as_tensor(tf.composite_out_matrix(cfg)))
    assert not G.as_strided((tf.NFAM, K, 24), G.stride())[..., O:].any()
    Gc = G.contiguous()
    tab = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (3, 2, tf.NFAM, 3, K)))
    ref = k1.out_leg_plain(tab, Gc)
    assert torch.equal(k1.out_leg_plain(tab, G), ref)
    assert torch.equal(k1.out_leg(tab, G), ref)
    assert torch.equal(k1.out_leg(tab, Gc), ref)
    for bad in (Gc, k1.padded(Gc[..., ::2].contiguous())[..., ::2]):
        with pytest.raises(ValueError, match="stride"):
            k1._check_kernel_shape(tab, bad)


def test_probe_wrappers_validate_and_cpu_takes_plain():
    f = torch.zeros(8, dtype=torch.float32)
    i8 = torch.zeros((4, 4), dtype=torch.int8)
    before = counts.snapshot()
    assert torch.equal(kp.affine(f), kp.affine_plain(f))
    assert torch.equal(kp.int8_dot(i8, i8), kp.int8_dot_plain(i8, i8))
    for x, y in zip(kp.dd_mul(f, f, f, f), kp.dd_mul_plain(f, f, f, f)):
        assert torch.equal(x, y)
    assert counts.snapshot() == before
    with pytest.raises(TypeError):
        kp.affine(f.double())
    with pytest.raises(ValueError):
        kp.affine(torch.zeros((4, 4), dtype=torch.float32).t())
    with pytest.raises(TypeError):
        kp.int8_dot(i8.int(), i8)
    with pytest.raises(ValueError):
        kp.int8_dot(i8, torch.zeros((3, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        kp.int8_dot(torch.zeros((2, 8), dtype=torch.int8).t(), i8[:2])
    with pytest.raises(ValueError, match="empty"):
        kp.int8_dot(torch.zeros((0, 4), dtype=torch.int8), i8)
    with pytest.raises(ValueError, match="overflow"):
        kp.int8_dot(torch.zeros((1, 2 ** 17), dtype=torch.int8),
                    torch.zeros((2 ** 17, 1), dtype=torch.int8))
    kp.int8_dot(torch.zeros((1, 2 ** 17 - 1), dtype=torch.int8),
                torch.zeros((2 ** 17 - 1, 1), dtype=torch.int8))
    with pytest.raises(TypeError):
        kp.dd_mul(f, f, f, f.double())
    with pytest.raises(ValueError):
        kp.dd_mul(f, f, f, f[:4])


def test_oz_fused_wrapper_validates_and_cpu_takes_plain():
    f = torch.zeros((3, 8), dtype=torch.float32)
    ws = torch.zeros((4, 8, 5), dtype=torch.int8)
    before = counts.snapshot()
    for x, y in zip(kp.oz_fused(f, f, ws), kp.oz_fused_plain(f, f, ws)):
        assert torch.equal(x, y) and x.shape == (3, 5)
    assert counts.snapshot() == before
    with pytest.raises(TypeError):
        kp.oz_fused(f.double(), f, ws)
    with pytest.raises(TypeError):
        kp.oz_fused(f, f, ws.int())
    with pytest.raises(ValueError, match="shape"):
        kp.oz_fused(f, f[:2], ws)
    with pytest.raises(ValueError, match="2-D"):
        kp.oz_fused(f[None], f[None], ws)
    with pytest.raises(ValueError, match="contiguous"):
        kp.oz_fused(f, f, torch.zeros((4, 5, 8), dtype=torch.int8)
                    .transpose(1, 2))
    with pytest.raises(ValueError, match=r"\[4, K, O\]"):
        kp.oz_fused(f, f, ws[:3])
    with pytest.raises(ValueError, match="chain"):
        kp.oz_fused(f, f, torch.zeros((4, 7, 5), dtype=torch.int8))
    with pytest.raises(ValueError, match="empty"):
        kp.oz_fused(f, f, ws[..., :0])
    with pytest.raises(ValueError, match="overflow"):
        big = torch.zeros((1, 2 ** 18), dtype=torch.float32)
        kp.oz_fused(big, big, torch.zeros((4, 2 ** 18, 1),
                                          dtype=torch.int8))


def test_oz_edge_rows_reach_the_exponent_bounds():
    """chip_smoke's K7 edge rows: exponents -125 (zero row), 125, 125
    (clipped from 126), -124 (normal values) and -125 (subnormal values,
    clipped from -126); every slice fits int8 and the result is finite."""
    import chip_smoke

    rng = np.random.default_rng(2)
    x = chip_smoke.oz_edge_rows(rng.standard_normal((8, 64)), rng)
    xh = torch.as_tensor(x.astype(np.float32))
    exi = kp._oz_row_exponent(xh)[:, 0].tolist()
    assert exi[:5] == [-125, 125, 125, -124, -125]
    assert bool((xh[1:4].abs() >= 2.0 ** -126).all())
    assert bool((xh[4].abs() < 2.0 ** -126).all())
    xl = torch.as_tensor((x - x.astype(np.float32)).astype(np.float32))
    for _, t in kp._oz_slices(xh, xl, kp._pow2(127 - kp._oz_row_exponent(
            xh))):
        assert int(t.abs().max()) <= 127
    ws = torch.as_tensor(rng.integers(-64, 64, (4, 64, 9)).astype(np.int8))
    oh, ol = kp.oz_fused(xh, xl, ws)
    assert bool(torch.isfinite(oh).all() and torch.isfinite(ol).all())


@pytest.mark.parametrize("M", [1, 15, 16, 17, 63, 64, 65, 2016, 2017])
def test_oz_plan_peels_every_row_once(M):
    """K7's row tiles: rank r of tile t peels rows 64 t + 16 r .. + 15;
    every row of [0, M) falls to exactly one (tile, rank), ranks past M
    peel none (M = 1: ranks 1-3), and the tiles are as few as can be."""
    plan = kp.oz_plan(M, 32, 8)
    hits = np.zeros(plan["row_tiles"] * kp.OZ_ROWS, dtype=int)
    peel = kp.OZ_ROWS // kp.OZ_RANKS
    for t in range(plan["row_tiles"]):
        for r in range(kp.OZ_RANKS):
            lo = t * kp.OZ_ROWS + r * peel
            hits[lo:lo + peel] += 1
    assert (hits == 1).all()
    assert (plan["row_tiles"] - 1) * kp.OZ_ROWS < M <= len(hits)


@pytest.mark.parametrize("O", [1, 8, 63, 64, 65, 255, 256, 257, 264, 520])
def test_oz_plan_covers_every_column_once(O):
    """K7's columns: rank r of column group g multiplies columns 256 g +
    64 r .. + 63; every column of [0, OP) falls to exactly one (group,
    rank), OP covers O with as few groups as can be, ranks past O have no
    column (O = 8: ranks 1-3), and the packed W is OP columns wide."""
    plan = kp.oz_plan(64, 32, O)
    hits = np.zeros(plan["OP"], dtype=int)
    for g in range(plan["col_groups"]):
        for r in range(kp.OZ_RANKS):
            lo = (g * kp.OZ_RANKS + r) * kp.OZ_COLS
            hits[lo:lo + kp.OZ_COLS] += 1
    assert (hits == 1).all()
    assert plan["OP"] == plan["col_groups"] * kp.OZ_RANKS * kp.OZ_COLS
    assert plan["OP"] - kp.OZ_RANKS * kp.OZ_COLS < O <= plan["OP"]
    assert plan["wp_bytes"] == 4 * plan["KT"] * plan["OP"] * kp.OZ_BK


def test_oz_plan_covers_every_k_once():
    """K7's K: for every K in 1..2100, each k falls in exactly one K-step
    of 32 and each K-step in exactly one panel of at most 1024 columns
    (one panel: x stays in shared memory and the row maxima come from it;
    more: a first pass over xh); each round of the peelers takes four
    K-steps, a warp each, and the last round's extra warps have none."""
    for K in range(1, 2101):
        plan = kp.oz_plan(64, K, 8)
        kt = plan["KT"]
        assert (kt - 1) * kp.OZ_BK < K <= kt * kp.OZ_BK
        per = plan["panel"] // kp.OZ_BK
        hits = np.zeros(kt, dtype=int)
        for p in range(plan["npanel"]):
            steps = min(per, kt - p * per)
            assert steps > 0
            for j in range(0, steps, 4):
                for w in range(4):
                    if j + w < steps:
                        hits[p * per + j + w] += 1
        assert (hits == 1).all(), K
        assert plan["npanel"] == (1 if kt * kp.OZ_BK <= kp.OZ_PANEL
                                  else -(-K // kp.OZ_PANEL))


@pytest.mark.parametrize("K,O", [(1, 1), (4, 8), (40, 264), (999, 129),
                                 (1024, 256), (33, 520)])
def test_oz_pack_w_plain_is_a_permutation_of_w(K, O):
    """The packed W holds every element of W exactly once, zeros
    elsewhere (the padding of K and O), in wp_bytes elements."""
    n = 4 * K * O
    idx = torch.arange(1, n + 1, dtype=torch.int64).reshape(4, K, O)
    packed = kp.oz_pack_w_plain(idx).flatten()
    assert packed.numel() == kp.oz_plan(1, K, O)["wp_bytes"]
    nz = packed[packed != 0]
    assert torch.equal(torch.sort(nz).values, torch.arange(1, n + 1))
    assert int((packed == 0).sum()) == packed.numel() - n


def _tile_index() -> np.ndarray:
    """[64, 32] byte offsets of (row, k) in a K-step's operand tile."""
    rows, ks = np.meshgrid(np.arange(64), np.arange(kp.OZ_BK), indexing="ij")
    return kp.oz_tile_byte(rows, ks)


@pytest.mark.parametrize("M,K,O", [(64, 32, 64), (70, 100, 130),
                                   (130, 64, 300), (5, 7, 8)])
def test_oz_main_loop_model_equals_int8_dot(M, K, O):
    """A model of K7's main loop over its operand layouts: the slice tiles
    as the peelers write them (oz_tile_byte over 64 rows) and the W tiles
    as the pack lays them out (oz_pack_w_plain, read at the offset the
    producer copies for column block b, K-step kt, W v), multiplied as
    wgmma reads them (byte (n, k) of B at oz_tile_byte(n, k)) and summed
    over the K-steps, give int8_dot_plain exactly for each W."""
    rng = np.random.default_rng(M + K + O)
    t = rng.integers(-64, 65, (M, K)).astype(np.int8)
    ws = rng.integers(-128, 128, (4, K, O)).astype(np.int8)
    plan = kp.oz_plan(M, K, O)
    kt_n, tiles, op = plan["KT"], plan["row_tiles"], plan["OP"]
    wp = kp.oz_pack_w_plain(torch.as_tensor(ws)).flatten().numpy()
    ta = np.zeros((tiles * 64, kt_n * kp.OZ_BK), dtype=np.int8)
    ta[:M, :K] = t
    idx = _tile_index()
    for v in range(4):
        got = np.zeros((tiles * 64, op), dtype=np.int64)
        for kt in range(kt_n):
            for tile in range(tiles):
                a_tile = np.zeros(64 * kp.OZ_BK, dtype=np.int8)
                a_tile[idx] = ta[tile * 64:(tile + 1) * 64,
                                 kt * kp.OZ_BK:(kt + 1) * kp.OZ_BK]
                a = a_tile[idx].astype(np.int64)           # [64 rows, 32 k]
                for b in range(op // kp.OZ_COLS):
                    off = ((b * kt_n + kt) * 4 + v) * 64 * kp.OZ_BK
                    w_tile = wp[off:off + 64 * kp.OZ_BK]
                    bt = w_tile[idx].astype(np.int64)      # [64 cols, 32 k]
                    got[tile * 64:(tile + 1) * 64,
                        b * 64:(b + 1) * 64] += a @ bt.T
        want = kp.int8_dot_plain(torch.as_tensor(t), torch.as_tensor(ws[v]))
        assert np.array_equal(got[:M, :O], want.numpy().astype(np.int64))


def test_oz_pack_w_validates_and_cpu_takes_plain():
    ws = torch.as_tensor(np.arange(4 * 5 * 3, dtype=np.int8).reshape(4, 5, 3))
    before = counts.snapshot()
    assert torch.equal(kp.oz_pack_w(ws), kp.oz_pack_w_plain(ws))
    assert counts.snapshot() == before
    with pytest.raises(TypeError):
        kp.oz_pack_w(ws.int())
    with pytest.raises(ValueError, match=r"\[4, K, O\]"):
        kp.oz_pack_w(ws[:3])


def test_oz_fold_split_is_the_conversion():
    """The fold's fast path: for |o| < 2^22 the f32 of 0x4B400000 + o,
    less 1.5 2^23, is float(o) exactly, and o - int(that) is 0, as the
    plain version's f32 conversion and residual."""
    rng = np.random.default_rng(3)
    o = np.concatenate([rng.integers(-(2 ** 22) + 1, 2 ** 22, 100000),
                        [-(2 ** 22) + 1, -1, 0, 1, 2 ** 22 - 1]])
    o = o.astype(np.int32)
    hi = (np.int32(0x4B400000) + o).view(np.float32) - np.float32(12582912.0)
    assert np.array_equal(hi, o.astype(np.float32))
    assert np.array_equal(o - hi.astype(np.int32), np.zeros_like(o))


def test_probe_wrappers_raise_off_the_cpu_without_a_kernel():
    meta = torch.device("meta")
    f = torch.empty(8, dtype=torch.float32, device=meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        kp.affine(f)
    with pytest.raises(RuntimeError, match="no kernel"):
        kp.int8_dot(torch.empty((2, 4), dtype=torch.int8, device=meta),
                    torch.empty((4, 2), dtype=torch.int8, device=meta))
    with pytest.raises(RuntimeError, match="no kernel"):
        kp.dd_mul(f, f, f, f)
    x = torch.empty((2, 4), dtype=torch.float32, device=meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        kp.oz_fused(x, x, torch.empty((4, 4, 2), dtype=torch.int8,
                                      device=meta))


def _rk_args(B, D, rng, device, tab=tode.RKF45):
    """One attempt's (y, ks, t, h, t1, n, active) and its constants."""
    t_ = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)
    tt = t_(rng.uniform(0, 1, B))
    return [t_(rng.standard_normal((B, D))),
            t_(rng.standard_normal((len(tab.c), B, D))), tt,
            t_(10.0 ** rng.uniform(-9, 0, B)), tt + 0.3,
            torch.zeros(B, dtype=torch.int64, device=device),
            torch.tensor([True] * (B - 1) + [False], device=device)], \
        k3.attempt_consts(tab, 1e-7, 1e-2, device)


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor that is not on the CPU never reaches a plain version: on a
    device with no kernel (here `meta`) every wrapper raises."""
    meta = torch.device("meta")
    f64 = dict(dtype=torch.float64, device=meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        k1.out_leg(torch.empty((1, 2, 3, 3, 8), **f64),
                   torch.empty((3, 8, 4), **f64))
    with pytest.raises(RuntimeError, match="no kernel"):
        k2.pz_leg(torch.empty((7, 4, 16), **f64),
                  torch.empty((1, 3, 16), **f64), torch.empty(4, **f64), 6)
    rng = np.random.default_rng(0)
    args = [x.to(meta) for x in _rk_args(2, 8, rng, "cpu")[0]]
    consts = k3.attempt_consts(tode.RKF45, 1e-7, 1e-2, meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        k3.rk_finish(*args, consts)
    with pytest.raises(RuntimeError, match="no kernel"):
        k3.rk_stage(args[0], args[1], args[3], consts, 3)


def test_rk_wrappers_validate_and_cpu_takes_plain():
    """rk_finish and rk_stage check the tensors a call hands them (shape,
    dtype, layout, device against the constants') and take their plain
    versions on the CPU without counting a launch; the constants are
    validated where they are made."""
    args, consts = _rk_args(3, 8, np.random.default_rng(1), "cpu")
    y, ks, t, h, t1, n, active = args
    before = counts.snapshot()
    for got, ref in zip(k3.rk_finish(*args, consts),
                        k3.rk_finish_plain(*args, consts.b, consts.e,
                                           consts.prm)):
        assert torch.equal(got, ref)
    assert torch.equal(k3.rk_stage(y, ks, h, consts, 4),
                       k3.rk_stage_plain(y, ks, h, consts.a[4], 4))
    assert counts.snapshot() == before
    bad_finish = [
        (ValueError, dict(y=y[:, :4])), (ValueError, dict(ks=ks[:5])),
        (ValueError, dict(y=y.t().contiguous().t())),
        (TypeError, dict(y=y.float())), (TypeError, dict(h=h.float())),
        (ValueError, dict(t1=t1[:2])), (TypeError, dict(n=n.int())),
        (TypeError, dict(active=active.to(torch.uint8))),
        (ValueError, dict(y=y[0]))]
    names = ("y", "ks", "t", "h", "t1", "n", "active")
    for err, change in bad_finish:
        with pytest.raises(err):
            k3.rk_finish(*[change.get(k, x) for k, x in zip(names, args)],
                         consts)
    with pytest.raises(TypeError, match="attempt_consts"):
        k3.rk_finish(*args, (consts.b, consts.e, consts.prm))
    for i in (0, 6, -1):
        with pytest.raises(ValueError, match="stage index"):
            k3.rk_stage(y, ks, h, consts, i)
    with pytest.raises(ValueError):
        k3.rk_stage(y, ks[:, :2], h, consts, 2)
    with pytest.raises(TypeError):
        k3.rk_stage(y, ks, h.float(), consts, 2)
    # the kernels take the solver's three stage counts only
    four = tode.Tableau(c=np.zeros(4), a=np.tril(np.ones((4, 4)), -1),
                        b=np.ones(4), e=np.ones(4), order=4)
    with pytest.raises(ValueError, match="stages"):
        k3._check_kernel_shape("rk_finish", y,
                               k3.attempt_consts(four, 0.0, 1e-3, "cpu"))
    with pytest.raises(ValueError, match="lower triangular"):
        k3.attempt_consts(four._replace(a=np.ones((4, 4))), 0.0, 1e-3, "cpu")
    with pytest.raises(ValueError):
        k3.attempt_consts(four._replace(e=np.ones(3)), 0.0, 1e-3, "cpu")


@pytest.mark.parametrize("tab", ["RKF45", "DOPRI5", "DOP853"])
def test_attempt_consts_hold_the_tableau(tab):
    """One upload carries a, b, e, c and the controller's scalars, each
    bit-equal to its source."""
    tab = getattr(tode, tab)
    consts = k3.attempt_consts(tab, 1e-7, 1e-2, "cpu")
    s = len(tab.c)
    assert consts.s == s and consts.device == torch.device("cpu")
    for got, ref in ((consts.a, tab.a), (consts.b, tab.b), (consts.e, tab.e),
                     (consts.c, tab.c[:, None])):
        assert got.is_contiguous() and got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(consts.prm,
                       k3.controller_params(1e-7, 1e-2, tab.order, "cpu"))
    np.testing.assert_array_equal(
        consts.host, np.concatenate([tab.b, tab.e, consts.prm.numpy()]))
    assert consts.host_ptr == consts.host.ctypes.data
    with pytest.raises(AttributeError):
        consts.s = 3


# (D, rows 16-byte aligned) -> (blocks a lane, 16-byte accesses): the
# growth states stay in one block, the nk=128 eta state takes eight
CLUSTER_PLANS = [(2, True, 1, True), (102, True, 1, True),
                 (1024, True, 1, True), (1026, True, 2, True),
                 (3000, True, 4, True), (5248, True, 8, True),
                 (5248, False, 8, False), (5247, True, 8, False),
                 (41 * 512, True, 8, True), (511, True, 1, False)]


@pytest.mark.parametrize("D,aligned,cl,vec", CLUSTER_PLANS)
def test_cluster_plan(D, aligned, cl, vec):
    assert k3.cluster_plan(D, aligned) == (cl, vec)
    assert cl in k3.CLUSTER_SIZES


def test_cluster_plan_refuses_what_a_cluster_cannot_hold():
    """A lane that eight blocks cannot keep in registers takes eight
    blocks that loop over their slices in passes (any D runs)."""
    for D, aligned, passes in ((2 * 8 * 2048, True, False),
                               (2 * 8 * 2048 + 2, True, True),
                               (8 * 2048, False, False),
                               (8 * 2048 + 1, False, True),
                               (41 * 1024, True, True), (5248, True, False)):
        cl, vec = k3.cluster_plan(D, aligned)
        assert k3.in_passes(D, cl, vec) is passes, D
        assert cl == 8 or not passes


def test_launch_counts_by_phase():
    """counts.mark books the launches since the last mark to a phase;
    reset clears the phases too."""
    counts.reset()
    try:
        counts.LAUNCHES["rk_finish"] += 3
        counts.mark("prepare")
        counts.LAUNCHES["rk_finish"] += 2
        counts.LAUNCHES["out_leg"] += 1
        counts.mark("solve")
        counts.LAUNCHES["rk_finish"] += 1
        counts.mark("prepare")
        by_phase = counts.phases()
        assert by_phase["prepare"]["rk_finish"] == 4
        assert by_phase["solve"]["rk_finish"] == 2
        assert by_phase["solve"]["out_leg"] == 1
        assert by_phase["prepare"]["out_leg"] == 0
        assert counts.snapshot()["rk_finish"] == 6
    finally:
        counts.reset()
    assert counts.phases() == {} and not any(counts.snapshot().values())


def test_rk_finish_plain_controller_and_frozen_lanes():
    """The GSL controller on hand-made lanes: reject (r > 1.1) shrinks h,
    accept with r < 0.5 grows it, the final step lands on t1 (and only
    it reaches its interval's end), and inactive lanes keep their
    state."""
    B, D = 4, 3
    y = torch.ones((B, D), dtype=torch.float64)
    ks = torch.zeros((6, B, D), dtype=torch.float64)
    ks[0, 0] = 1e3           # lane 0: large error -> reject
    ks[0, 1] = 1e-9          # lane 1: tiny error -> grow
    ks[0, 2] = 1e-9          # lane 2: final step clipped to t1
    ks[0, 3] = 1e3           # lane 3: inactive
    t = torch.zeros(B, dtype=torch.float64)
    h = torch.tensor([0.1, 0.1, 0.5, 0.1], dtype=torch.float64)
    t1 = torch.tensor([1.0, 1.0, 0.2, 1.0], dtype=torch.float64)
    n = torch.zeros(B, dtype=torch.int64)
    active = torch.tensor([True, True, True, False])
    consts = k3.attempt_consts(tode.RKF45, 1e-7, 1e-2, "cpu")
    before = counts.snapshot()
    y2, t2, h2, n2, r, reached = k3.rk_finish(y, ks, t, h, t1, n, active,
                                              consts)
    assert counts.snapshot() == before
    assert float(r[0]) > 1.1 and float(t2[0]) == 0.0
    assert torch.equal(y2[0], y[0]) and float(h2[0]) < 0.1
    assert float(r[1]) < 0.5 and float(t2[1]) == 0.1
    assert 0.1 < float(h2[1]) <= 0.5
    assert float(t2[2]) == 0.2                       # landed on t1
    assert torch.equal(y2[3], y[3]) and float(t2[3]) == 0.0
    assert float(h2[3]) == 0.1 and n2.tolist() == [1, 1, 1, 0]
    assert reached.tolist() == [False, False, True, False]


def test_chip_smoke_inputs_match_the_golden():
    """chip_smoke.py's design lanes 0-1, redshifts and linear inputs are
    the ones each JAX golden (full TRG, 1-loop, the two presets, the
    numerics run, the production chain) was written from, and the script
    imports no JAX."""
    code = ("import sys, numpy as np, chip_smoke as s\n"
            "from redtime_tpu_torch.io.camb import LinearData\n"
            "g = np.load(s.GOLDEN)\n"
            "assert np.array_equal(g['params'], s.design_params()[:2])\n"
            "assert np.array_equal(g['z_out'], s.Z_OUT)\n"
            "for name, x in zip(LinearData._fields, s.example_linear()):\n"
            "    assert np.array_equal(g[name], x), name\n"
            "assert g['table'].shape == (2, len(s.Z_OUT), 128, 17)\n"
            "g = np.load(s.GOLDEN_1L)\n"
            "assert np.array_equal(g['params'], "
            "s.design_params(s.N_DESIGN_1L)[:2])\n"
            "assert np.array_equal(g['z_out'], s.Z_OUT_1L)\n"
            "for name, x in zip(LinearData._fields, s.example_linear()):\n"
            "    assert np.array_equal(g[name], x), name\n"
            "assert g['table'].shape == (2, len(s.Z_OUT_1L), 128, 32)\n"
            "for name, (nk, path) in s.GOLDEN_PRESETS.items():\n"
            "    g = np.load(path)\n"
            "    assert np.array_equal(g['params'], s.design_params()[:2])\n"
            "    assert np.array_equal(g['z_out'], s.Z_OUT_PRESETS)\n"
            "    for f, x in zip(LinearData._fields, s.example_linear()):\n"
            "        assert np.array_equal(g[f], x), (name, f)\n"
            "    assert g['table'].shape == (2, 2, nk, 17), name\n"
            "g = np.load(s.GOLDEN_NUMERICS)\n"
            "assert np.array_equal(g['params'], s.design_params()[:2])\n"
            "assert np.array_equal(g['z_out'], s.Z_OUT_1L)\n"
            "for name, x in zip(LinearData._fields, s.example_linear()):\n"
            "    assert np.array_equal(g[name], x), name\n"
            "assert g['table'].shape == (2, len(s.Z_OUT_1L), 128, 17)\n"
            "from redtime_tpu_torch import design, orchestrate\n"
            "from redtime_tpu_torch.convert import STEP_TO_ZBLOCK\n"
            "g = np.load(s.GOLDEN_PROD)\n"
            "rows = design.models_from_unit_cube(design.latin_hypercube("
            "s.N_PROD, 8, s.SEED))\n"
            "assert np.array_equal(g['design'], rows[:2])\n"
            "assert np.array_equal(g['z_out'], np.asarray("
            "orchestrate.CAMB_Z_LIST.split(), dtype=float))\n"
            "assert list(g['steps']) == sorted(STEP_TO_ZBLOCK)\n"
            "assert g['table'].shape == (2, 8, 128, 17)\n"
            "assert g['inject_table'].shape == (2, 8, 128, 17)\n"
            "assert g['full_pk'].shape[2] == s.N_PM + 2\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'redtime_tpu')]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card():
    """With no CUDA device the smoke exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_probes_entry_point_fails_without_a_card():
    """python -m redtime_tpu_torch.probes on a machine with no CUDA device
    exits non-zero and reports no probe."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "redtime_tpu_torch.probes"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "OK" not in out.stdout


# (B, nfam, 2np, O): ragged and full chunks, 1-loop's 7 families and
# full TRG's 14, the default, v0.1 and HIGH_ACCURACY output grids.  Those
# of up to 16 lanes (the main path's chunk) and the narrow side of the
# measured crossing on two grids take the narrow schedule; the solve
# cells' shapes (512 lanes at nk=128, 64 at nk=512), the crossing's wide
# side and a ragged shape take a wide one.
K1_ALL = [(B, nfam, K, O) for B in (1, 3, 16, 33) for nfam in (7, 14)
          for K in (1024, 4096) for O in (129, 257, 513)]
K1_NARROW = ([s for s in K1_ALL if s[0] <= 16]
             + [(48, 14, 1024, 129), (32, 14, 4096, 513)])
K1_WIDE = [(512, 14, 1024, 129), (64, 14, 4096, 513), (64, 14, 1024, 129),
           (24, 14, 4096, 513), (300, 14, 2048, 257)]
K1_SHAPES = K1_ALL + K1_NARROW[-2:] + K1_WIDE
# (B, nk, np): the default, v0.1 and HIGH_ACCURACY grids
K2_SHAPES = [(B, nk, npts) for B in (1, 3, 16, 33)
             for nk, npts in ((128, 512), (256, 2048), (512, 2048))]
# (nk, np_factor): grids whose 2np is no power of two or whose np leaves
# a ragged last K-step (nk = 16, 48, 96 at np = 4nk; np_factor 8 at
# nk = 128 and 48; an odd nk)
RAGGED_GRIDS = [(16, 4), (48, 4), (96, 4), (128, 8), (48, 8), (37, 4)]


def _k1_bound(tab, G):
    """2K eps (|prod| @ |G|): the forward-error bound of a K-term f64 dot
    product, with margin 2, for any order of summation."""
    B, _, nfam, _, K = tab.shape
    prod = tab[:, 0, :, :, None, :] * tab[:, 1, :, None, :, :] / K
    return 2 * K * EPS * torch.matmul(
        prod.abs().reshape(B, nfam, 9, K), G.abs()).reshape(
            B, nfam, 3, 3, G.shape[-1])


def _k2_bound(T, P, kfac, nshift):
    """2np eps (|T| @ |P|) |kfac P|: the dot product's forward-error bound
    (the contraction cancels ~1e8 per element, so no relative bound)."""
    nk, npts = T.shape[1:]
    dot = torch.einsum("nim,bam->bnai", T.abs(), P.abs())
    return (2 * npts * EPS * dot[:, :, :, None, :]
            * (kfac * P[:, None, None, :, nshift:nshift + nk]).abs())


@pytest.mark.parametrize("n_sm", [132, 114])
def test_out_leg_schedule_rule(n_sm):
    """K1's schedule rule, from the shape and the SM count alone.  On the
    132 SMs its costs were fitted on: the narrow schedule at every shape of
    K1_NARROW (the main path's 16-lane chunk among them), so those
    launches run the parent's code, and a wide one at
    K1_WIDE, the two sides of the measured crossing on two grids among
    them.  On 114 SMs: narrow up to 16 lanes, wide at the solve cells'
    shapes."""
    narrow, wide = K1_NARROW, K1_WIDE
    if n_sm != 132:
        narrow, wide = [s for s in K1_NARROW if s[0] <= 16], K1_WIDE[:2]
    for B, nfam, K, O in narrow:
        assert k1.schedule(B, nfam, O, n_sm) == k1.NARROW, (B, nfam, K, O)
    for B, nfam, K, O in wide:
        sched = k1.schedule(B, nfam, O, n_sm)
        assert sched in k1.SCHEDULES and sched != k1.NARROW, (B, O)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """On the card: K1 and K2 against their plain versions at the main
    path's shapes, within the dot-product forward-error bounds, and the
    same bits from two calls."""
    cfg = TCfg()
    ec = tf.engine_consts(cfg, cuda_device)
    rng = np.random.default_rng(7)
    tab = torch.as_tensor(rng.standard_normal((4, 2, tf.NFAM, 3,
                                               2 * cfg.npts)),
                          device=cuda_device)
    before = counts.snapshot()
    J, J_ref = k1.out_leg(tab, ec.G), k1.out_leg_plain(tab, ec.G)
    assert bool(((J - J_ref).abs() <= _k1_bound(tab, ec.G)).all())
    assert torch.equal(J, k1.out_leg(tab, ec.G))
    lnP = torch.as_tensor(8.0 - 0.3 * rng.standard_normal((4, 3, cfg.nk)),
                          device=cuda_device)
    P = tf.extend_power(cfg, lnP, torch.full((4,), 0.96, dtype=torch.float64,
                                             device=cuda_device), ec)
    args = (ec.toeplitz_sl, P, ec.pz_kfac_sl, cfg.nshift)
    PZ, PZ_ref = k2.pz_leg(*args), k2.pz_leg_plain(*args)
    assert bool(((PZ - PZ_ref).abs() <= _k2_bound(*args)).all())
    assert torch.equal(PZ, k2.pz_leg(*args))
    after = counts.snapshot()
    assert after["out_leg"] == before["out_leg"] + 2
    assert after["pz_leg"] == before["pz_leg"] + 2


@pytest.mark.cuda
def test_cuda_out_leg_shapes(cuda_device):
    """On the card: K1 against its plain version at every shape the port
    uses (K1_SHAPES, G padded as engine_consts pads it), bit-equal over
    two calls, in the schedule out_leg.schedule picks (the narrow one at
    K1_NARROW, a wide one at K1_WIDE; each call counted by
    SCHEDULE_LAUNCHES) and in every other schedule the kernel is built
    with; the wrapper raises on a K the kernel does not take."""
    rng = np.random.default_rng(11)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for B, nfam, K, O in K1_SHAPES:
        tab = torch.as_tensor(rng.standard_normal((B, 2, nfam, 3, K)),
                              device=cuda_device)
        G = k1.padded(torch.as_tensor(rng.standard_normal((nfam, K, O)),
                                      device=cuda_device))
        sched = k1.schedule(B, nfam, O, n_sm)
        before = k1.SCHEDULE_LAUNCHES.get(sched, 0)
        J_ref, bound = k1.out_leg_plain(tab, G), _k1_bound(tab, G)
        J = k1.out_leg(tab, G)
        assert bool(((J - J_ref).abs() <= bound).all()), (B, nfam, K, O)
        assert torch.equal(J, k1.out_leg(tab, G)), (B, nfam, K, O)
        assert k1.SCHEDULE_LAUNCHES[sched] == before + 2, (B, nfam, K, O)
        for other in k1.SCHEDULES:
            J = k1._launch(tab, G, other)
            assert bool(((J - J_ref).abs() <= bound).all()), (other, B, O)
            assert torch.equal(J, k1._launch(tab, G, other)), (other, B, O)
    with pytest.raises(ValueError, match="even K"):
        k1.out_leg(tab[..., :767].contiguous(), G[:, :767])


@pytest.mark.cuda
def test_cuda_pz_leg_shapes(cuda_device):
    """On the card: K2 against its plain version at every grid the port
    uses (K2_SHAPES), bit-equal over two calls."""
    rng = np.random.default_rng(12)
    for B, nk, npts in K2_SHAPES:
        T = torch.as_tensor(rng.standard_normal((7, nk, npts)),
                            device=cuda_device)
        P = torch.as_tensor(np.exp(rng.standard_normal((B, 3, npts))),
                            device=cuda_device)
        kfac = torch.as_tensor(rng.standard_normal(nk), device=cuda_device)
        args = (T, P, kfac, (npts - nk) // 2)
        PZ = k2.pz_leg(*args)
        err = (PZ - k2.pz_leg_plain(*args)).abs()
        assert bool((err <= _k2_bound(*args)).all()), (B, nk, npts)
        assert torch.equal(PZ, k2.pz_leg(*args)), (B, nk, npts)


@pytest.mark.cuda
@pytest.mark.parametrize("nk,np_factor", RAGGED_GRIDS)
def test_cuda_legs_on_ragged_grids(cuda_device, nk, np_factor):
    """On the card: K1 and K2 on the engine's own constants of grids
    whose K is no multiple of the kernels' K-steps, against their plain
    versions within the dot-product bounds, the same bits on two calls;
    B = 2 and 16 lanes, 7 and 14 families."""
    cfg = TCfg(nk=nk, np_factor=np_factor)
    ec = tf.engine_consts(cfg, cuda_device)
    rng = np.random.default_rng(nk * np_factor)
    K = 2 * cfg.npts
    for B in (2, 16):
        for nfam in (7, tf.NFAM):
            tab = torch.as_tensor(rng.standard_normal((B, 2, nfam, 3, K)),
                                  device=cuda_device)
            G = ec.G[:nfam]
            J = k1.out_leg(tab, G)
            err = (J - k1.out_leg_plain(tab, G)).abs()
            assert bool((err <= _k1_bound(tab, G)).all()), (B, nfam)
            assert torch.equal(J, k1.out_leg(tab, G)), (B, nfam)
        lnP = torch.as_tensor(8.0 - 0.3 * rng.standard_normal((B, 3, nk)),
                              device=cuda_device)
        P = tf.extend_power(cfg, lnP, torch.full(
            (B,), 0.96, dtype=torch.float64, device=cuda_device), ec)
        args = (ec.toeplitz_sl, P, ec.pz_kfac_sl, cfg.nshift)
        PZ = k2.pz_leg(*args)
        assert bool(((PZ - k2.pz_leg_plain(*args)).abs()
                     <= _k2_bound(*args)).all()), B
        assert torch.equal(PZ, k2.pz_leg(*args)), B


# (nk, np_factor, lanes) of K9 and K10: the main path's chunks (16, 64)
# and packed lanes (8), nk=48, the presets' grids (nk = 512, 256 at np =
# 2048, 2 lanes) and ragged ones (nk = 37, 16; np_factor 8)
ENGINE_GRIDS = [(128, 4, 16), (128, 4, 64), (128, 8, 8), (48, 4, 2),
                (512, 4, 2), (256, 8, 2), (37, 4, 3), (16, 4, 5)]


def _within(got, ref, bound):
    """NaN in the same places; elsewhere |got - ref| <= bound."""
    fin = torch.isfinite(ref)
    return bool(torch.equal(got.isnan(), ref.isnan())
                and ((got - ref).abs() <= bound)[fin].all())


@pytest.mark.cuda
@pytest.mark.parametrize("nk,np_factor,B", ENGINE_GRIDS)
def test_cuda_engine_legs_match_plain(cuda_device, nk, np_factor, B):
    """On the card: K9 engine_front on a state's ln P rows (a strided view,
    clipped as the RHS clips them; a NaN lane, a lane past the clip on
    both sides) and K10 tab_leg on its ci with 7 and 14 families, against
    their plain versions within their stated bounds, the same bits on two
    calls; then compute_J_PZ launches K9, K10, K1 and K2 once each."""
    cfg = TCfg(nk=nk, np_factor=np_factor)
    ec = tf.engine_consts(cfg, cuda_device)
    rng = np.random.default_rng(nk * B)
    y = 8.0 - 0.3 * rng.standard_normal((B, 41, nk))
    y[0, 0, : nk // 2], y[0, 2, nk // 2:] = 400.0, -400.0
    if B > 1:
        y[-1] = np.nan
    lnP = torch.as_tensor(y, device=cuda_device)[:, :3]
    n_s = torch.as_tensor(rng.uniform(0.9, 1.0, B), device=cuda_device)
    front = (lnP, n_s, ec.pab_M, ec.pab_v, ec.wp, ec.kbias, ec.dft_fwd_half)
    band = (ec.pab_j0, ec.pab_w, ec.wc_half, ec.twiddle)
    before = counts.snapshot()
    P, ci = k9.engine_front(*front, *band, clip=True)
    P_ref, ci_ref, dP, dci = k9.error_bound(*front, clip=True)
    assert _within(P, P_ref, dP) and _within(ci, ci_ref, dci)
    assert bool(torch.isfinite(P[0]).all() and torch.isfinite(ci[0]).all())
    P2, ci2 = k9.engine_front(*front, *band, clip=True)
    assert torch.equal(P.nan_to_num(), P2.nan_to_num())
    assert torch.equal(ci.nan_to_num(), ci2.nan_to_num())
    g = (ec.ga_re, ec.ga_im, ec.gb_re, ec.gb_im, ec.dft_bwd_half, ec.twiddle)
    for nfam in (7, tf.NFAM):
        tab = k10.tab_leg(ci_ref, *g, nfam)
        ref, bound = k10.error_bound(ci_ref, *g[:5], nfam)
        assert _within(tab, ref, bound), nfam
        assert torch.equal(tab.nan_to_num(), k10.tab_leg(ci_ref, *g, nfam)
                           .nan_to_num()), nfam
        assert bool(torch.isfinite(tab[:B - 1]).all()), nfam
    after = counts.snapshot()
    assert after["engine_front"] == before["engine_front"] + 2
    assert after["tab_leg"] == before["tab_leg"] + 4
    tf.compute_J_PZ(cfg, lnP, n_s, True, ec, clip=True)
    ran = {k: v - after[k] for k, v in counts.snapshot().items()}
    assert ran == dict(dict.fromkeys(ran, 0), engine_front=1, tab_leg=1,
                       out_leg=1, pz_leg=1)


# (tableau, D): the main path's states (growth ramp, growth segments,
# eta at nk=128), an odd D (8-byte accesses, eight a thread), a ragged
# one and the nk=512 state (eight 16-byte accesses a thread)
RK_SHAPES = [("DOP853", 2), ("DOPRI5", 102), ("RKF45", 41 * 128),
             ("DOP853", 41 * 128 - 1), ("DOPRI5", 3000),
             ("RKF45", 41 * 512)]


@pytest.mark.cuda
def test_cuda_rk_finish_matches_plain(cuda_device):
    """On the card: K3's rk_finish against the plain version at
    RK_SHAPES: y, t, h, n and r bit for bit; the same bits from two
    calls; a NaN stage gives a NaN r in its lane alone, the rest still
    bit for bit; frozen lanes stay."""
    rng = np.random.default_rng(3)
    for name, D in RK_SHAPES:
        args, consts = _rk_args(8, D, rng, cuda_device, getattr(tode, name))
        plain = lambda a: k3.rk_finish_plain(*a, consts.b, consts.e,
                                             consts.prm)
        before = counts.LAUNCHES["rk_finish"]
        out, ref = k3.rk_finish(*args, consts), plain(args)
        assert counts.LAUNCHES["rk_finish"] == before + 1
        for i, (a, b) in enumerate(zip(out, ref)):
            assert torch.equal(a, b), (name, D, i)
        for a, b in zip(out, k3.rk_finish(*args, consts)):
            assert torch.equal(a, b), (name, D)
        assert torch.equal(out[0][-1], args[0][-1])     # the frozen lane
        args[1][2, 1, D // 2] = float("nan")
        out, ref = k3.rk_finish(*args, consts), plain(args)
        assert torch.equal(out[4].isnan(), ref[4].isnan())
        assert out[4].isnan().tolist() == [False, True] + [False] * 6
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


# (tableau, D) of lanes that eight blocks cannot keep in registers: the
# eta state at nk = 1024 (16-byte accesses) and an odd D above 16384
# (8-byte ones, nk = 401)
RK_PASSES_SHAPES = [("RKF45", 41 * 1024), ("DOP853", 41 * 401)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,D", RK_PASSES_SHAPES)
def test_cuda_rk_attempt_in_passes(cuda_device, name, D):
    """On the card: K3 on a lane larger than a cluster's registers hold
    (its blocks loop over their slices): rk_finish's five outputs and
    rk_stage at every stage bit-equal to the plain versions, accepted,
    rejected and frozen lanes alike."""
    rng = np.random.default_rng(D)
    args, consts = _rk_args(8, D, rng, cuda_device, getattr(tode, name))
    # steps from 1e-12 (accepted) to 1 (rejected)
    args[3] = torch.logspace(-12, 0, 8, dtype=torch.float64,
                             device=cuda_device)
    cl, vec = k3.cluster_plan(D, True)
    assert k3.in_passes(D, cl, vec)
    ref = k3.rk_finish_plain(*args, consts.b, consts.e, consts.prm)
    rej = ref[4] > k3.REJECT_ABOVE
    assert 0 < int(rej.sum()) < 8
    for _ in range(2):
        for i, (a, b) in enumerate(zip(k3.rk_finish(*args, consts), ref)):
            assert torch.equal(a, b), (name, D, i)
    y, ks, h = args[0], args[1], args[3]
    for i in range(1, consts.s):
        assert torch.equal(k3.rk_stage(y, ks, h, consts, i),
                           k3.rk_stage_plain(y, ks, h, consts.a[i], i)), i


# (tableau, D, eabs, erel) of the attempts whose final-step rule the
# packed scheduler changes: the eta state at nk=128 and at the presets'
# grids (nk = 512, 256), and the growth cases
RK_RULE_CASES = [("DOP853", 2, 0.0, 1e-6), ("DOPRI5", 102, 0.0, 1e-6),
                 ("RKF45", 41 * 128, 1e-7, 1e-2),
                 ("RKF45", 41 * 512, 1e-15, 1e-6),
                 ("RKF45", 41 * 256, 1e-15, 1e-6)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,D,eabs,erel", RK_RULE_CASES)
def test_cuda_rk_finish_final_rule(cuda_device, name, D, eabs, erel):
    """On the card: K3's rk_finish under both final-step rules against
    its plain version, all six outputs (reached included) bit for bit,
    on chip_smoke's attempt with a lane that steps exactly onto t1 and
    one where t + h rounds onto t1 short of it."""
    import chip_smoke

    tab = getattr(tode, name)
    rng = np.random.default_rng(D)
    args = chip_smoke.final_rule_lanes(
        chip_smoke.rk_inputs(rng, tab, 16, D, eabs, cuda_device))
    reached = {}
    for ge in (False, True):
        consts = k3.attempt_consts(tab, eabs, erel, cuda_device,
                                   final_at_equal=ge)
        out = k3.rk_finish(*args, consts)
        ref = k3.rk_finish_plain(*args, consts.b, consts.e, consts.prm, ge)
        for i, (a, b) in enumerate(zip(out, ref)):
            assert torch.equal(a, b), (name, D, ge, i)
        reached[ge] = out[5]
    assert bool(reached[True][0]) and not bool(reached[False][0])
    assert not bool(reached[True][1])


@pytest.mark.cuda
def test_cuda_rk_stage_equals_plain(cuda_device):
    """On the card: K3's rk_stage against its plain version, bit for bit,
    at every stage index of RK_SHAPES' tableaux; one launch counted per
    call."""
    rng = np.random.default_rng(4)
    for name, D in RK_SHAPES:
        (y, ks, _, h, *_), consts = _rk_args(8, D, rng, cuda_device,
                                            getattr(tode, name))
        before = counts.LAUNCHES["rk_stage"]
        for i in range(1, consts.s):
            assert torch.equal(
                k3.rk_stage(y, ks, h, consts, i),
                k3.rk_stage_plain(y, ks, h, consts.a[i], i)), (name, D, i)
        assert counts.LAUNCHES["rk_stage"] == before + consts.s - 1


PROBE_SIZES = [1, 8 * 128, 1000, 2 ** 20 + 3]
DOT_SHAPES = [(128, 512, 256), (1, 1, 1), (67, 130, 33), (129, 1023, 257),
              (2016, 1024, 256), (67, 1000, 33)]


@pytest.mark.cuda
def test_cuda_probe_kernels_equal_plain(cuda_device):
    """On the card: K4, K5 and K6 bit for bit against their plain
    versions, at the probes' shapes, larger and ragged ones; one launch
    counted per call."""
    rng = np.random.default_rng(8)

    def f32(n):
        return torch.as_tensor((rng.standard_normal(n) * np.exp(
            rng.uniform(-8, 8, n))).astype(np.float32), device=cuda_device)

    # a view that starts off a 16-byte boundary: every element goes alone
    off = f32(1001)[1:]
    assert torch.equal(kp.affine(off), kp.affine_plain(off))
    before = counts.snapshot()
    for n in PROBE_SIZES:
        x = f32(n)
        assert torch.equal(kp.affine(x), kp.affine_plain(x))
        args = [f32(n) for _ in range(4)]
        for got, ref in zip(kp.dd_mul(*args), kp.dd_mul_plain(*args)):
            assert torch.equal(got, ref)
    for M, K, N in DOT_SHAPES:
        a = torch.as_tensor(rng.integers(-128, 128, (M, K)).astype(np.int8),
                            device=cuda_device)
        b = torch.as_tensor(rng.integers(-128, 128, (K, N)).astype(np.int8),
                            device=cuda_device)
        assert torch.equal(kp.int8_dot(a, b), kp.int8_dot_plain(a, b))
    after = counts.snapshot()
    assert after["affine"] == before["affine"] + len(PROBE_SIZES)
    assert after["dd_mul"] == before["dd_mul"] + len(PROBE_SIZES)
    assert after["int8_dot"] == before["int8_dot"] + len(DOT_SHAPES)
    with pytest.raises(ValueError, match="devices"):
        kp.int8_dot(a, b.cpu())


@pytest.mark.cuda
def test_cuda_oz_fused_equals_plain(cuda_device):
    """On the card: K7 bit for bit against oz_fused_plain in oh and ol at
    chip_smoke's shapes: probe4's inputs, its edge rows and OZ_CASES (the
    tiling's edges); its pack bit for bit against oz_pack_w_plain; one
    launch of each kernel counted per call."""
    import chip_smoke

    rng = np.random.default_rng(9)
    x, xh, xl, ws = probes.probe4_inputs(cuda_device)
    edge = chip_smoke.oz_edge_rows(x.cpu().numpy(), rng)
    cases = [(xh, xl, ws),
             (*(torch.as_tensor(a, device=cuda_device) for a in (
                 edge.astype(np.float32),
                 (edge - edge.astype(np.float32)).astype(np.float32))), ws)]
    for M, K, O in chip_smoke.OZ_CASES:
        xr = rng.standard_normal((M, K))
        cases.append((
            torch.as_tensor(xr.astype(np.float32), device=cuda_device),
            torch.as_tensor((xr - xr.astype(np.float32)).astype(np.float32),
                            device=cuda_device),
            torch.as_tensor(rng.integers(-64, 64, (4, K, O)).astype(np.int8),
                            device=cuda_device)))
    before = counts.snapshot()
    for args in cases:
        for got, ref in zip(kp.oz_fused(*args), kp.oz_fused_plain(*args)):
            assert torch.equal(got, ref), tuple(args[0].shape)
        assert torch.equal(kp.oz_pack_w(args[2]),
                           kp.oz_pack_w_plain(args[2]))
    after = counts.snapshot()
    assert after["oz_fused"] == before["oz_fused"] + len(cases)
    assert after["oz_pack_w"] == before["oz_pack_w"] + 2 * len(cases)
    with pytest.raises(ValueError, match="devices"):
        kp.oz_fused(xh, xl, ws.cpu())


@pytest.mark.cuda
def test_cuda_probes_entry_point(cuda_device):
    """python -m redtime_tpu_torch.probes runs probe1-probe4 and
    probe4_out_leg on the card, prints one line per probe and probe4's
    in-loop times."""
    for p in probes.PROBES:
        p(cuda_device)
    out = subprocess.run([sys.executable, "-m", "redtime_tpu_torch.probes"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    for p in probes.PROBES:
        assert any(line.startswith(f"{p.__name__}: OK") for line in lines)
    assert any(line.startswith("probe4 in-loop:") for line in lines)


def _k8_inputs(rng, B: int, nk: int, dev, nz: int = 8, nn: int = 41):
    """K8's arguments of each mode on generated inputs: y with lnP rows
    near a spectrum's and small I/Q rows, a NaN last lane; Omega tables
    of nz beta nodes (the lanes' a below, inside and past the table) and
    cosmology constants near the defaults', growth tables of nn ln a
    nodes."""
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    y = rng.standard_normal((B, 41, nk))
    y[:, :3] += 6.0
    y[:, 3:] *= 1e-3
    y[-1] = np.nan
    eta = t(rng.uniform(-0.5, 5.8, B))
    k = t(np.geomspace(1e-3, 1.0, nk))
    u = lambda lo, hi: t(rng.uniform(lo, hi, B))
    beta_a = np.sort(rng.uniform(0.005, 1.0, (B, nz)), axis=1)
    consts = bg.OmegaConsts(
        f_cb=u(0.95, 1.0), fcb_om=u(0.28, 0.32), OL=u(0.68, 0.72),
        Og=u(5e-5, 6e-5), og4=u(2e-4, 2.4e-4), a_nu=u(0.003, 0.02),
        y_cold=u(0.0, 0.05), y_hot=u(3e-5, 4e-5), dy_hot=u(-4e-5, -3e-5),
        wa=u(-0.3, 0.3), w1=u(-0.3, 0.3), e_pow=u(-0.9, 0.9),
        e_wa=u(-0.9, 0.9))
    om = k8.OmegaIn(t(beta_a), t(0.3 + rng.uniform(size=(B, nz, nk))),
                    u(0.0, 0.05), u(0.25, 0.35), consts, 1.0 / 201.0)
    full = k8.FullSrc(t(rng.standard_normal((B, 14, 3, 3, nk + 1))),
                      t(rng.standard_normal((B, 7, 3, 3, nk))))
    pos = lambda *shape: t(rng.uniform(0.5, 1.5, shape))
    g_lna = np.tile(np.linspace(np.log(1e-3), np.log(1.1), nn), (B, 1))
    oneloop = k8.OneLoopSrc(t(rng.standard_normal((B, 14, nk))),
                            t(rng.standard_normal((B, 3, 8, nk))), t(g_lna),
                            pos(B, nn, nk), pos(B, nn, nk), pos(B, nk),
                            pos(B, nk), 200.0)
    return t(y), eta, k, om, {"full": full, "oneloop": oneloop,
                              "linear": None}


@pytest.mark.cuda
def test_cuda_rhs_tail_matches_plain(cuda_device):
    """On the card: K8 against its plain version in each mode, with and
    without Q, at nk 48 and 128, with beta tables of 8, 4 and no nodes:
    within 1e-13 of each (lane, row)'s scale, NaN in the same places, the
    same bits from two calls."""
    rng = np.random.default_rng(13)
    for B, nk, nz in ((4, 48, 8), (3, 128, 4), (3, 128, 0)):
        y, eta, k, om, srcs = _k8_inputs(rng, B, nk, cuda_device, nz)
        for mode, src in srcs.items():
            for evolve_q in (True, False):
                if mode == "full" and not evolve_q:
                    src = k8.FullSrc(src.Jw[:, :7].contiguous(), src.PZw)
                args = (y, eta, k, om, src, evolve_q)
                before = counts.LAUNCHES["rhs_tail"]
                got, ref = k8.rhs_tail(*args), k8.rhs_tail_plain(*args)
                assert counts.LAUNCHES["rhs_tail"] == before + 1
                assert torch.equal(got.isnan(), ref.isnan()), mode
                fin = torch.isfinite(ref)
                scale = torch.where(fin, ref.abs(), 0.0).amax(-1, True)
                dev = torch.where(fin, (got - ref).abs(), 0.0) / (
                    scale + 1e-300)
                assert float(dev.max()) <= 1e-13, (mode, evolve_q, B, nk)
                again = k8.rhs_tail(*args)
                assert torch.equal(got.nan_to_num(), again.nan_to_num())
