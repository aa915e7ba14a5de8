"""The hand kernels' wrappers (K1 out_leg, K2 pz_leg, K3 rk_finish, K4
affine, K5 int8_dot, K6 dd_mul, K7 oz_fused) and chip_smoke.py's inputs.  This file
imports no JAX, so its `cuda` tests also run on a GPU machine that has
none:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

On the CPU every wrapper takes its plain version and counts no launch; a
tensor on any other device never reaches the plain version.  On the card
each kernel is held to its plain version: K1 and K2 within the f64
dot-product forward-error bound (they sum in another order), K3
(rk_finish and rk_stage, which round every operation alone as their plain
versions do; CUDA's pow is the routine torch.pow runs) and K4-K7 bit for
bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch import ode as tode
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch import probes
from redtime_tpu_torch.kernels import out_leg as k1
from redtime_tpu_torch.kernels import probes as kp
from redtime_tpu_torch.kernels import pz_leg as k2
from redtime_tpu_torch.kernels import rk_finish as k3

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
    accept with r < 0.5 grows it, the final step lands on t1, and inactive
    lanes keep their state."""
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
    y2, t2, h2, n2, r = k3.rk_finish(y, ks, t, h, t1, n, active, consts)
    assert counts.snapshot() == before
    assert float(r[0]) > 1.1 and float(t2[0]) == 0.0
    assert torch.equal(y2[0], y[0]) and float(h2[0]) < 0.1
    assert float(r[1]) < 0.5 and float(t2[1]) == 0.1
    assert 0.1 < float(h2[1]) <= 0.5
    assert float(t2[2]) == 0.2                       # landed on t1
    assert torch.equal(y2[3], y[3]) and float(t2[3]) == 0.0
    assert float(h2[3]) == 0.1 and n2.tolist() == [1, 1, 1, 0]


def test_chip_smoke_inputs_match_the_golden():
    """chip_smoke.py's design lanes 0-1, redshifts and linear inputs are
    the ones each JAX golden (full TRG, 1-loop) was written from, and the
    script imports no JAX."""
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
# full TRG's 14, the default, v0.1 and HIGH_ACCURACY output grids
K1_SHAPES = [(B, nfam, K, O) for B in (1, 3, 16, 33) for nfam in (7, 14)
             for K in (1024, 4096) for O in (129, 257, 513)]
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
    two calls; the wrapper raises on a K the kernel does not take."""
    rng = np.random.default_rng(11)
    for B, nfam, K, O in K1_SHAPES:
        tab = torch.as_tensor(rng.standard_normal((B, 2, nfam, 3, K)),
                              device=cuda_device)
        G = k1.padded(torch.as_tensor(rng.standard_normal((nfam, K, O)),
                                      device=cuda_device))
        J = k1.out_leg(tab, G)
        err = (J - k1.out_leg_plain(tab, G)).abs()
        assert bool((err <= _k1_bound(tab, G)).all()), (B, nfam, K, O)
        assert torch.equal(J, k1.out_leg(tab, G)), (B, nfam, K, O)
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
    chip_smoke's shapes: probe4's inputs, its edge rows and two ragged
    shapes; one launch counted per call."""
    import chip_smoke

    rng = np.random.default_rng(9)
    x, xh, xl, ws = probes.probe4_inputs(cuda_device)
    edge = chip_smoke.oz_edge_rows(x.cpu().numpy(), rng)
    cases = [(xh, xl, ws),
             (*(torch.as_tensor(a, device=cuda_device) for a in (
                 edge.astype(np.float32),
                 (edge - edge.astype(np.float32)).astype(np.float32))), ws)]
    for M, K, O in ((77, 1000, 100), (300, 999, 129)):
        xr = rng.standard_normal((M, K))
        cases.append((
            torch.as_tensor(xr.astype(np.float32), device=cuda_device),
            torch.as_tensor((xr - xr.astype(np.float32)).astype(np.float32),
                            device=cuda_device),
            torch.as_tensor(rng.integers(-64, 64, (4, K, O)).astype(np.int8),
                            device=cuda_device)))
    before = counts.LAUNCHES["oz_fused"]
    for args in cases:
        for got, ref in zip(kp.oz_fused(*args), kp.oz_fused_plain(*args)):
            assert torch.equal(got, ref), tuple(args[0].shape)
    assert counts.LAUNCHES["oz_fused"] == before + len(cases)
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
