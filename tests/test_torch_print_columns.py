"""The PRINT* output columns of the PyTorch port (the checks of
tests/test_print_columns.py, carried over), at nk=16.

Both packages get the same evolved state: the JAX package evolves one
cosmology in 1-loop mode with every print switch on, and the port
assembles its output blocks from those states on the JAX-prepared Model
(state.model_from_numpy).  Layout of the 84 columns:

    k | 6 lin | 3 P | 14 A | 14 I | 5 P_B + 9 PT + 8 PMR | 24 Q

Each group is rebuilt independently from the raw state (the P_B columns
through the fresh transcription of the reference's Pbisj, redTime.cc:
265-298, in tests/test_print_columns.py); the port's blocks are held to JAX's within 1e-11 of column
scale (the engine's bound, tests/test_torch_engine.py), and the writer's
bytes to JAX's for an identical 84-column table.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_print_columns import _pbis_reference
from torch_port_util import col_scale_dev
from __graft_entry__ import _cosmo, _example_inputs
from redtime_tpu import driver as jd
from redtime_tpu import model as jm
from redtime_tpu import trg as jt
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu.fastpt import engine_consts as j_engine_consts
from redtime_tpu.io import writer as jw
from redtime_tpu_torch import driver as td
from redtime_tpu_torch import state
from redtime_tpu_torch import trg as tt
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.fastpt import engine_consts
from redtime_tpu_torch.grids import make_grids
from redtime_tpu_torch.io import writer as tw

NK = 16
CFG = dict(nk=NK, np_factor=4, growth_n_lna=10, growth_n_lnk=6,
           quad_panels=8, quad_order=8, print_a=True, print_i=True,
           print_q=True, print_bias=True)
Z_OUT = (3.0, 0.0)
ONE_LOOP = dict(one_loop=True, z_out=Z_OUT)
FULL = dict(one_loop=False, z_out=Z_OUT)
C_A = 1 + 6 + 3                 # first PRINTA column
C_B = C_A + 14 + 14             # first P_B column


@functools.lru_cache(maxsize=1)
def _evolved():
    """(JAX model, its evolved states [2, 41, nk]) in 1-loop mode."""
    jc = JCfg(fft_mode="fft", **CFG)
    model = jax.jit(lambda c, l: jm.prepare_model(jc, c, l))(
        _cosmo(1), _example_inputs(jc))
    ys, _ = jt.evolve(jc, JSet(**ONE_LOOP), model, mode="fft")
    return model, np.asarray(ys).reshape(len(Z_OUT), 41, NK)


def _block(cfg_kw: dict, settings_kw: dict, i_eta: int) -> np.ndarray:
    """The port's output block [nk, ncol] at output i_eta."""
    model, ys = _evolved()
    tc = TCfg(**cfg_kw)
    b = td.build_output_block(tc, TSet(**settings_kw),
                              state.model_from_numpy(model),
                              torch.tensor(ys[i_eta])[None],
                              Z_OUT[i_eta], engine_consts(tc, "cpu"))
    return b[0].numpy()


def test_layout_is_84_columns():
    tc = TCfg(**CFG)
    assert td.n_columns(tc, TSet(**ONE_LOOP)) == 1 + 6 + 3 + 14 + 14 + 22 + 24
    assert _block(CFG, ONE_LOOP, 0).shape == (NK, 84)
    no_bias = dict(CFG, print_bias=False)
    assert td.n_columns(TCfg(**no_bias), TSet(**ONE_LOOP)) == 84 - 15
    assert _block(no_bias, ONE_LOOP, 1).shape == (NK, 69)


@pytest.mark.parametrize("i_eta", range(len(Z_OUT)))
def test_extended_columns_oracle(i_eta):
    _, ys = _evolved()
    tc = TCfg(**CFG)
    k = np.asarray(make_grids(tc).k)
    y = ys[i_eta]
    block = _block(CFG, ONE_LOOP, i_eta)
    r = (1.0 / (1.0 + Z_OUT[i_eta])) / TSet(**ONE_LOOP).a_in
    c = 1 + 6

    # P columns: exp(y) x (a/a_in)^2
    np.testing.assert_allclose(block[:, c:c + 3], (np.exp(y[0:3]) * r ** 2).T,
                               rtol=1e-14)
    c += 3

    # PRINTA: the raw A_u at the output time, no scale factor
    model, _ = _evolved()
    A_u, _, PTjm, PMR = (x[0].numpy() for x in tt.compute_mode_coupling_full(
        tc, torch.tensor(y[0:3])[None],
        state.model_from_numpy(model).cosmo.n_s, True, torch.tensor(k),
        engine_consts(tc, "cpu")))
    np.testing.assert_allclose(block[:, c:c + 14], A_u.T, rtol=1e-12,
                               atol=1e-300)
    c += 14

    # PRINTI: the raw state slots, bitwise
    np.testing.assert_array_equal(block[:, c:c + 14],
                                  y[tt.NUP:tt.NUP + tt.NUI].T)
    c += 14

    # PRINTBIAS P_B: the independent Pbisj transcription x r^3
    np.testing.assert_allclose(block[:, c:c + 5],
                               (_pbis_reference(k, y, NK) * r ** 3).T,
                               rtol=1e-12, atol=1e-300)
    c += 5

    # PT columns x r^4 in (j, m) order, then PMR x r^4
    np.testing.assert_allclose(block[:, c:c + 9], (PTjm * r ** 4).T,
                               rtol=1e-12, atol=1e-300)
    c += 9
    np.testing.assert_allclose(block[:, c:c + 8], (PMR * r ** 4).T,
                               rtol=1e-12, atol=1e-300)
    c += 8

    # PRINTQ: the raw Q slots x r^3
    np.testing.assert_allclose(block[:, c:c + 24],
                               (y[tt.NUP + tt.NUI:] * r ** 3).T, rtol=1e-15)
    c += 24
    assert c == block.shape[1]


def test_bias_split_consistent_with_collapsed():
    """print_bias=False prints P_B2 = (2,2)+(2,1), P_B4 = (4,1)+(4,0),
    P_B6 = (6,0) and the m-collapsed PT2/4/6/8 (redTime.cc:1727-1734):
    sums of the print_bias=True columns."""
    b_bias = _block(CFG, ONE_LOOP, 1)
    b_nb = _block(dict(CFG, print_bias=False), ONE_LOOP, 1)
    c = C_B
    pb5, pt9 = b_bias[:, c:c + 5], b_bias[:, c + 5:c + 14]
    close = functools.partial(np.testing.assert_allclose, rtol=1e-13,
                              atol=1e-300)
    close(b_nb[:, c], pb5[:, 0] + pb5[:, 1])
    close(b_nb[:, c + 1], pb5[:, 2] + pb5[:, 3])
    close(b_nb[:, c + 2], pb5[:, 4])
    close(b_nb[:, c + 3], pt9[:, 0] + pt9[:, 1] + pt9[:, 2])
    close(b_nb[:, c + 4], pt9[:, 3] + pt9[:, 4] + pt9[:, 5])
    close(b_nb[:, c + 5], pt9[:, 6] + pt9[:, 7])
    close(b_nb[:, c + 6], pt9[:, 8])
    # the Q block follows immediately in both layouts
    np.testing.assert_array_equal(b_nb[:, c + 7:], b_bias[:, c + 22:])


def test_full_trg_extended_blocks_zero():
    """Full-TRG mode gates the output-time recomputation off
    (redTime.cc:1646): the PRINTA block and the PT/PMR columns print zero
    while P_B (from the evolved Q) stays populated."""
    b = _block(CFG, FULL, 1)
    assert np.all(b[:, C_A:C_A + 14] == 0.0)
    assert np.any(b[:, C_B:C_B + 5] != 0.0)
    assert np.all(b[:, C_B + 5:C_B + 22] == 0.0)


def test_fill_pt_full_trg_flag():
    """fill_pt_full_trg=True computes the PT/PMR (and PRINTA) columns in
    full-TRG mode from the evolved spectra: the 1-loop block, bit for
    bit."""
    b_fill = _block(dict(CFG, fill_pt_full_trg=True), FULL, 1)
    np.testing.assert_array_equal(b_fill, _block(CFG, ONE_LOOP, 1))
    assert np.any(b_fill[:, C_B + 5:C_B + 22] != 0.0)


def _jax_finalize(cfg_kw: dict, settings_kw: dict):
    model, ys = _evolved()
    jc = JCfg(fft_mode="fft", **cfg_kw)
    return jd._finalize(jc, JSet(**settings_kw), model,
                        jnp.asarray(ys), "fft",
                        j_engine_consts(jc, "fft"))


@pytest.mark.parametrize("cfg_kw, settings_kw", [
    (CFG, ONE_LOOP), (dict(CFG, print_bias=False), ONE_LOOP),
    (dict(CFG, fill_pt_full_trg=True), FULL), (CFG, FULL)],
    ids=["bias", "no_bias", "fill_full_trg", "full_trg"])
def test_output_tables_match_jax(cfg_kw, settings_kw):
    """The port's _finalize on the JAX states against JAX's _finalize."""
    model, ys = _evolved()
    tc = TCfg(**cfg_kw)
    got = td._finalize(tc, TSet(**settings_kw), state.model_from_numpy(model),
                       torch.tensor(ys)[None], engine_consts(tc, "cpu"))
    ref = _jax_finalize(cfg_kw, settings_kw)
    tj, tt_ = np.asarray(ref.table), got.table[0].numpy()
    assert tt_.shape == tj.shape
    scale = np.max(np.abs(tj), axis=(0, 1), keepdims=True) + 1e-300
    assert np.max(np.abs(tt_ - tj) / scale) < 1e-11
    # zero columns are zero in both
    np.testing.assert_array_equal(tt_ == 0.0, tj == 0.0)
    for name in ("sigma_v2", "H", "sigmaV2_z0"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=0, err_msg=name)


def test_writer_bytes_equal_for_84_columns():
    ref_res = _jax_finalize(CFG, ONE_LOOP)
    one = type(ref_res)(*[np.asarray(x) for x in ref_res])
    assert one.table.shape[-1] == 84
    ref, got = io.StringIO(), io.StringIO()
    jw.write_result(ref, one, "params_redTime.dat")
    batch = td.RunResult(*[torch.tensor(x)[None] for x in one])
    tw.write_result(got, td.lane(batch, 0), "params_redTime.dat")
    assert got.getvalue() == ref.getvalue()
    first = got.getvalue().split("\n")
    assert any(len(line.split()) == 84 for line in first)


def test_run_batch_prints_every_column():
    """run_batch end to end with every print switch on (1-loop, nk=16):
    the 84-column table is finite and its extended blocks populated."""
    model, _ = _evolved()
    tc = TCfg(**CFG)
    cs = state.cosmo_from_numpy(model.cosmo)
    lin = state.linear_from_numpy(_example_inputs(JCfg(**CFG)))
    res = td.run_batch(tc, TSet(**ONE_LOOP), cs, lin, device="cpu")
    assert res.table.shape == (1, len(Z_OUT), NK, 84)
    assert len(td.finite_report(res)) == 0
    t = res.table[0].numpy()
    for c0, c1 in ((C_A, C_A + 14), (C_A + 14, C_B), (C_B, C_B + 22),
                   (C_B + 22, 84)):
        assert np.all(np.any(t[..., c0:c1] != 0.0, axis=1)), (c0, c1)
    # the table is the blocks of the states it evolved (the I columns)
    ref = _block(CFG, ONE_LOOP, 0)
    assert col_scale_dev(t[0, :, C_A + 14:C_B], ref[:, C_A + 14:C_B],
                         0) < 3e-5
