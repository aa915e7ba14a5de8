"""K11 out_block (redtime_tpu_torch/kernels/out_block.py) on the CPU.

  * out_block_plain, through driver._finalize (one engine call over the B
    n_z lanes, then the block), against the JAX package's _finalize on
    the same f64 states, made from a numpy seed, at nk = 16, in every
    layout family: full TRG, 1-loop, print_bias, every switch,
    fill_pt_full_trg, linear and kmin != 1e-3 (sigma_v^2 off the grid's
    first point), within 1e-11 of column scale (the engine's bound);
  * the traced programs the kernel runs, replayed on the CPU as torch runs
    each operation: P_T / P_MR bit-equal to assemble's, P_B to pbis_j's;
  * the batched engine over B n_z lanes (n_s shared by a lane's
    redshifts) against one call a redshift, within the engine's bound;
  * the generator: one case a layout, its groups in order at their first
    columns, its column count, for every switch setting;
  * the launch plan: every layout's tile fits the block's shared memory
    at nk = 48, 128 and the presets' nk, the timed shapes fill the 132
    SMs, the blocks' passes and chunks cover every k point once, the MAX_Z
    launches every redshift; models of the kernel's column units (every
    column of every layout written once) and of its tile store (the
    table's contiguous doubles, 16-byte pairs from an aligned address);
  * the wrapper's errors; on a card (marked cuda), K11 against its plain
    version, and under other launch plans the same bits.

JAX is imported inside the helpers, so the `cuda` test also runs on a
machine without it (python -m pytest --noconftest
tests/test_torch_out_block.py -m cuda).
"""

import functools
import itertools
import re

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from torch_port_util import col_scale_dev, jax_batch
from redtime_tpu_torch import assembly, driver, fastpt, state, trg
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.grids import make_grids
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch.kernels import out_block as ob

F64 = torch.float64
BASE = dict(nk=16, np_factor=4, growth_n_lna=10, growth_n_lnk=6,
            quad_panels=8, quad_order=8)
Z_OUT = (3.0, 1.0, 0.0)
ALL = dict(print_a=True, print_i=True, print_q=True, print_bias=True)
CASES = {
    "full_trg": ({}, dict(one_loop=False)),
    "one_loop": ({}, dict(one_loop=True)),
    "bias": (dict(print_bias=True), dict(one_loop=True)),
    "every_switch": (ALL, dict(one_loop=True)),
    "fill_full_trg": (dict(ALL, fill_pt_full_trg=True),
                      dict(one_loop=False)),
    "linear": (ALL, dict(nonlinear=False)),
    "kmin": (dict(kmin=5e-4, print_a=True), dict(one_loop=True)),
}


@functools.lru_cache(maxsize=2)
def _models(kmin: float):
    """The JAX package's prepared models of two cosmologies."""
    import jax

    from redtime_tpu import model as jm
    from redtime_tpu.config import SolverConfig as JCfg

    jc = JCfg(fft_mode="fft", kmin=kmin, **BASE)
    cosmos, lins = jax_batch(2, jc)
    return jax.jit(jax.vmap(lambda c, l: jm.prepare_model(jc, c, l)))(
        cosmos, lins)


def _lane(tree, b):
    import jax
    return jax.tree_util.tree_map(lambda x: x[b], tree)


@functools.lru_cache(maxsize=2)
def _states(kmin: float, seed: int = 3) -> np.ndarray:
    """States [2, n_z, 41, nk] like evolved ones: each lane's initial ln P
    rows grown by 2 eta, I and Q rows of the spectrum's scale."""
    from redtime_tpu import trg as jt
    from redtime_tpu.config import RunSettings as JSet
    from redtime_tpu.config import SolverConfig as JCfg

    jc = JCfg(kmin=kmin, **BASE)
    rng = np.random.default_rng(seed)
    nk = BASE["nk"]
    out = np.empty((2, len(Z_OUT), 41, nk))
    for b in range(2):
        y0 = np.asarray(jt.initial_state(jc, JSet(z_out=Z_OUT),
                                         _lane(_models(kmin), b)))
        for s, eta in enumerate((2.5, 3.4, 4.1)):
            y = y0.reshape(41, nk).copy()
            y[:3] += 2.0 * eta
            y[3:] = 1e-3 * np.exp(y[:1]) * rng.standard_normal((38, nk))
            out[b, s] = y
    return out


def _case(name: str):
    cfg_kw, set_kw = CASES[name]
    return dict(BASE, **cfg_kw), dict(set_kw, z_out=Z_OUT)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_finalize(case):
    from redtime_tpu import driver as jd
    from redtime_tpu.config import RunSettings as JSet
    from redtime_tpu.config import SolverConfig as JCfg
    from redtime_tpu.fastpt import engine_consts as j_engine_consts

    cfg_kw, set_kw = _case(case)
    kmin = cfg_kw.get("kmin", 1e-3)
    ys = _states(kmin)
    tc = TCfg(**cfg_kw)
    got = driver._finalize(tc, TSet(**set_kw),
                           state.model_from_numpy(_models(kmin)),
                           torch.tensor(ys), fastpt.engine_consts(tc, "cpu"))
    assert got.table.shape[-1] == driver.n_columns(tc, TSet(**set_kw))
    jc = JCfg(fft_mode="fft", **cfg_kw)
    for b in range(2):
        ref = jd._finalize(jc, JSet(**set_kw), _lane(_models(kmin), b),
                           ys[b], "fft", j_engine_consts(jc, "fft"))
        tj, tt = np.asarray(ref.table), got.table[b].numpy()
        assert tt.shape == tj.shape
        assert col_scale_dev(tt, tj, (0, 1)) < 1e-11, case
        np.testing.assert_array_equal(tt == 0.0, tj == 0.0)
        for name in ("sigma_v2", "H", "sigmaV2_z0"):
            np.testing.assert_allclose(getattr(got, name)[b].numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-12, atol=0, err_msg=name)


def test_finalize_runs_one_engine_call_over_every_redshift(monkeypatch):
    """_finalize evaluates the engine once, over the B n_z lanes, and
    only where the layout prints the mode coupling."""
    calls = []
    real = fastpt.compute_J_PZ

    def spy(cfg, lnP3, n_s, with_rsd, ec, clip=False, n_rep=1):
        calls.append((tuple(lnP3.shape), n_rep, with_rsd))
        return real(cfg, lnP3, n_s, with_rsd, ec, clip, n_rep)

    monkeypatch.setattr(fastpt, "compute_J_PZ", spy)
    ys = torch.tensor(_states(1e-3))
    for case, want in (("one_loop", [((6, 3, 16), 3, True)]),
                       ("full_trg", []), ("linear", [])):
        calls.clear()
        cfg_kw, set_kw = _case(case)
        tc = TCfg(**cfg_kw)
        driver._finalize(tc, TSet(**set_kw),
                         state.model_from_numpy(_models(1e-3)), ys,
                         fastpt.engine_consts(tc, "cpu"))
        assert calls == want, case


# --- the traced programs, replayed as torch runs each operation on the CPU

def _replay(prog, leaf, k):
    """prog's outputs [L, n_out, nk], each operation as torch runs it on
    the CPU (a division by a constant is x / c there)."""
    vals = []
    for op, a, b in prog.ops:
        vals.append(
            leaf(a) if op == "f" else k if op == "k" else
            vals[a] + vals[b] if op == "add" else
            vals[a] - vals[b] if op == "sub" else
            vals[a] * vals[b] if op == "mul" else
            vals[a] / vals[b] if op == "div" else
            vals[a] * b if op == "muls" else
            vals[a] / b if op == "divs" else
            vals[a].reciprocal() if op == "recip" else -vals[a])
    return torch.stack([vals[o] for o in prog.outs], dim=1)


def _transforms(nk: int, L: int = 3, seed: int = 5):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((L, 14, 3, 3, nk + 1))),
            torch.tensor(rng.standard_normal((L, 7, 3, 3, nk))),
            torch.tensor(np.geomspace(1e-3, 5.0, nk)))


def test_pt_pmr_program_is_assembles_bits():
    nk = 48
    Jw, PZw, k = _transforms(nk)
    L = Jw.shape[0]
    feats = torch.cat([Jw[..., :nk].reshape(L, 126, nk),
                       PZw.reshape(L, 63, nk)], dim=1)
    jlo = Jw[:, 0, 0, 0, nk]
    leaf = lambda f: (jlo[:, None] if f == assembly.PT_JLO
                      else feats[:, f])
    got = _replay(assembly.pt_pmr_program(), leaf, k)
    _, _, PT, PMR = assembly.assemble(Jw[:, :7, ..., :nk], PZw,
                                      Jw[:, 7:, ..., :nk], jlo, k, True)
    assert torch.equal(got, torch.cat([PT, PMR], dim=1))
    # the plain block's mode coupling is assemble on the window
    _, _, PT2, PMR2 = trg.mode_coupling(Jw, PZw, k, True)
    assert torch.equal(PT2, PT) and torch.equal(PMR2, PMR)


def test_pbis_program_is_pbis_j_bits():
    tc = TCfg(**BASE)
    nk = tc.nk
    y = torch.tensor(np.random.default_rng(9).standard_normal((3, 41, nk)))
    k = torch.tensor(make_grids(tc).k)
    prog, _ = ob.programs()["pbis_rows"]
    got = _replay(prog, lambda row: y[:, row], k)
    assert torch.equal(got, trg.pbis_j(tc, y))


def test_a_rows_program_is_assemble_bits():
    nk = 32
    Jw, PZw, k = _transforms(nk, seed=6)
    L = Jw.shape[0]
    feats = torch.cat([Jw[..., :nk].reshape(L, 126, nk),
                       PZw.reshape(L, 63, nk)], dim=1)
    prog, _ = ob.programs()["a_rows"]
    got = _replay(prog, lambda f: feats[:, f], k)
    A_u = trg.mode_coupling(Jw, PZw, k, True)[0]
    assert torch.equal(got, A_u)


# --- the batched engine

@pytest.mark.parametrize("with_rsd", [True, False], ids=["rsd", "no_rsd"])
def test_batched_engine_matches_one_call_a_redshift(with_rsd):
    """One compute_J_PZ over B n_z lanes (lane b n_z + s: lane b's state
    at redshift s, n_s[b]) against one call a redshift over B lanes.  The
    CPU's f64 GEMMs (MKL) block by the operands' shapes, so a lane's bits
    depend on the batch: J within 1e-11 of each row's scale (the engine's
    bound), PZ likewise."""
    tc = TCfg(**BASE)
    ec = fastpt.engine_consts(tc, "cpu")
    ys = torch.tensor(_states(1e-3))
    B, S, _, nk = ys.shape
    ns = torch.tensor([0.96, 0.99], dtype=F64)
    Jw, PZw = fastpt.compute_J_PZ(tc, ys[:, :, 0:3].reshape(B * S, 3, nk),
                                  ns, with_rsd, ec, n_rep=S)
    for s in range(S):
        J1, PZ1 = fastpt.compute_J_PZ(tc, ys[:, s, 0:3], ns, with_rsd, ec)
        for got, ref in ((Jw.reshape((B, S) + Jw.shape[1:])[:, s], J1),
                         (PZw.reshape((B, S) + PZw.shape[1:])[:, s], PZ1)):
            scale = ref.abs().amax(-1, keepdim=True) + 1e-300
            assert float(((got - ref).abs() / scale).max()) < 1e-11


def test_engine_front_n_rep_validates():
    tc = TCfg(**BASE)
    ec = fastpt.engine_consts(tc, "cpu")
    lnP = torch.zeros((6, 3, tc.nk), dtype=F64)
    with pytest.raises(ValueError, match="n_s must be"):
        fastpt.compute_J_PZ(tc, lnP, torch.ones(2, dtype=F64), True, ec,
                            n_rep=2)
    with pytest.raises(ValueError, match="n_s must be"):
        fastpt.compute_J_PZ(tc, lnP, torch.ones(6, dtype=F64), True, ec,
                            n_rep=4)


# --- the generator

def _cases() -> list:
    """Each case of the generated switch: (its comment's column count,
    its group calls (name, [arguments after c]) in order)."""
    body = ob.out_source().split(
        "void columns(int layout, Plan& c) {")[1]
    out = []
    for m in re.finditer(r"case (\d+): \{  // [^\n]*: (\d+) columns\n"
                         r"(.*?)\n\s*break;", body, re.S):
        assert int(m.group(1)) == len(out)
        calls = [re.fullmatch(r"g_(\w+)\(c, ([\d, ]+)\);", ln.strip())
                 .groups() for ln in m.group(3).splitlines()]
        out.append((int(m.group(2)), [(g, [int(x) for x in a.split(",")])
                                      for g, a in calls]))
    return out


def test_generator_emits_one_case_a_layout():
    cases = _cases()
    assert len(cases) == len(ob.LAYOUTS) == 88
    ncol = re.search(r"LAYOUT_NCOL\[N_LAYOUTS\] = \{([^}]*)\}",
                     ob.out_source()).group(1)
    assert [int(x) for x in ncol.split(",")] == [
        ob.n_columns(lay) for lay in ob.LAYOUTS]
    for lay, (n, calls) in zip(ob.LAYOUTS, cases):
        assert n == ob.n_columns(lay)
        assert calls == [(g, [col, cnt] if g == "zero" else [col])
                         for g, col, cnt in ob.groups(lay)]


@pytest.mark.parametrize("lin,a,i,rsd,bias,q,one_loop,fill", list(
    itertools.product((False, True), repeat=8)))
def test_layout_of_every_switch_setting(lin, a, i, rsd, bias, q, one_loop,
                                        fill):
    cfg = TCfg(print_a=a, print_i=i, print_bias=bias, print_q=q,
               fill_pt_full_trg=fill)
    settings = TSet(print_lin=lin, print_rsd=rsd, one_loop=one_loop)
    lay = ob.layout_of(cfg, settings)
    assert lay in ob.LAYOUTS
    assert ob.n_columns(lay) == driver.n_columns(cfg, settings)
    gs = ob.groups(lay)
    assert [col for _, col, _ in gs] == list(
        np.cumsum([0] + [n for _, _, n in gs])[:-1])
    want = (["k"] + ["lin"] * lin + ["p"] + ["a"] * a + ["i"] * i
            + (["pb_bias", "pt_bias"] if bias else ["pb_sum", "pt_sum"])
            * rsd + ["q"] * q)
    assert [g if g != "zero" else w for (g, _, _), w in zip(gs, want)] \
        == want
    assert lay.mc == ((one_loop or fill) and (a or rsd))
    assert all((g == "zero") == (w in ("a", "pt_bias", "pt_sum")
                                 and not lay.mc) for (g, _, _), w in
               zip(gs, want))


def test_headline_layouts():
    """17 columns in the headline's mode, 32 with print_bias, 84 with
    every switch on."""
    full = ob.layout_of(TCfg(), TSet(one_loop=False))
    assert ob.n_columns(full) == 17 and not full.mc
    assert ob.groups(full)[-2:] == [("pb_sum", 10, 3), ("zero", 13, 4)]
    bias = ob.layout_of(TCfg(print_bias=True), TSet(one_loop=True))
    assert ob.n_columns(bias) == 32 and bias.mc
    every = ob.layout_of(TCfg(**ALL), TSet(one_loop=True))
    assert ob.n_columns(every) == 84


def test_generated_programs_are_the_traces():
    """Each traced program is one function; every traced operation it
    needs one line, in traced order, a division by a constant DIVC_."""
    src = ob.out_source()
    for name, (prog, _) in ob.programs().items():
        body = src.split(f"void {name}(const Ctx& c, double* o) {{")[1]
        body = body.split("\n}")[0]
        ids = [int(m) for m in re.findall(r"const double v(\d+) =", body)]
        assert ids == sorted(ids) and prog.outs[-1] in ids
        n_divs = sum(prog.ops[i][0] == "divs" for i in ids)
        assert body.count("DIVC_(") == n_divs
        assert len(re.findall(r"o\[\d+\] = ", body)) == len(prog.outs)


# --- the launch plan and models of the kernel's index arithmetic

NCOLS = sorted({ob.n_columns(lay) for lay in ob.LAYOUTS})
PRESET_NK = (TCfg.high_accuracy().nk, TCfg.v01_compat().nk)


@pytest.mark.parametrize("nk", (48, 128) + PRESET_NK)
def test_launch_plan_fits_every_layout(nk):
    """Every layout's plan at nk, over lane and redshift counts from 1 to
    a production chunk: the staging tile within TILE_BYTES (and the
    card's 227 KB), a lin warp a chunk of a pass beside the scalar warps,
    clusters of at most 8 blocks, none of them empty."""
    nkt = -(-nk // ob.KT)
    for ncol in NCOLS:
        for B, S in ((1, 1), (2, 2), (8, 7), (16, 8), (32, 7), (16, 33)):
            p = ob.launch_plan(nk, B, S, ncol)
            assert p["smem_bytes"] == p["pass_chunks"] * ob.KT * (
                ncol | 1) * 8
            assert p["smem_bytes"] <= min(ob.TILE_BYTES, 227 * 1024)
            assert 1 <= p["pass_chunks"] <= p["chunks"]
            assert p["pass_chunks"] + ob.S_WARPS <= p["threads"] // 32
            assert p["threads"] in [32 * w for w in ob.WARPS]
            assert p["threads"] <= 512
            assert 1 <= p["cluster"] <= ob.MAX_CLUSTER
            assert (p["cluster"] - 1) * p["chunks"] < nkt <= (
                p["cluster"] * p["chunks"])
            assert p["blocks"] == B * S * p["cluster"]


@pytest.mark.parametrize("name,nk,B,S,ncol", [
    ("full_trg", 128, 16, 8, 17), ("oneloop_bias", 128, 32, 7, 32)])
def test_launch_plan_fills_the_card_at_the_timed_shapes(name, nk, B, S,
                                                        ncol):
    """At the timed shapes one block a (lane, redshift) pair: 128 blocks
    of 12 warps and 224 of 8, all of them resident at once (at 128
    registers a thread), no cluster.  Full TRG 16 x 8 makes 128 blocks,
    4 short of the card's 132 SMs, on purpose: splitting its pairs over
    clusters of 2 to fill every SM measured slower on the H100 (0.00838
    ms against 0.00785 ms, PERF.md), so the bound is SMS - 4 there."""
    lay = {"full_trg": ob.layout_of(TCfg(), TSet(one_loop=False)),
           "oneloop_bias": ob.layout_of(TCfg(print_bias=True),
                                        TSet(one_loop=True))}[name]
    assert ob.n_columns(lay) == ncol
    p = ob.launch_plan(nk, B, S, ncol)
    assert p["cluster"] == 1 and p["blocks"] == B * S
    assert ob.SMS - 4 <= p["blocks"] <= 2 * ob.SMS
    assert p["threads"] * 128 * -(-p["blocks"] // ob.SMS) <= 65536


def test_launch_plan_splits_few_pairs_over_clusters():
    """Pairs fewer than half the SMs, of more than 2 chunks: a cluster of
    blocks a pair (the every-switch 8 x 7 block in 4, the presets' 2 x 2
    in 8); nk = 48's 2 chunks stay one block."""
    assert ob.launch_plan(128, 8, 7, 84)["cluster"] == 4
    assert ob.launch_plan(512, 2, 2, 17)["cluster"] == 8
    assert ob.launch_plan(48, 2, 8, 17)["cluster"] == 1


@pytest.mark.parametrize("S", [1, 8, 33, 64, 65, 130])
def test_z_launches_cover_every_redshift(S):
    spans = ob.z_launches(S)
    assert all(0 < s1 - s0 <= ob.MAX_Z for s0, s1 in spans)
    assert [s for s0, s1 in spans for s in range(s0, s1)] == list(range(S))
    assert len(spans) == -(-S // ob.MAX_Z)


@pytest.mark.parametrize("nk", [16, 48, 100, 128, 160, 256, 512, 1024])
def test_plan_covers_every_k_point_once(nk):
    """The kernel's blocks (rank r of a pair's cluster: chunks r chunks ..,
    fewer on the last), passes (pass_chunks at a time) and warps (a chunk
    of KT points each; points past nk write no row) over one pair."""
    for ncol in (17, 32, 84):
        for B, S in ((1, 1), (16, 8), (32, 7)):
            p = ob.launch_plan(nk, B, S, ncol)
            nkt = -(-nk // ob.KT)
            seen = []
            for rank in range(p["cluster"]):
                c0 = rank * p["chunks"]
                nch = min(p["chunks"], nkt - c0)
                assert nch >= 1
                for p0 in range(0, nch, p["pass_chunks"]):
                    npass = min(p["pass_chunks"], nch - p0)
                    kb = (c0 + p0) * ob.KT
                    rows = min(npass * ob.KT, nk - kb)
                    seen += [kb + kl for kl in range(rows)]
            assert seen == list(range(nk))


def _plans() -> list:
    """Each layout's Plan as the generated switch sets it: group name ->
    (first column, count), the zero ranges under "zero"."""
    out = []
    for ncol, calls in _cases():
        plan = {"zero": []}
        for g, args in calls:
            if g == "zero":
                plan["zero"].append(tuple(args))
            else:
                plan[g] = args[0]
        out.append((ncol, plan))
    return out


# the column groups each of the kernel's units writes (csrc/out_block.cu
# lin_unit, run_unit): lin; A; P_T / P_MR; P_B; the copy unit's k, P, I,
# Q and zero ranges
UNIT_GROUPS = dict(lin=("lin",), a=("a",), pt=("pt_bias", "pt_sum"),
                   pb=("pb_bias", "pb_sum"), copy=("k", "p", "i", "q"))


def test_units_write_every_column_once():
    """The generated switch's groups, with the generator's widths
    (out_block.groups), go to the kernel's units, each named group to a
    setter g_<name> of csrc/out_block.cu, and cover every column of the
    layout once; the dynamic units' kinds are A, P_T, P_B where computed,
    then copy."""
    cu = (ob.build.CSRC / "out_block.cu").read_text()
    setters = set(re.findall(r"void g_(\w+)\(Plan& c", cu))
    owned = {g for names in UNIT_GROUPS.values() for g in names}
    for lay, (ncol, plan) in zip(ob.LAYOUTS, _plans()):
        width = {g: n for g, _, n in ob.groups(lay) if g != "zero"}
        assert set(width) <= owned and set(width) | {"zero"} <= setters
        written = []
        for g, n in width.items():
            written += range(plan[g], plan[g] + n)
        for col, n in plan["zero"]:
            written += range(col, col + n)
        assert sorted(written) == list(range(ncol)), lay
        assert len(plan["zero"]) <= 2
        kinds = 1 + ("a" in plan) + any(g in plan for g in UNIT_GROUPS["pt"]) \
            + any(g in plan for g in UNIT_GROUPS["pb"])
        assert kinds == 1 + (lay.a and lay.mc) + (
            lay.rsd != "off" and lay.mc) + (lay.rsd != "off")


def test_store_tile_row_index_is_exact():
    """store_tile's row of element e, (e + 1/2) (1/ncol) in f32 and cut,
    is e // ncol for every e of a tile of up to 200 KB and every
    layout's ncol."""
    e = np.arange(200 * 1024 // 8, dtype=np.int64)
    for ncol in NCOLS:
        inv = np.float32(1.0) / np.float32(ncol)
        row = ((e.astype(np.float32) + np.float32(0.5)) * inv).astype(
            np.int64)
        np.testing.assert_array_equal(row, e // ncol)


# --- the wrapper

def test_wrapper_validates_and_cpu_takes_plain():
    tc = TCfg(**BASE)
    s = TSet(one_loop=True, z_out=Z_OUT)
    lay = ob.layout_of(tc, s)
    m = state.model_from_numpy(_models(1e-3))
    ys = torch.tensor(_states(1e-3))
    k = torch.tensor(make_grids(tc).k)
    before = counts.snapshot()
    with pytest.raises(ValueError, match="engine's outputs"):
        ob.out_block(lay, ys, k, m, Z_OUT, s.a_in, None)
    with pytest.raises(ValueError, match="redshifts"):
        ob.out_block(lay._replace(mc=False), ys, k, m, Z_OUT[:2], s.a_in)
    with pytest.raises(ValueError, match="ys must be"):
        ob.out_block(lay._replace(mc=False), ys[:, 0], k, m, Z_OUT, s.a_in)
    with pytest.raises(ValueError, match="unknown layout"):
        ob.out_block(lay._replace(mc=True, a=False, rsd="off"), ys, k, m,
                     Z_OUT, s.a_in)
    table, sv2, H = ob.out_block(lay._replace(mc=False), ys, k, m, Z_OUT,
                                 s.a_in)
    assert table.shape == (2, 3, tc.nk, 17) and sv2.shape == H.shape == (
        2, 3)
    assert counts.snapshot() == before       # the CPU counts no launch


def test_wrapper_raises_off_the_cpu_without_a_kernel():
    tc = TCfg(**BASE)
    lay = ob.layout_of(tc, TSet(one_loop=False, z_out=Z_OUT))
    m = state.model_from_numpy(_models(1e-3), "meta")
    ys = torch.empty((2, 3, 41, tc.nk), dtype=F64, device="meta")
    k = torch.empty((tc.nk,), dtype=F64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ob.out_block(lay, ys, k, m, Z_OUT, 0.01)


CARD_CASES = ((dict(ALL), dict(one_loop=True, z_out="Z_OUT_1L")),
              ({}, dict(one_loop=False, z_out="Z_OUT")))


def _card_args(cfg_kw: dict, set_kw: dict, dev) -> tuple:
    """out_block's arguments on the card: 4 design lanes prepared on the
    host, states like evolved ones (lane 3 NaN at the last redshift), the
    engine over the B n_z lanes where the layout needs it."""
    import chip_smoke

    cfg = TCfg(**cfg_kw)
    settings = TSet(**dict(set_kw, z_out=getattr(chip_smoke,
                                                  set_kw["z_out"])))
    cs, lins = chip_smoke.design_inputs(4)
    m = driver._prepare(cfg, ([x.numpy() for x in cs], list(lins), None),
                        dev, True)
    ec = fastpt.engine_consts(cfg, dev)
    S = len(settings.z_out)
    rng = np.random.default_rng(4)
    y = trg.initial_state(cfg, settings, m).reshape(4, 1, 41, cfg.nk)
    ys = y.repeat(1, S, 1, 1)
    ys[:, :, :3] += 6.0
    ys[:, :, 3:] = 1e-3 * torch.exp(ys[:, :, :1]) * torch.as_tensor(
        rng.standard_normal((4, S, 38, cfg.nk)), device=dev)
    ys[-1, -1] = float("nan")
    lay = ob.layout_of(cfg, settings)
    k = driver._headers(cfg, settings, dev)[0]
    src = (fastpt.compute_J_PZ(
        cfg, ys[:, :, 0:3].reshape(4 * S, 3, cfg.nk), m.cosmo.n_s,
        settings.print_rsd, ec, n_rep=S) if lay.mc else None)
    return (lay, ys, k, m, settings.z_out, settings.a_in, src, None)


@pytest.mark.cuda
def test_cuda_out_block_matches_plain(cuda_device):
    """On the card: K11 against out_block_plain on the same engine
    outputs, 1-loop with every switch on and full TRG, within 1e-11 of
    each column's (sigma_v^2's, H's) scale over a lane, NaN in the same
    places; one launch each."""
    for cfg_kw, set_kw in CARD_CASES:
        args = _card_args(cfg_kw, set_kw, cuda_device)
        before = counts.snapshot()["out_block"]
        got = ob.out_block(*args)
        assert counts.snapshot()["out_block"] == before + 1
        for g, r in zip(got, ob.out_block_plain(*args)):
            assert torch.equal(g.isnan(), r.isnan())
            fin = torch.isfinite(r)
            dims = (1, 2) if r.dim() == 4 else (1,)
            scale = torch.where(fin, r.abs(), 0.0).amax(dims, keepdim=True)
            d = torch.where(fin, (g - r).abs(), 0.0) / (scale + 1e-300)
            assert float(d.max()) <= 1e-11


@pytest.mark.cuda
def test_cuda_out_block_plans_agree(cuda_device):
    """On the card: K11 under other launch plans than launch_plan's --
    clusters of 1, 2 and 4 blocks a (lane, redshift), every chunk in one
    pass or a chunk a pass, 8 or 16 warps a block -- writes the default
    plan's bits."""
    from redtime_tpu_torch.kernels import build

    lib = build.lib()
    for cfg_kw, set_kw in CARD_CASES:
        args = _card_args(cfg_kw, set_kw, cuda_device)
        S = args[1].shape[1]
        ref = ob.out_block(*args)
        for cluster, chunks in ((1, 4), (2, 2), (4, 1)):
            for pass_chunks in range(1, chunks + 1):
                for threads in (256, 512):
                    plan = dict(cluster=cluster, chunks=chunks,
                                pass_chunks=pass_chunks, threads=threads)
                    got = [torch.full_like(x, -1.0) for x in ref]
                    ob.launch(lib, *args, *got, 0, S, plan=plan)
                    for g, r in zip(got, ref):
                        assert torch.equal(g.view(torch.int64),
                                           r.view(torch.int64)), plan
