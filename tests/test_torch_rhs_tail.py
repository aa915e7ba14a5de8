"""K8 rhs_tail (redtime_tpu_torch/kernels/rhs_tail.py) on the CPU.

  * rhs_tail_plain, fed what make_rhs's prologue builds, against the JAX
    package's make_rhs on the same state: full Time-RG with and without
    RSD, 1-loop and linear, within 1e-11 of each (lane, row)'s scale;
  * a CPU model of the kernel's arithmetic: the A/R program traced from
    assembly.ar_rows (the kernel's generated code) gives the port's
    assemble_ar bit for bit and the JAX package's assemble within 1e-13
    of row scale; with kernel_table's Omega and trace terms, all of dy
    within 1e-13 of rhs_tail_plain's row scale;
  * make_rhs on the CPU gives the bits of the eager RHS it replaced (an
    inline copy of that sequence below);
  * a NaN lane stays NaN and leaves its neighbour's bits alone;
  * the wrapper's errors.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_util import jax_batch, k8_prologue
from redtime_tpu import assembly as ja
from redtime_tpu import fastpt as jf
from redtime_tpu import model as jm
from redtime_tpu import trg as jt
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import assembly, fastpt, state
from redtime_tpu_torch import background as bg
from redtime_tpu_torch import model as mdl
from redtime_tpu_torch import trg
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.grids import make_grids
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch.kernels import rhs_tail as rt

NK = 32
Z_OUT = (2.0, 1.0, 0.5, 0.0)
CASES = {
    "full_trg": dict(one_loop=False, z_out=Z_OUT),
    "full_trg_no_rsd": dict(one_loop=False, print_rsd=False, z_out=Z_OUT),
    "one_loop": dict(one_loop=True, z_out=Z_OUT),
    "linear": dict(one_loop=False, nonlinear=False, z_out=Z_OUT),
}
F64 = torch.float64


@functools.lru_cache(maxsize=1)
def _models():
    jc = JCfg(nk=NK)
    cosmos, lins = jax_batch(2, jc)
    return jax.jit(jax.vmap(lambda c, l: jm.prepare_model(jc, c, l)))(
        cosmos, lins)


def _lane(tree, b):
    return jax.tree_util.tree_map(lambda x: x[b], tree)


def _state(eta=1.3, seed=11):
    """An evolved-looking state [2, 41*NK]: the initial lnP rows grown by
    e^eta, nonzero I/Q rows."""
    jc = JCfg(nk=NK)
    rng = np.random.default_rng(seed)
    ys = []
    for b in range(2):
        y0 = np.asarray(jt.initial_state(jc, JSet(**CASES["full_trg"]),
                                         _lane(_models(), b)))
        y0 = y0.reshape(41, NK).copy()
        y0[:3] += 2.0 * eta
        y0[3:] = 1e-3 * np.exp(y0[:1]) * rng.standard_normal((38, NK))
        ys.append(y0.reshape(-1))
    return np.stack(ys), eta


@functools.lru_cache(maxsize=1)
def _port_setup():
    """(cfg, model, engine constants, 1-loop cache) of the port."""
    tc = TCfg(nk=NK)
    mt = state.model_from_numpy(_models())
    ec = fastpt.engine_consts(tc, "cpu")
    cache = trg.build_oneloop_cache(tc, TSet(**CASES["one_loop"]), mt, ec)
    return tc, mt, ec, cache


def _prologue(case: str, y: torch.Tensor, eta: torch.Tensor):
    """What make_rhs hands rhs_tail (trg.rhs_prologue)."""
    tc, mt, ec, cache = _port_setup()
    s = TSet(**CASES[case])
    return trg.rhs_prologue(tc, s, mt, ec, cache if s.one_loop else None)(
        eta, y)


def _row_dev(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| over each (lane, row)'s max |ref| over k."""
    scale = np.abs(ref).max(axis=-1, keepdims=True) + 1e-300
    return float(np.max(np.abs(got - ref) / scale))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_make_rhs(case):
    ys, eta = _state()
    etas = torch.full((2,), eta, dtype=F64)
    got = rt.rhs_tail_plain(*_prologue(case, torch.tensor(ys), etas))
    assert got.shape == (2, 41, NK)
    jc = JCfg(nk=NK)
    ec = jf.engine_consts(jc, "fft")
    cache = _port_setup()[3]
    for b in range(2):
        cj = (jt.OneLoopCache(*[jnp.asarray(x[b].numpy()) for x in cache])
              if case == "one_loop" else None)
        rhs_j = jt.make_rhs(jc, JSet(**CASES[case]), _lane(_models(), b), cj,
                            mode="fft", ec=ec)
        ref = np.asarray(rhs_j(eta, jnp.asarray(ys[b]))).reshape(41, NK)
        assert _row_dev(got[b].numpy(), ref) < 1e-11, case


# --- a CPU model of the kernel's arithmetic (csrc/rhs_tail.cu)

def _features(Jw, PZw, nk):
    """The kernel's staged feature rows [B, 9 nfam + 63, nk] and the row
    of an assembly feature."""
    B, nfam = Jw.shape[:2]
    F = torch.cat([Jw[..., :nk].reshape(B, 9 * nfam, nk),
                   PZw.reshape(B, 63, nk)], dim=1)
    return F, lambda f: f if f < 126 else f - 126 + 9 * nfam


def _run_program(F, row, k, outs):
    """assembly.ar_program's values `outs`, each operation as torch runs
    it on the CPU (a division by a constant is x / c there)."""
    ops = assembly.ar_program().ops
    vals = []
    for op, a, b in ops:
        vals.append(
            F[:, row(a)] if op == "f" else k if op == "k" else
            vals[a] + vals[b] if op == "add" else
            vals[a] - vals[b] if op == "sub" else
            vals[a] * vals[b] if op == "mul" else
            vals[a] / vals[b] if op == "div" else
            vals[a] * b if op == "muls" else
            vals[a] / b if op == "divs" else
            vals[a].reciprocal() if op == "recip" else -vals[a])
    prog = assembly.ar_program()
    return torch.stack([vals[prog.outs[o]] for o in outs], dim=1)


def _source_cases(var: str) -> list:
    """The statements of each work item of Sched<V_var> in the generated
    header (rhs_tail.ar_source), in case order."""
    body = rt.ar_source().split(f"struct Sched<V_{var.upper()}> {{")[1]
    out, cur = [], None
    for ln in body.split("\n};")[0].splitlines():
        ln = ln.strip()
        m = re.match(r"case (\d+): \{", ln)
        if m:
            assert int(m.group(1)) == len(out)
            out.append([])
            cur = out[-1]
        elif cur is not None and ln not in ("break;", "}", ""):
            cur.append(ln)
    return out


def _python(stmts: list) -> str:
    """Generated C statements as Python (the same calls and operators)."""
    return "\n".join(ln.replace("const double ", "").replace("double ", "")
                     .rstrip(";") for ln in stmts)


def _kernel_model(y, eta, k, om, src, evolve_q):
    """dy [B, 41, nk] computed as the kernel computes it, in torch on the
    CPU: each work item of the variant's generated code, every C
    statement run as Python on all lanes and k points at once (its
    scalars, from the lookups as the warps compute them (k8_prologue),
    its row loads LD_*, its A/R values or cache rows times pre fz^n, the
    Omega terms and OUT_, the trace and dlnp, the zero rows).  A division
    by a constant (DIVC_) is x / c here, as torch's CPU kernels divide."""
    B, _, nk = y.shape
    var = rt.variant(rt.mode_of(src), evolve_q)
    dy = torch.full_like(y, float("nan"))
    rows = {"y": y}
    pre = fz = None
    beta, den, o11, growth = k8_prologue(eta, om, src)
    beta, den, o11 = (torch.tensor(x) for x in (beta, den, o11))
    o10 = (-1.5 * om.Omega_m[:, None] * (om.consts.f_cb[:, None] + beta)
           / den[:, None])
    if isinstance(src, rt.FullSrc):
        rows.update(jw=src.Jw[..., :nk].reshape(B, -1, nk),
                    pz=src.PZw.reshape(B, 63, nk))
    elif src is not None:
        rows.update(au=src.A_u, r=src.R.reshape(B, 24, nk))
        D, dDda, z = (torch.tensor(x) for x in growth)
        fz = dDda / (D * (1.0 + z)[:, None])
        dr = D / src.D_z1l
        dr2 = dr * dr
        pre = dr2 * dr2 * torch.exp(-4.0 * eta)[:, None]

    def out(r, v):
        assert torch.isnan(dy[:, r]).all(), f"row {r} written twice"
        dy[:, r] = v

    def dlnp(y0, y1, y2, i0, i1, i2, i3, e, kv, o10, o11):
        P = [torch.exp(torch.clamp(v, rt.LNP_MIN, rt.LNP_MAX))
             for v in (y0, y1, y2)]
        dP0 = -2.0 * (1.0 * P[0] + -1.0 * P[1])
        dP1 = -(1.0 * P[1] + -1.0 * P[2]) - (o10 * P[0] + o11 * P[1])
        dP2 = -2.0 * (o10 * P[1] + o11 * P[2])
        if i0 is not None:
            coef = e * 4.0 * np.pi / kv
            dP0 = dP0 + coef * (i0 + i0)
            dP1 = dP1 + coef * (i2 + i1)
            dP2 = dP2 + coef * (i3 + i3)
        out(0, torch.clamp(dP0 / P[0], -1e4, 1e4))
        out(1, torch.clamp(dP1 / P[1], -1e4, 1e4))
        out(2, torch.clamp(torch.clamp(dP2 / P[2], -1e4, 1e4), -10.0, 10.0))

    calls = dict(
        K_AT=lambda: k, LANE_E=lambda: torch.exp(eta)[:, None],
        LANE_O11=lambda: o11[:, None], O10_AT=lambda: o10,
        FZ_AT=lambda: fz, PRE_AT=lambda: pre,
        OUT_=out, ZERO_=lambda r: out(r, torch.zeros_like(y[:, r])),
        DIVC_=lambda x, c: x / c,
        __dadd_rn=lambda a, b: a + b, __dsub_rn=lambda a, b: a - b,
        __dmul_rn=lambda a, b: a * b, __ddiv_rn=lambda a, b: a / b,
        __drcp_rn=lambda a: a.reciprocal())
    calls.update({f"LD_{n.upper()}": (lambda n: lambda r: rows[n][:, r])(n)
                  for n in rt.SOURCES})
    for stmts in _source_cases(var):
        ns = dict(calls)
        ns["DLNP_"] = lambda y0, y1, y2, i0, i1, i2, i3: dlnp(
            y0, y1, y2, i0, i1, i2, i3, ns["E_"], ns["K_"], ns["O10_"],
            ns["O11_"])
        ns["DLNP_LINEAR_"] = lambda y0, y1, y2: dlnp(
            y0, y1, y2, None, None, None, None, None, None, ns["O10_"],
            ns["O11_"])
        exec(_python(stmts), ns)
    return dy


@pytest.mark.parametrize("with_rsd", [True, False], ids=["rsd", "no_rsd"])
def test_program_matches_assemble(with_rsd):
    """The traced A/R program, run as torch runs each operation, gives
    assemble_ar's bits, and the JAX package's assemble within 1e-13 of
    row scale, on random transforms at nk = 48 (nfam 14, or 7 without
    RSD, as K1 writes them)."""
    nk, B = 48, 3
    rng = np.random.default_rng(5)
    k = np.geomspace(1e-3, 5.0, nk)
    nfam = 14 if with_rsd else 7
    Jw = rng.standard_normal((B, nfam, 3, 3, nk + 1))
    PZw = rng.standard_normal((B, 7, 3, 3, nk))
    kt = torch.tensor(k)
    nout = 14 + (24 if with_rsd else 0)
    got = _run_program(*_features(torch.tensor(Jw), torch.tensor(PZw), nk),
                       kt, range(nout))
    Jn0 = (Jw[:, 7:, ..., :nk] if with_rsd
           else np.zeros((B, 7, 3, 3, nk)))
    A, R = assembly.assemble_ar(torch.tensor(Jw[:, :7, ..., :nk]),
                                torch.tensor(PZw), torch.tensor(Jn0), kt,
                                with_rsd)
    ref = torch.cat([A, R.reshape(B, 24, nk)], dim=1)[:, :nout]
    assert torch.equal(got, ref)
    for b in range(B):
        Aj, Rj, _, _ = ja.assemble(jnp.asarray(Jw[b, :7, ..., :nk]),
                                   jnp.asarray(PZw[b]), jnp.asarray(Jn0[b]),
                                   jnp.asarray(Jw[b, 0, 0, 0, nk]),
                                   jnp.asarray(k), with_rsd)
        refj = np.concatenate([np.asarray(Aj),
                               np.asarray(Rj).reshape(24, nk)])[:nout]
        assert _row_dev(got[b].numpy(), refj) < 1e-13
    if not with_rsd:
        assert torch.all(R == 0)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_matches_plain(case):
    """All of dy through the kernel's program (the generated A/R code,
    the Omega terms, the trace, the fz powers) against rhs_tail_plain."""
    ys, eta = _state(seed=12)
    args = _prologue(case, torch.tensor(ys),
                     torch.tensor([0.4, 2.9], dtype=F64))
    got, ref = _kernel_model(*args), rt.rhs_tail_plain(*args)
    assert _row_dev(got.numpy(), ref.numpy()) < 1e-13


def test_generated_source():
    """ar_source: the largest block launch_plan gives, one case a work
    item of each variant; in full TRG, one line a distinct operation of an
    item (the A/R values of its outputs once each, in traced order), each
    division by a constant as DIVC_ (a product with 1/c, as the kernel
    defines it)."""
    src = rt.ar_source()
    ops, vals = rt._ar()
    assert (f"constexpr int MAX_BLOCK_THREADS = {32 * max(rt.BLOCK_WARPS)};"
            in src)
    for var in rt.VARIANTS:
        assert len(_source_cases(var)) == len(rt.items(var))
        assert f"ITEMS = {len(rt.items(var))};" in src
    n_full = 0
    for var in ("full", "full_q"):
        for it, stmts in zip(rt.items(var), _source_cases(var)):
            defs = [int(ln.split()[2][1:]) for ln in stmts
                    if ln.startswith("const double v")]
            assert defs == sorted(set().union(*(vals[o] for o in it.outs)))
            n_full += len(defs)
    assert src.count("const double v") == n_full
    assert any(op[0] == "divs" and op[2] == 6.0 for op in ops)
    assert "__ddiv_rn(" in src and "__drcp_rn(" in src
    assert "DIVC_(v" in src and ", 6.0)" in src
    assert f", {1.0 / 6.0!r})" not in src
    cu = (Path(rt.__file__).parents[1] / "csrc" / "rhs_tail.cu").read_text()
    assert "#define DIVC_(x, d) __dmul_rn((x), 1.0 / (d))" in cu


@pytest.mark.parametrize("var", rt.VARIANTS)
def test_items_cover_every_row_once(var):
    """Each output of the variant in one item, dlnP in one, the other
    rows of dy in the zero item; each item within its cost."""
    its = rt.items(var)
    nout = 0 if var == "linear" else 14 + (24 if var.endswith("_q") else 0)
    assert sorted(o for it in its for o in it.outs) == list(range(nout))
    assert sum(it.dlnp for it in its) == 1
    assert sorted(r for it in its for r in it.zeros) == \
        list(range(3 + nout, 41))
    for it in its:
        if len(it.outs) > 1:
            assert rt.item_cost(var, it) <= rt.ITEM_COST[var]
        assert not (it.dlnp and it.outs)


@pytest.mark.parametrize("var", rt.VARIANTS)
def test_loaded_rows_cover_what_the_code_reads(var):
    """On the generated source: each item loads each row it reads once
    (LD_*), exactly rhs_tail.item_rows, and every value it names is
    defined before it is read."""
    for it, stmts in zip(rt.items(var), _source_cases(var)):
        loads = re.findall(r"const double (\w+) = LD_(\w+)\((\d+)\);",
                           "\n".join(stmts))
        assert len({(src, int(r)) for _, src, r in loads}) == len(loads)
        assert {(src.lower(), int(r)) for _, src, r in loads} == \
            rt.item_rows(var, it)
        defined = set()
        for ln in stmts:
            m = re.match(r"(?:const )?double (\w+) = (.*);", ln)
            rhs = m.group(2) if m else ln
            for name in re.findall(r"\b([a-z]+\d+|[A-Z][A-Z0-9]*_)\b"
                                   r"(?!\()", rhs):
                assert name in defined, (var, it, ln, name)
            if m:
                defined.add(m.group(1))


@pytest.mark.parametrize("mode", ["full", "full_no_rsd", "oneloop",
                                  "linear"])
@pytest.mark.parametrize("nk,B", chip_smoke.RT_SHAPES)
def test_launch_limits(nk, B, mode):
    """At every (nk, lanes) the main paths give K8 and in every mode: no
    shared memory, a block within the kernel's MAX_BLOCK_THREADS (what
    rt_rhs_tail accepts; at most CUDA's 1,024) and the grid within its
    extent, also at MAX_LANES; every task in a block; full TRG with Q at
    16 lanes gives at least two blocks an SM."""
    var = rt.variant(mode.split("_")[0], mode != "full_no_rsd")
    plan = rt.launch_plan(var, nk, B)
    assert plan["smem_bytes"] == 0
    assert plan["threads"] <= 32 * max(rt.BLOCK_WARPS) <= 1024
    assert plan["threads"] % 32 == 0
    assert plan["tasks"] == len(rt.items(var)) * B * -(-nk // rt.KT)
    assert 0 <= plan["blocks"] * plan["threads"] // 32 - plan["tasks"] \
        < plan["threads"] // 32
    assert rt.launch_plan(var, nk, rt.MAX_LANES)["blocks"] < 2 ** 31
    if (var, nk, B) == ("full_q", 128, 16):
        assert plan["blocks"] >= 2 * 132


def test_items_are_deterministic():
    """The generated header (hashed into the library's name) comes out
    the same when the items are made anew."""
    first = rt.ar_source()
    rt.items.cache_clear()
    rt.item_rows.cache_clear()
    rt.item_cost.cache_clear()
    assert rt.ar_source() == first


def _old_eager_rhs(cfg, settings, model, ec, cache, eta, yflat):
    """The eager RHS that K8 replaced, as make_rhs ran it before."""
    g = make_grids(cfg)
    nk = g.nk
    k = torch.as_tensor(g.k, dtype=F64)
    one_loop = settings.nonlinear and settings.one_loop
    evolve_q = settings.print_rsd or cfg.print_q
    nonlinear = settings.nonlinear
    CI, CQ = (torch.as_tensor(m, dtype=F64) for m in assembly.OMEGA_BILINEAR)
    TR14 = torch.as_tensor(assembly.OMEGA_MATS[2], dtype=F64)
    B = yflat.shape[0]
    y = yflat.reshape(B, 41, nk)
    a = settings.a_in * torch.exp(eta)
    c = model.cosmo
    d = bg.derived(c)
    beta = mdl.beta_P_solver(model, a)
    ones = torch.ones((B, nk), dtype=F64)
    o10 = (-1.5 * c.Omega_m[:, None] * (model.f_cb[:, None] + beta)
           / (a ** 3 * bg.H2_H02(c, a, d))[:, None])
    o11 = (3.0 + bg.dlnH_dlna(c, a, d))[:, None] * ones
    O = torch.stack([torch.stack([ones, -ones], dim=1),
                     torch.stack([o10, o11], dim=1)], dim=1)
    e_eta = torch.exp(eta)[:, None]
    lnP = torch.clamp(y[:, 0:3], -80.0, 20.0)
    P = torch.exp(lnP)
    if nonlinear:
        I14 = y[:, 3:17]
        if one_loop:
            A64, R, _, _ = trg.oneloop_rescale(cfg, settings, model, cache,
                                               eta)
            A_u = A64[:, assembly.JU]
        else:
            A_u, R, _, _ = trg.compute_mode_coupling_full(
                cfg, lnP, model.cosmo.n_s, evolve_q, k, ec)
        Of = O.reshape(B, 4, nk)
    dP0 = -2.0 * (O[:, 0, 0] * P[:, 0] + O[:, 0, 1] * P[:, 1])
    dP1 = -(O[:, 0, 0] * P[:, 1] + O[:, 0, 1] * P[:, 2]) - \
        (O[:, 1, 0] * P[:, 0] + O[:, 1, 1] * P[:, 1])
    dP2 = -2.0 * (O[:, 1, 0] * P[:, 1] + O[:, 1, 1] * P[:, 2])
    if nonlinear:
        Isum = (TR14 @ I14).reshape(B, 2, 2, nk)
        coef = e_eta * 4.0 * np.pi / k
        dP0 = dP0 + coef * (Isum[:, 0, 0] + Isum[:, 0, 0])
        dP1 = dP1 + coef * (Isum[:, 1, 0] + Isum[:, 0, 1])
        dP2 = dP2 + coef * (Isum[:, 1, 1] + Isum[:, 1, 1])
    dlnP = torch.stack([dP0 / P[:, 0], dP1 / P[:, 1], dP2 / P[:, 2]], dim=1)
    dlnP = torch.clamp(dlnP, -1e4, 1e4)
    dlnP = torch.cat([dlnP[:, :2], torch.clamp(dlnP[:, 2:], -10.0, 10.0)],
                     dim=1)
    if not nonlinear:
        return torch.cat([dlnP, dlnP.new_zeros((B, 38, nk))],
                         dim=1).reshape(B, -1)
    OI = (Of[:, :, None, :] * I14[:, None, :, :]).reshape(B, 56, nk)
    dI = 2.0 * e_eta[:, :, None] * A_u - CI @ OI
    if evolve_q:
        Q24 = y[:, 17:]
        OQ = (Of[:, :, None, :] * Q24[:, None, :, :]).reshape(B, 96, nk)
        dQ = 2.0 * e_eta[:, :, None] * R.reshape(B, 24, nk) - CQ @ OQ
    else:
        dQ = dlnP.new_zeros((B, 24, nk))
    return torch.cat([dlnP, dI, dQ], dim=1).reshape(B, -1)


@pytest.mark.parametrize("case", list(CASES))
def test_make_rhs_keeps_the_eager_bits(case):
    tc, mt, ec, cache = _port_setup()
    s = TSet(**CASES[case])
    ys, _ = _state(seed=13)
    y = torch.tensor(ys)
    eta = torch.tensor([0.8, 3.1], dtype=F64)
    counts.reset()
    got = trg.make_rhs(tc, s, mt, ec, cache if s.one_loop else None)(eta, y)
    assert counts.LAUNCHES["rhs_tail"] == 0     # the CPU counts no launch
    ref = _old_eager_rhs(tc, s, mt, ec, cache, eta, y)
    assert torch.equal(got, ref), case


def test_nan_lane_stays_nan():
    tc, mt, ec, _ = _port_setup()
    s = TSet(**CASES["full_trg"])
    ys, _ = _state(seed=14)
    y = torch.tensor(ys)
    eta = torch.tensor([1.1, 1.1], dtype=F64)
    rhs = trg.make_rhs(tc, s, mt, ec)
    clean = rhs(eta, y)
    y[1] = float("nan")
    got = rhs(eta, y).reshape(2, 41, NK)
    assert torch.isnan(got[1]).all()
    assert torch.equal(got[0], clean.reshape(2, 41, NK)[0])


def _meta_tables(B, nk, nz=8, nn=6):
    """K8's table tuples on the meta device: (OmegaIn, OneLoopSrc)."""
    f = lambda *shape: torch.zeros(shape, dtype=F64, device="meta")
    om = rt.OmegaIn(f(B, nz), f(B, nz, nk), f(B), f(B),
                    bg.OmegaConsts(*[f(B)] * 13), 0.005)
    return om, rt.OneLoopSrc(f(B, 14, nk), f(B, 3, 8, nk), f(B, nn),
                             f(B, nn, nk), f(B, nn, nk), f(B, nk), f(B, nk),
                             200.0)


def _meta_args(**change):
    B, nk = 2, 8
    f = lambda *shape: torch.zeros(shape, dtype=F64, device="meta")
    args = dict(y=f(B, 41, nk), eta=f(B), k=f(nk),
                om=_meta_tables(B, nk)[0],
                src=rt.FullSrc(f(B, 14, 3, 3, nk + 1), f(B, 7, 3, 3, nk)),
                evolve_q=True)
    args.update(change)
    return args


def test_wrapper_errors():
    with pytest.raises(RuntimeError, match="no kernel for device"):
        rt.rhs_tail(**_meta_args())
    f = lambda *shape: torch.zeros(shape, dtype=F64, device="meta")
    with pytest.raises(TypeError, match="float64"):
        rt.rhs_tail(**_meta_args(eta=torch.zeros(2, dtype=torch.float32,
                                                 device="meta")))
    with pytest.raises(ValueError, match="y must be"):
        rt.rhs_tail(**_meta_args(y=f(2, 40, 8)))
    with pytest.raises(ValueError, match="Jw must be"):
        rt.rhs_tail(**_meta_args(src=rt.FullSrc(f(2, 9, 3, 3, 9),
                                                f(2, 7, 3, 3, 8))))
    with pytest.raises(ValueError, match="14 families"):
        rt.rhs_tail(**_meta_args(src=rt.FullSrc(f(2, 7, 3, 3, 9),
                                                f(2, 7, 3, 3, 8))))
    om, ol = _meta_tables(2, 8)
    with pytest.raises(ValueError, match="beta_solver must be"):
        rt.rhs_tail(**_meta_args(om=om._replace(beta_solver=f(2, 8, 9))))
    with pytest.raises(ValueError, match="4 nodes"):
        rt.rhs_tail(**_meta_args(om=om._replace(beta_a=f(2, 3),
                                                beta_solver=f(2, 3, 8))))
    with pytest.raises(ValueError, match="e_pow must be"):
        rt.rhs_tail(**_meta_args(om=om._replace(
            consts=om.consts._replace(e_pow=f(3)))))
    with pytest.raises(TypeError, match="OmegaConsts"):
        rt.rhs_tail(**_meta_args(om=om._replace(consts=tuple(om.consts))))
    with pytest.raises(TypeError, match="a_in must be a Python float"):
        rt.rhs_tail(**_meta_args(om=om._replace(a_in=f())))
    with pytest.raises(ValueError, match="growth table needs at least 4"):
        rt.rhs_tail(**_meta_args(src=ol._replace(
            g_lna=f(2, 3), g_G=f(2, 3, 8), g_dDda=f(2, 3, 8))))
    with pytest.raises(ValueError, match="g_dDda must be"):
        rt.rhs_tail(**_meta_args(src=ol._replace(g_dDda=f(2, 5, 8))))
    with pytest.raises(TypeError, match="z_in must be a Python float"):
        rt.rhs_tail(**_meta_args(src=ol._replace(z_in=None)))
    with pytest.raises(TypeError, match="FullSrc"):
        rt.rhs_tail(**_meta_args(src=(f(2, 14, 3, 3, 9),)))
    with pytest.raises(ValueError, match="different devices"):
        rt.rhs_tail(**_meta_args(eta=torch.zeros(2, dtype=F64)))
    # no beta_P table (nz 0) and a 1-loop source pass every check
    om0 = om._replace(beta_a=f(2, 0), beta_solver=f(2, 0, 8))
    for src, q in ((ol, True), (ol, False), (None, False)):
        with pytest.raises(RuntimeError, match="no kernel for device"):
            rt.rhs_tail(**_meta_args(om=om0, src=src, evolve_q=q))


def test_omega_scalars_keep_the_bits():
    """bg.omega_scalars equals a^3 H2_H02 and 3 + dlnH_dlna bit for bit,
    on both sides of each lane's a_nu, and omega_matrix is built from it."""
    mt = _port_setup()[1]
    c = mt.cosmo
    d = bg.derived(c)
    for a in (0.004, 0.05, 0.3, 1.0):
        a = torch.full((2,), a, dtype=F64) * torch.tensor([1.0, 1.7],
                                                          dtype=F64)
        den, o11 = bg.omega_scalars(a, bg.omega_consts(c, d))
        assert torch.equal(den, a ** 3 * bg.H2_H02(c, a, d))
        assert torch.equal(o11, 3.0 + bg.dlnH_dlna(c, a, d))
    a = torch.tensor([1e-9, 2e-8], dtype=F64)          # before a_nu
    assert bool((a < d.a_nu).all() | (d.f_nu == 0).all())
    den, o11 = bg.omega_scalars(a, bg.omega_consts(c))
    assert torch.equal(den, a ** 3 * bg.H2_H02(c, a, d))
    assert torch.equal(o11, 3.0 + bg.dlnH_dlna(c, a, d))
