"""The PyTorch port's configuration, grids, interpolation and background
against the JAX package.

Shared config fields must have equal defaults; the numpy grid geometry is
built by the same code, so it must be bit-identical; the tensor
interpolation and background functions follow the JAX operation order and
must agree to a few ulp.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads, JAX on CPU)
from redtime_tpu import background as jbg
from redtime_tpu import config as jcfg
from redtime_tpu import grids as jgrids
from redtime_tpu import interp as jinterp
from redtime_tpu_torch import background as tbg
from redtime_tpu_torch import config as tcfg
from redtime_tpu_torch import grids as tgrids
from redtime_tpu_torch import interp as tinterp
from redtime_tpu_torch import state

PRESETS = ("default", "high_accuracy", "v01_compat")


def _preset(mod, name):
    cls = mod.SolverConfig
    return cls() if name == "default" else getattr(cls, name)()


def test_shared_defaults_equal():
    j = {f.name: f.default for f in
         jcfg.SolverConfig.__dataclass_fields__.values()}
    t = {f.name: f.default for f in
         tcfg.SolverConfig.__dataclass_fields__.values()}
    shared = set(j) & set(t)
    assert len(shared) >= 45
    assert {n: j[n] for n in shared} == {n: t[n] for n in shared}
    assert set(t) <= set(j)
    for name in ("C_RHO_GAM", "C_NU_HOT", "H0H"):
        assert getattr(jcfg, name) == getattr(tcfg, name)
    assert jcfg.CosmoParams._fields == tcfg.CosmoParams._fields
    assert (jcfg.RunSettings.__dataclass_fields__.keys()
            == tcfg.RunSettings.__dataclass_fields__.keys())
    js, ts = jcfg.RunSettings(), tcfg.RunSettings()
    assert (js.z_in, tuple(js.z_out)) == (ts.z_in, tuple(ts.z_out))
    np.testing.assert_array_equal(js.etasteps(), ts.etasteps())


@pytest.mark.parametrize("preset", PRESETS)
def test_grids_bit_identical(preset):
    gj = jgrids.make_grids(_preset(jcfg, preset))
    gt = tgrids.make_grids(_preset(tcfg, preset))
    for name in ("nk", "npts", "nshift", "dlnk"):
        assert getattr(gj, name) == getattr(gt, name)
    for name in ("lnk", "k", "lnk_ext", "k_ext", "wp", "wc"):
        np.testing.assert_array_equal(getattr(gj, name), getattr(gt, name))
    Mj, vj = jgrids.pab_extension_matrix(gj)
    Mt, vt = tgrids.pab_extension_matrix(gt)
    np.testing.assert_array_equal(Mj, Mt)
    np.testing.assert_array_equal(vj, vt)
    x = np.linspace(0.0, 1.0, 17)
    np.testing.assert_array_equal(jgrids.w_edge(x), tgrids.w_edge(x))


@pytest.mark.parametrize("kw", [
    dict(dtype="float32"), dict(engine_transform_dtype="float32"),
    dict(out_leg="ozaki"), dict(tab_leg="ozaki"), dict(fwd_leg="ozaki"),
    dict(pz_leg="ozaki"), dict(eta_tableau="rk4"),
    dict(quad_impl="simpson")])
def test_config_rejects_what_the_port_does_not_run(kw):
    with pytest.raises(ValueError):
        tcfg.SolverConfig(**kw)
    tcfg.SolverConfig(out_leg="dot", pz_leg="auto")     # these are fine


def test_import_leaves_jax_out():
    """The port never imports JAX, directly or through the JAX package,
    nor Triton (every hand kernel is CUDA C++), and no source of the
    package has an import of either."""
    code = ("import sys, pkgutil, importlib, pathlib, re, redtime_tpu_torch\n"
            "for m in pkgutil.walk_packages(redtime_tpu_torch.__path__,"
            " 'redtime_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'triton', 'redtime_tpu')]\n"
            "assert not bad, bad\n"
            "pat = re.compile(r'^\\s*(import|from)\\s+(jax|triton|"
            "redtime_tpu)\\b', re.M)\n"
            "root = pathlib.Path(redtime_tpu_torch.__path__[0])\n"
            "hits = [str(p) for p in root.rglob('*.py')"
            " if pat.search(p.read_text())]\n"
            "assert not hits, hits\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_axis_weights_match_jax():
    """Dynamic bracketing + Lagrange weights over interior, edge and
    extrapolated points, shared and per-lane node axes."""
    nodes = np.log(np.linspace(0.1, 1.1, 12))
    xs = np.concatenate([[nodes[0] - 0.3, nodes[0]], np.linspace(
        nodes[0], nodes[-1], 23)[1:-1], [nodes[-1], nodes[-1] + 0.2]])
    tn = torch.as_tensor(nodes)
    for x in xs:
        i0j, wj = jinterp.axis_weights(jnp.asarray(nodes), x)
        i0t, wt = tinterp.axis_weights(tn, torch.tensor(x,
                                                        dtype=torch.float64))
        assert int(i0j) == int(i0t)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                                   atol=4e-16 * np.abs(np.asarray(wj)).max())
    # per-lane axes [B, nn] with one query per lane, and the full-width form
    nb = np.stack([nodes, nodes + 0.05])
    xq = np.array([nodes[3] + 0.01, nodes[-2] + 0.3])
    full = tinterp.axis_weights_full(torch.as_tensor(nb), torch.as_tensor(xq))
    for b in range(2):
        ref = np.asarray(jinterp.axis_weights_full(jnp.asarray(nb[b]), xq[b]))
        np.testing.assert_allclose(full[b].numpy(), ref, rtol=0,
                                   atol=4e-16 * np.abs(ref).max())
    np.testing.assert_array_equal(
        tinterp.weight_matrix_np(nodes, xs),
        jinterp.weight_matrix_np(nodes, xs))


@pytest.mark.parametrize("fn", ["H2_H02", "dlnH_dlna", "a4H2_H02",
                                "dlnH_dlna_bounded", "E_de", "Y_nu"])
def test_background_matches_jax(fn):
    from __graft_entry__ import _cosmo
    cs = [_cosmo(i) for i in range(3)]
    a = np.array([1e-20, 1e-8, 1e-3, 0.01, 0.3, 1.0, 1.1])
    c_t = state.cosmo_from_numpy(
        jcfg.CosmoParams(*[np.stack([np.asarray(c[i]) for c in cs])
                           for i in range(9)]))
    if fn in ("H2_H02", "dlnH_dlna", "E_de", "Y_nu"):
        a = a[2:]          # the unbounded forms overflow near a_early
    got = getattr(tbg, fn)(c_t, torch.as_tensor(a).expand(3, -1)).numpy()
    for b, c in enumerate(cs):
        ref = np.asarray(getattr(jbg, fn)(c, jnp.asarray(a)))
        np.testing.assert_allclose(got[b], ref, rtol=4e-15, atol=0)
