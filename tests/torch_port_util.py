"""Shared set-up of the PyTorch-port tests (tests/test_torch_*.py).

Imported by every port test file: it pins torch to one thread (tier-1
runs pytest-xdist with several workers, each holding JAX and torch) and
builds the same inputs for both packages from __graft_entry__'s synthetic
linear data.  Data moves between the frameworks only as numpy arrays.

JAX is imported only by `jax_batch`, so the kernel tests
(tests/test_torch_kernels.py) also run on a GPU machine without JAX.
`deadline` is the time limit of the worker tests' waits
(tests/test_torch_sharding.py, tests/test_torch_overlap.py).
"""

from __future__ import annotations

import contextlib
import os
import signal

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from redtime_tpu_torch import state  # noqa: E402


def jax_batch(n: int, cfg, nu: bool = True):
    """(cosmos, lins): n stacked JAX cosmologies _cosmo(0..n-1) and n
    copies of the example linear inputs."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _cosmo, _example_inputs

    lin = _example_inputs(cfg, nu)
    cosmos = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *[_cosmo(i) for i in range(n)])
    lins = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *([lin] * n))
    return cosmos, lins


def port_inputs(cosmos, lins, device="cpu"):
    """The same batch as the port's (CosmoParams, LinearData) tensors."""
    return (state.cosmo_from_numpy(cosmos, device),
            state.linear_from_numpy(lins, device))


def col_scale_dev(got: np.ndarray, ref: np.ndarray, axes) -> float:
    """max |got - ref| relative to the max |ref| over `axes`."""
    scale = np.max(np.abs(ref), axis=axes, keepdims=True) + 1e-300
    return float(np.max(np.abs(got - ref) / scale))


@pytest.fixture
def cuda_device():
    """A CUDA device for the tests marked `cuda`; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (on the card: python -m pytest "
                    "--noconftest tests/test_torch_kernels.py -m cuda)")
    return torch.device("cuda")


class Deadline(Exception):
    """A test's wait outlived its time limit (see `deadline`)."""


@contextlib.contextmanager
def deadline(seconds: float):
    """Raise Deadline in the block once `seconds` have passed: the time
    limit of a test's wait on worker processes, so a hung worker fails
    the test instead of the suite (pytest runs tests on the main thread,
    where the alarm signal is delivered)."""
    def expire(signum, frame):
        raise Deadline(f"no result within {seconds} s")

    before = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, before)


def k8_bracket(nodes: np.ndarray, x: float):
    """K8's per-warp bracket (csrc/rhs_tail.cu bracket()) in numpy, on one
    lane's nodes [nn] at x: (pos, i0, cubic, w [4]).  pos counts the nodes
    with !(node >= x), as the warp's ballots do; then interp.axis_weights'
    branch and weights, each operation in the kernel's order."""
    nn = len(nodes)
    with np.errstate(invalid="ignore"):
        pos = int(np.count_nonzero(~(nodes >= x)))
    n = min(max(pos - 1, 0), nn - 2)
    i0 = min(max(n - 1, 0), nn - 4)
    xs = nodes[i0:i0 + 4]
    x = np.float64(x)
    cubic = 0 < n < nn - 2
    w = np.empty(4)
    with np.errstate(all="ignore"):
        if cubic:
            for j in range(4):
                num = np.float64(1.0)
                for m in range(4):
                    if m != j:
                        num = num * (x - xs[m]) / (xs[j] - xs[m])
                w[j] = num
        else:
            off = n - i0
            t = (x - xs[off]) / (xs[off + 1] - xs[off])
            u = 1.0 - t
            w[:] = [u * float(m == off) + t * float(m == off + 1)
                    for m in range(4)]
    return pos, i0, cubic, w


def k8_lookup(i0: int, w: np.ndarray, rows: np.ndarray,
              order: str = "chunks") -> np.ndarray:
    """K8's 4-node sum over rows [nn, nk] (csrc/rhs_tail.cu dot4_*):
    "pairs" (the beta table's) nodes 0, 2 and 1, 3 summed apart, then
    added; "chunks" (the growth table's) the nodes of each chunk of 4 (by
    i0 + j) summed apart, the chunks in order.  fma on the card, here a
    product and a sum each (within an ulp a step)."""
    t = [w[m] * rows[i0 + m] for m in range(4)]
    with np.errstate(invalid="ignore"):
        if order == "pairs":
            return (t[0] + t[2]) + (t[1] + t[3])
        first = 4 - i0 % 4
        lo, hi = sum(t[:first], np.zeros(rows.shape[-1])), sum(
            t[first:], np.zeros(rows.shape[-1]))
        return lo if first == 4 else lo + hi


def k8_prologue(eta, om, src=None):
    """K8's lookups in numpy, lane by lane as its warps compute them:
    (beta [B, nk], den [B], o11 [B], and for a 1-loop src (D, dD/da
    [B, nk], z [B]) or None).  om / src: kernels.rhs_tail.OmegaIn /
    OneLoopSrc on the CPU."""
    f = lambda x: x.numpy()
    eta = f(eta)
    B = len(eta)
    beta_a, beta_s, f_nu = f(om.beta_a), f(om.beta_solver), f(om.f_nu)
    k = {n: f(v) for n, v in om.consts._asdict().items()}
    nz, nk = beta_s.shape[1:]
    beta, den, o11 = np.zeros((B, nk)), np.empty(B), np.empty(B)
    with np.errstate(all="ignore"):
        for b in range(B):
            a = np.float64(om.a_in) * np.exp(eta[b])
            if nz:
                _, i0, _, w = k8_bracket(beta_a[b], 1.0 if a > 1.0 else a)
                raw = k8_lookup(i0, w, beta_s[b], "pairs")
                beta[b] = 0.0 if f_nu[b] < 1e-10 else f_nu[b] * raw
            fo, a3 = k["fcb_om"][b], a * a * a
            a4 = np.power(a, 4.0)
            E = np.power(a, k["e_pow"][b]) * np.exp(k["e_wa"][b] * (1.0 - a))
            cold = a >= k["a_nu"][b]
            hot = k["y_hot"][b] / (fo * a)
            Y1 = 1.0 + (k["y_cold"][b] if cold else hot)
            H2 = fo * Y1 / a3 + k["OL"][b] * E + k["Og"][b] / a4
            dE = 3.0 * E * (k["wa"][b] - k["w1"][b] / a)
            dY = 0.0 if cold else k["dy_hot"][b] / (fo * a * a)
            dlnH = 0.5 * a / H2 * (fo * (-3.0 * Y1 + a * dY) / a4
                                   + k["OL"][b] * dE
                                   - k["og4"][b] / np.power(a, 5.0))
            den[b], o11[b] = a3 * H2, 3.0 + dlnH
        if src is None or not hasattr(src, "g_lna"):
            return beta, den, o11, None
        lna, G, dD, Dn = (f(src.g_lna), f(src.g_G), f(src.g_dDda),
                          f(src.g_Dnorm))
        D, dDda, z = np.empty((B, nk)), np.empty((B, nk)), np.empty(B)
        for b in range(B):
            z[b] = np.exp(-eta[b]) * (1.0 + src.z_in) - 1.0
            a = 1.0 / (1.0 + z[b])
            _, i0, _, w = k8_bracket(lna[b], np.log(a))
            D[b] = k8_lookup(i0, w, G[b]) * a / Dn[b]
            dDda[b] = k8_lookup(i0, w, dD[b]) / Dn[b]
    return beta, den, o11, (D, dDda, z)
