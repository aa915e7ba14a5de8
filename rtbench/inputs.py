"""The benchmark's inputs, made from --seed: frozen copies of the port's
input makers at the commit that added the benchmark.

  * `latin_hypercube`, `models_from_unit_cube`: redtime_tpu_torch.design
    (the Mira-Titan box of misc/convert_katrin_hypercube.py in the
    reference);
  * `design_params`: chip_smoke.design_params (omega / h^2, T_cmb 2.726);
  * `example_linear`: chip_smoke.example_linear (a smooth CDM-like
    transfer and a delta_nu / delta_c ratio stack, shared by every lane).

tests/test_copies.py holds each to its source.
"""

from __future__ import annotations

import numpy as np

# the Mira-Titan box: om_m, om_b, s8, h, ns, w0, -(w0+wa)^(1/4), om_nu
RANGES_LOWER = np.array([0.12, 0.0215, 0.7, 0.55, 0.85, -1.3, 0.3, 0.0])
RANGES_UPPER = np.array([0.155, 0.0235, 0.9, 0.85, 1.05, -0.7, 1.29, 0.01])


def latin_hypercube(n: int, dim: int = 8, seed=None) -> np.ndarray:
    """Simple maximin-free LHS in [0,1]^dim (one stratum per sample/axis)."""
    rng = np.random.default_rng(seed)
    u = (np.argsort(rng.random((dim, n)), axis=1).T
         + rng.random((n, dim))) / n
    return u


def models_from_unit_cube(lhc: np.ndarray) -> np.ndarray:
    """Map unit-cube samples -> (om_m, om_b, s8, h, ns, w0, wa, om_nu),
    decoding wa from the -(w0+wa)^(1/4) coordinate."""
    vals = lhc * (RANGES_UPPER - RANGES_LOWER) + RANGES_LOWER
    out = vals.copy()
    out[:, 6] = -(vals[:, 6] ** 4) - vals[:, 5]    # wa
    return out


def design_params(n: int, seed) -> np.ndarray:
    """[n, 9] cosmologies (n_s, sigma_8, h, Omega_m, Omega_b, Omega_nu,
    T_cmb, w0, wa) of an n-point Latin hypercube over the box."""
    rows = models_from_unit_cube(latin_hypercube(n, seed=seed))
    om_m, om_b, s8, h, ns, w0, wa, om_nu = rows.T
    return np.stack([ns, s8, h, om_m / h ** 2, om_b / h ** 2,
                     om_nu / h ** 2, np.full(n, 2.726), w0, wa], axis=1)


def example_linear():
    """(t_lnk, t_Tc, t_Tb, beta_a, beta_k, beta_raw) of one cosmology."""
    k = np.logspace(-5, 1.3, 600)
    keq = 0.015
    T = 1.0 / (1.0 + (k / keq) ** 2 * np.log(1.0 + k / keq))
    zs = np.array([200.0, 50.0, 10.0, 5.0, 2.0, 1.0, 0.5, 0.0])
    a = 1.0 / (1.0 + zs)
    ratio = 1.0 / (1.0 + (k[None, :] / 0.1) ** 2) * (0.3 + 0.7 * a[:, None])
    return np.log(k), T, T, a, k, ratio


def stream(seed: int, *keys: int) -> int:
    """A 63-bit seed for numpy from the run's --seed (any whole number,
    negative ones too) and the stream's keys (which call, which draw)."""
    words = [abs(int(seed)) & (2 ** 64 - 1), int(seed < 0)] + [
        int(k) for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def batch_inputs(n: int, seed: int, *keys: int, design_seed=None):
    """(params [n, 9], lin: example_linear's arrays stacked n times) of n
    design cosmologies: drawn from the stream (seed, keys), or, with a
    design_seed, the n points of the design drawn from design_seed in an
    order drawn from the stream (every seed then solves the same set)."""
    if design_seed is None:
        params = design_params(n, stream(seed, *keys))
    else:
        order = np.random.default_rng(stream(seed, *keys)).permutation(n)
        params = design_params(n, int(design_seed))[order]
    return params, stacked_linear(n)


def stacked_linear(n: int) -> tuple:
    """example_linear's arrays, each stacked n times (one a cosmology)."""
    return tuple(np.stack([x] * n) for x in example_linear())
