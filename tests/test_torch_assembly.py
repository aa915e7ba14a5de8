"""The PyTorch port's direct assembly and static tables against the JAX
package's.

The static tables are built by the same numpy code and must be
bit-identical.  `assemble` transcribes the same rational combinations term
for term, so on identical J/PZ inputs it must agree within 1e-12 of each
output slot's scale (measured: exactly, since both run the same f64
operations in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads, JAX on CPU)
from redtime_tpu import assembly as ja
from redtime_tpu_torch import assembly as ta


@pytest.mark.parametrize("name", ["SCATTER64", "UNIQ_SEL", "M_N", "JU",
                                  "MIRRORS", "AU", "BU", "CU", "DU", "EU",
                                  "FU"])
def test_static_tables_bit_identical(name):
    np.testing.assert_array_equal(np.asarray(getattr(ta, name)),
                                  np.asarray(getattr(ja, name)))


@pytest.mark.parametrize("i", range(5))
def test_omega_mats_bit_identical(i):
    np.testing.assert_array_equal(ta.OMEGA_MATS[i], ja.OMEGA_MATS[i])


@pytest.mark.parametrize("i", range(2))
def test_omega_bilinear_bit_identical(i):
    np.testing.assert_array_equal(ta.OMEGA_BILINEAR[i],
                                  ja.OMEGA_BILINEAR[i])


@pytest.mark.parametrize("with_rsd", [True, False])
def test_assemble_matches_jax(with_rsd):
    rng = np.random.default_rng(11)
    nk, B = 24, 3
    k = np.logspace(-3, 0, nk)
    J = rng.standard_normal((B, 7, 3, 3, nk)) * np.exp(rng.normal(size=nk))
    PZ = rng.standard_normal((B, 7, 3, 3, nk))
    Jn0 = rng.standard_normal((B, 7, 3, 3, nk)) * k ** 2
    J_lo = rng.standard_normal(B)
    got = ta.assemble(torch.tensor(J), torch.tensor(PZ), torch.tensor(Jn0),
                      torch.tensor(J_lo), torch.tensor(k), with_rsd)
    shapes = [(14, nk), (3, 8, nk), (9, nk), (8, nk)]
    for b in range(B):
        ref = ja.assemble(jnp.asarray(J[b]), jnp.asarray(PZ[b]),
                          jnp.asarray(Jn0[b]), jnp.asarray(J_lo[b]),
                          jnp.asarray(k), with_rsd)
        for x, y, shp in zip(got, ref, shapes):
            y = np.asarray(y)
            assert x[b].shape == shp
            slot = np.abs(y).reshape(-1, nk).max(axis=1) + 1e-300
            dev = np.abs(x[b].numpy() - y).reshape(-1, nk).max(axis=1)
            assert np.all(dev <= 1e-12 * slot)


def test_expand64_matches_jax():
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 14, 8))
    got = ta.expand64(torch.tensor(u)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b],
                                      np.asarray(ja.expand64(jnp.asarray(u[b]))))
