"""Output formatting reproducing the reference's stdout contract.

The reference prints `setprecision(12)` `setw(20)` default-float columns
with `###` header lines and two blank lines between redshift blocks
(`src/redTime.cc:1602-1741`).  Downstream tools parse exactly that, so the
format is part of the API; the bytes equal the JAX package's writer.

C++ default-float with precision 12 == printf %.12g.
"""

from __future__ import annotations

from typing import IO

import numpy as np

WIDTH = 20  # reference redTime.cc:64


def _g(x: float) -> str:
    return f"{float(x):.12g}"


def _w(x: float) -> str:
    return f"{_g(x):>{WIDTH}}"


def _format_block(block: np.ndarray) -> str:
    """One redshift block of data rows."""
    return "".join("".join(_w(x) for x in row) + "\n" for row in block)


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def write_result(f: IO[str], res, params_file_name: str | None = None
                 ) -> None:
    """Write one cosmology's RunResult (tensors or arrays without a batch
    dimension; driver.lane picks one out of a batch) as the reference's
    redTime_<model>.dat format."""
    if params_file_name is not None:
        f.write("#cosmological_parameters: opening parameter file: "
                f"{params_file_name}\n")
    f.write(f"###main: eta_fin = {_g(_host(res.eta_fin))}, "
            f"sigmaV2(z=0) = {_g(_host(res.sigmaV2_z0))}\n")
    table = _host(res.table)
    eta, a, z, H, sv2 = (_host(x) for x in (res.eta, res.a, res.z, res.H,
                                            res.sigma_v2))
    for i in range(table.shape[0]):
        f.write(f"### main: output at eta={_g(eta[i])}, "
                f"a={_g(a[i])}, z={_g(z[i])}, H={_g(H[i])}, "
                f"sigma_v^2={_g(sv2[i])}\n")
        f.write(_format_block(table[i]))
        f.write("\n\n")


def write_result_to_path(path: str, res,
                         params_file_name: str | None = None) -> None:
    with open(path, "w") as f:
        write_result(f, res, params_file_name)
