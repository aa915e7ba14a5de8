"""Reader/writer for the legacy `params_redTime.dat` format.

Schema (positional, '#'-comment lines ignored; reference
`AU_cosmological_parameters.h:231-353` and the documented layout in
`examples/1_redTime/params_redTime.dat:6-29`):

  n_s sigma_8 h Omega_m Omega_b Omega_nu T_cmb w0 wa
  switch_nonlinear switch_1loop switch_print_linear switch_print_rsd
  z_initial
  num_z_outputs  z_out...
  file_transfer_function
  num_massive_nu_approx (must be 0)
  file_nu_transfer_root
  num_interp_redshifts  z_interp...   (kept as literal strings: they name
                                       files  {root}{z}.dat)
"""

from __future__ import annotations

import dataclasses
import os
from typing import List


@dataclasses.dataclass
class ParamsFile:
    n_s: float
    sigma_8: float
    h: float
    Omega_m: float
    Omega_b: float
    Omega_nu: float
    T_cmb: float
    w0: float
    wa: float
    switch_nonlinear: int
    switch_1loop: int
    print_lin: int
    print_rsd: int
    z_in: float
    z_out: List[float]
    transfer_file: str
    nu_approx: int
    nu_transfer_root: str
    z_interp_str: List[str]

    @property
    def z_interp(self) -> List[float]:
        return [float(z) for z in self.z_interp_str]

    def nu_transfer_files(self, base_dir: str = "") -> List[str]:
        return [os.path.join(base_dir, f"{self.nu_transfer_root}{z}.dat")
                for z in self.z_interp_str]


def _tokens(path: str) -> List[str]:
    toks: List[str] = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            toks.extend(line.split())
    return toks


def read_params_file(path: str) -> ParamsFile:
    t = _tokens(path)
    it = iter(t)
    pos = [0]

    def nx() -> str:
        # a truncated file otherwise surfaces as a bare StopIteration
        # with no indication of which positional field was missing
        try:
            tok = next(it)
        except StopIteration:
            raise ValueError(
                f"{path}: params file truncated — expected another token "
                f"after {pos[0]} (schema: 9 floats, 4 switches, z_in, "
                f"n_out + z list, transfer file, nu approx, nu root, "
                f"n_interp + z strings)") from None
        pos[0] += 1
        return tok

    def nf() -> float:
        return float(nx())

    def ni() -> int:
        return int(nx())

    floats = [nf() for _ in range(9)]
    switches = [ni() for _ in range(4)]
    z_in = nf()
    n_out = ni()
    z_out = [nf() for _ in range(n_out)]
    transfer_file = nx()
    nu_approx = ni()
    if nu_approx != 0:
        raise ValueError(
            f"num_massive_nu_approx={nu_approx}: only CAMB interpolation "
            "(0) is supported, matching the reference")
    nu_root = nx()
    n_interp = ni()
    if n_interp < 0:
        raise ValueError("negative num_interp_redshifts")
    z_interp = [nx() for _ in range(n_interp)]

    return ParamsFile(*floats, *switches, z_in, z_out, transfer_file,
                      nu_approx, nu_root, z_interp)


def write_params_file(path: str, p: ParamsFile) -> None:
    """Emit a params_redTime.dat the reference binary could also consume."""
    lines = ["# params_redTime.dat written by redtime_tpu"]
    for name in ("n_s", "sigma_8", "h", "Omega_m", "Omega_b", "Omega_nu",
                 "T_cmb", "w0", "wa"):
        lines += [f"# {name}", repr(getattr(p, name))]
    for name in ("switch_nonlinear", "switch_1loop", "print_lin",
                 "print_rsd"):
        lines += [f"# {name}", str(getattr(p, name))]
    lines += ["# z_initial", repr(p.z_in),
              "# num_z_outputs", str(len(p.z_out)),
              "# z outputs", " ".join(repr(z) for z in p.z_out),
              "# transfer file", p.transfer_file,
              "# nu approx", str(p.nu_approx),
              # an empty root would be a blank line the token stream
              # drops, shifting every later positional field; the
              # placeholder is never read when num_interp_redshifts == 0
              "# nu transfer root", p.nu_transfer_root or "none",
              "# num interp redshifts", str(len(p.z_interp_str)),
              "# interp redshifts", " ".join(p.z_interp_str)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
