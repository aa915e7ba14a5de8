"""ctypes bindings of the port's host IO runtime (csrc/redtime_io.cpp).

The CLI reads CAMB transfer stacks through `parse_stack` / `parse_table`
(OpenMP over a cosmology's files) and writes every output table through
`format_rows`.  The library is host C++ (g++ -O3 -fPIC -fopenmp), built at
first use into `build/redtime_tpu_torch/` at the repository root under a
name that carries the hash of the source, the compiler and its flags, so
an edited source rebuilds and an unchanged one is reused.  There is no
fallback: a failed build raises with the compiler's output.  The numpy
and f-string versions (`camb.read_transfer_file_plain`,
`writer._format_block_plain`) are the plain versions the tests hold
these to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "redtime_io.cpp"
BUILD_DIR = _PKG.parent / "build" / "redtime_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-fopenmp", "-shared")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    if not SOURCE.is_file():
        raise RuntimeError(f"{SOURCE} is missing, so the IO library cannot "
                           "be built (an install without csrc/*.cpp)")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((CXX,) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libredtime_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the IO library with CXX unless this source is built
    already; returns its path.  Raises with the compiler's output on
    failure.  Concurrent builds (test workers) each compile in a
    directory of their own and rename the result into place."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib_tmp = os.path.join(tmp, out.name)
        cmd = [CXX, *CXX_FLAGS, "-o", lib_tmp, str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as err:
            raise RuntimeError(f"cannot run the C++ compiler {CXX!r} that "
                               f"builds {SOURCE.name}: {err}") from err
        if proc.returncode:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(lib_tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded IO library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        n = ctypes.c_long
        handle.parse_table.restype = n
        handle.parse_table.argtypes = [ctypes.c_char_p, n, f64, n]
        handle.parse_stack.restype = None
        handle.parse_stack.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), n, n, f64, n,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
        handle.io_threads.restype = n
        handle.io_threads.argtypes = []
        handle.format_rows.restype = n
        handle.format_rows.argtypes = [f64, n, n, n, n, ctypes.c_char_p, n]
        _lib = handle
    return _lib


def io_threads() -> int:
    """The OpenMP threads parse_stack gets when called from this thread."""
    return int(lib().io_threads())


def _rows_upper_bound(path: str) -> int:
    """Upper bound on a file's value count from its byte size (>= 8 bytes
    a value is a safe floor for numeric text): right-sized buffers, since
    first-touch of oversized ones is costly on small hosts."""
    return os.path.getsize(path) // 8 + 16


def _short_row(path, ncols: int) -> ValueError:
    return ValueError(
        f"{path}: a numeric row has fewer than {ncols} columns "
        "(wrong-format or corrupt table — e.g. a classic 7-column "
        "transfer file read with modern=True)")


def parse_table(path, ncols: int, max_rows: Optional[int] = None
                ) -> np.ndarray:
    """Parse a '#'-commented numeric table -> [rows, ncols] f64: lines
    with no number are skipped, columns past ncols ignored, a numeric row
    with fewer than ncols values raises ValueError.  The buffer starts at
    max_rows (a bound from the file's size if None) and doubles while it
    fills with rows left over."""
    if ncols < 1:
        raise ValueError(f"ncols must be >= 1, got {ncols}")
    handle = lib()
    if max_rows is None:
        max_rows = _rows_upper_bound(path) // ncols
    max_rows = max(max_rows, 1)
    while True:
        out = np.empty((max_rows, ncols), dtype=np.float64)
        rows = handle.parse_table(os.fsencode(path), ncols, out, max_rows)
        if rows == -2:
            max_rows *= 2
            continue
        if rows == -3:
            raise _short_row(path, ncols)
        if rows < 0:
            raise OSError(f"native parse failed for {path}")
        return out[:rows].copy()


def parse_stack(paths: Sequence, ncols: int,
                max_rows: Optional[int] = None) -> List[np.ndarray]:
    """parse_table over many identically formatted tables, one OpenMP
    iteration a file; a file that overfills the shared buffer is parsed
    again on its own with a larger one."""
    if ncols < 1:
        raise ValueError(f"ncols must be >= 1, got {ncols}")
    handle = lib()
    if max_rows is None:
        max_rows = max(_rows_upper_bound(p) for p in paths) // ncols
    max_rows = max(max_rows, 1)
    n = len(paths)
    out = np.empty((n, max_rows, ncols), dtype=np.float64)
    rows = np.empty(n, dtype=np.int64)
    names = [os.fsencode(p) for p in paths]
    arr = (ctypes.c_char_p * n)(*names)
    handle.parse_stack(arr, n, ncols, out, max_rows, rows)
    result = []
    for p, r, table in zip(paths, rows, out):
        if r == -2:
            result.append(parse_table(p, ncols, max_rows * 2))
        elif r == -3:
            raise _short_row(p, ncols)
        elif r < 0:
            raise OSError(f"native parse failed for {p}")
        else:
            result.append(table[:r].copy())
    return result


def format_rows(block: np.ndarray, width: int, prec: int) -> str:
    """Format a [nr, nc] f64 block as the reference's output rows: every
    value %.{prec}g right-justified to `width`, one line a row
    (redTime.cc:64's setprecision / setw), every NaN as "nan": the bytes
    of Python's f"{x:>{width}.{prec}g}"."""
    a = np.ascontiguousarray(block, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError(f"format_rows expects a 2-D block, got {a.shape}")
    nr, nc = a.shape
    # %.{prec}g with prec <= 17 is at most 24 characters
    cap = nr * (nc * (max(width, 24) + 8) + 2) + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib().format_rows(a, nr, nc, width, prec, buf, cap)
    if n < 0:
        raise RuntimeError(f"format_rows: {cap} bytes too few for a "
                           f"{nr} x {nc} block")
    return buf.raw[:n].decode("ascii")
