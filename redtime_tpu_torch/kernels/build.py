"""Build and load the CUDA C++ kernels.

The sources in `redtime_tpu_torch/csrc/` have a plain C interface and are
compiled by `nvcc` for Hopper (`sm_90a`), one `nvcc` per source and all
of them at once, then linked into one shared library, loaded with
ctypes.  The library is built at first use into
`build/redtime_tpu_torch/` at the repository root, under a name that
carries the hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused.

Every C entry point takes device pointers, sizes and the CUDA stream, and
returns `cudaGetLastError()` after its launch; the Python wrappers raise
when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "redtime_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
BUILD_LOG: dict = {}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libredtime_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels if the current sources are not built yet;
    returns the library path.  Raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [(p, os.path.join(tmp, p.stem + ".o"))
                for p in _sources() if p.suffix == ".cu"]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(p), "-o", o]
                for p, o in objs]
        # nvcc's output goes to files: a full pipe would block one nvcc
        # while another is waited for
        procs = []
        for c, (_, o) in zip(cmds, objs):
            with open(o + ".log", "w") as log:
                procs.append(subprocess.Popen(c, stdout=log,
                                              stderr=subprocess.STDOUT))
        for proc in procs:
            proc.wait()
        logs = [Path(o + ".log").read_text() for _, o in objs]
        lib_tmp = os.path.join(tmp, "lib.so")
        cmds.append([nvcc, "-shared", "-o", lib_tmp, *[o for _, o in objs]])
        failed = [proc.returncode for proc in procs if proc.returncode]
        if not failed:
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            failed = [link.returncode] if link.returncode else []
        BUILD_LOG.update(seconds=time.perf_counter() - t0,
                         command="\n".join(" ".join(c) for c in cmds),
                         output="".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                               f"{BUILD_LOG['output']}")
        os.replace(lib_tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.rt_out_leg.argtypes = [p, p, p, i, i, i, i, ctypes.c_longlong,
                                       i, p]
        handle.rt_out_leg.restype = i
        handle.rt_pz_leg.argtypes = [p, p, p, p, i, i, i, i, p]
        handle.rt_pz_leg.restype = i
        n = ctypes.c_longlong
        handle.rt_affine.argtypes = [p, p, n, p]
        handle.rt_affine.restype = i
        handle.rt_int8_dot.argtypes = [p, p, p, i, i, i, p]
        handle.rt_int8_dot.restype = i
        handle.rt_int8_dot_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        handle.rt_int8_dot_plan.restype = None
        handle.rt_oz_fused.argtypes = [p] * 5 + [i] * 3 + [p]
        handle.rt_oz_fused.restype = i
        handle.rt_dd_mul.argtypes = [p, p, p, p, p, p, n, p]
        handle.rt_dd_mul.restype = i
        handle.rt_launch_floor.argtypes = [p]
        handle.rt_launch_floor.restype = i
        handle.rt_rk_finish.argtypes = [p] * 13 + [i] * 6 + [p]
        handle.rt_rk_finish.restype = i
        handle.rt_rk_stage.argtypes = [p] * 5 + [i] * 5 + [p]
        handle.rt_rk_stage.restype = i
        _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{status}")
