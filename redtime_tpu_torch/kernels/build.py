"""Build and load the CUDA C++ kernels.

The sources in `redtime_tpu_torch/csrc/` have a plain C interface and are
compiled by `nvcc` for Hopper (`sm_90a`), one `nvcc` per source and all
of them at once, then linked into one shared library, loaded with
ctypes.  Headers generated from the package's Python (`generated`: K8's
A/R code, K11's programs and layouts) are written beside them in the
build's scratch directory.  The library is built at first use into
`build/redtime_tpu_torch/` at the repository root, under a name that
carries the hash of the sources, the generated headers and the flags, so
an edited source rebuilds and an unchanged one is reused.

Every C entry point takes device pointers, sizes and the CUDA stream, and
returns `cudaGetLastError()` after its launch; the Python wrappers raise
when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
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


@functools.lru_cache(maxsize=1)
def generated() -> dict:
    """Headers generated from the package's Python, name -> text, written
    beside the sources at build time: K8's A/R code (rhs_tail.ar_source,
    traced from assembly.ar_rows) and K11's programs and layouts
    (out_block.out_source)."""
    from redtime_tpu_torch.kernels import out_block, rhs_tail
    return {"rhs_tail_ar.cuh": rhs_tail.ar_source(),
            "out_block_gen.cuh": out_block.out_source()}


def source_hash(defines: tuple = (), only: tuple = ()) -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for name, text in sorted(generated().items()):
        h.update(name.encode())
        h.update(text.encode())
    h.update(" ".join(NVCC_FLAGS + _flags(defines) + only).encode())
    return h.hexdigest()[:16]


def _flags(defines: tuple) -> tuple:
    return tuple(f"-D{d}" for d in defines)


def library_path(defines: tuple = (), only: tuple = ()) -> Path:
    return BUILD_DIR / (f"libredtime_kernels_"
                        f"{source_hash(defines, only)}.so")


def build(defines: tuple = (), only: tuple = ()) -> Path:
    """Compile the kernels if the current sources are not built yet;
    returns the library path.  Raises with nvcc's output on failure.
    `defines` (NAME=VALUE) and `only` (source names: the others are left
    out) make another library beside the package's, for measurements
    (scripts/time_rhs_tail.py's builds of K8 with a part taken out)."""
    out = library_path(defines, only)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        for name, text in generated().items():
            Path(tmp, name).write_text(text)
        objs = [(p, os.path.join(tmp, p.stem + ".o"))
                for p in _sources() if p.suffix == ".cu"
                and (not only or p.name in only)]
        cmds = [[nvcc, *NVCC_FLAGS, *_flags(defines), "-I", str(CSRC), "-I",
                 tmp, "-c", str(p), "-o", o] for p, o in objs]
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


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The streaming multiprocessors of CUDA device `device` (the launch
    plans of K1 and K10 read it)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.rt_out_leg.argtypes = [p, p, p, i, i, i, i, ctypes.c_longlong,
                                       i, i, p]
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
        handle.rt_oz_fused.argtypes = [p] * 7 + [i] * 3 + [p]
        handle.rt_oz_fused.restype = i
        handle.rt_oz_fused_ablate.argtypes = [p] * 7 + [i] * 4 + [p]
        handle.rt_oz_fused_ablate.restype = i
        handle.rt_oz_pack_w.argtypes = [p, p, i, i, p, n, p]
        handle.rt_oz_pack_w.restype = i
        handle.rt_oz_fused_plan.argtypes = [i, i, i,
                                            ctypes.POINTER(ctypes.c_longlong)]
        handle.rt_oz_fused_plan.restype = None
        handle.rt_dd_mul.argtypes = [p, p, p, p, p, p, n, p]
        handle.rt_dd_mul.restype = i
        handle.rt_launch_floor.argtypes = [p]
        handle.rt_launch_floor.restype = i
        handle.rt_rk_finish.argtypes = [p] * 8 + [i] + [p] * 6 + [i] * 6 \
            + [p]
        handle.rt_rk_finish.restype = i
        handle.rt_rk_stage.argtypes = [p] * 5 + [i] * 5 + [p]
        handle.rt_rk_stage.restype = i
        bind_rhs_tail(handle)
        bind_engine(handle)
        bind_out_block(handle)
        _lib = handle
    return _lib


def bind_engine(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K9's and K10's entry points on a loaded library."""
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    handle.rt_engine_front.argtypes = [p, n, n, p, n, i] + [p] * 9 \
        + [i] * 5 + [p, i, p]
    handle.rt_engine_front.restype = i
    handle.rt_tab_leg.argtypes = [p] * 7 + [i] * 7 + [p, i, p]
    handle.rt_tab_leg.restype = i
    return handle


def bind_rhs_tail(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K8's entry point rt_rhs_tail on a loaded library."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    handle.rt_rhs_tail.argtypes = [p, i, d, d] + [i] * 9 + [p]
    handle.rt_rhs_tail.restype = i
    return handle


def bind_out_block(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K11's entry point rt_out_block on a loaded library."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    handle.rt_out_block.argtypes = [p, i] + [p] * 5 + [d] * 4 + [i] * 15 \
        + [p]
    handle.rt_out_block.restype = i
    return handle


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{status}")
