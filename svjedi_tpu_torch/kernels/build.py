"""Build the CUDA kernels and the native host library at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libsvjt_kernels_<hash>.so *.o

The library name carries a hash of the sources (``*.cu`` and the headers
they share, ``*.cuh``) and flags, so an edit
rebuilds and an unchanged tree reuses the library in ``_build/`` (listed in
``.gitignore``). A missing ``nvcc`` or a failed build raises with nvcc's
output; there is no fallback.

:func:`build_native` compiles the port's copy of the host I/O and chaining
library (``svjedi_tpu_torch/native/fastio.cpp``) with the flags of the JAX
package's ``native/Makefile`` into ``_build/libsvtfastio.so``, where
``utils/native.py:load_native`` finds it. Without it the host code takes its
numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "fastio.cpp"
NATIVE_LIB = BUILD_DIR / "libsvtfastio.so"
NATIVE_FLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-Wextra",
                "-std=c++17", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
#: Seconds the last build took (0.0 when the library was already built).
build_seconds = 0.0
#: ptxas's resource report (``-Xptxas -v``) of the last build, per source.
ptxas_report: dict = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from svjedi_tpu_torch/kernels/csrc at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsvjt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; return it."""
    global build_seconds, ptxas_report
    so = library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    t0 = time.perf_counter()
    try:
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        report = {}
        for src, cmd, proc in zip(srcs, compiles, procs):
            out, err = proc.communicate()
            _raise_on_failure(cmd, proc, out, err)
            report[src.name] = err
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                *(str(o) for o in objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        _raise_on_failure(link, proc, proc.stdout, proc.stderr)
        os.replace(tmp, so)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    ptxas_report = report
    return so


def build_native() -> Path:
    """Compile the host library unless it is newer than its source; return
    its path."""
    if (NATIVE_LIB.exists()
            and NATIVE_LIB.stat().st_mtime >= NATIVE_SRC.stat().st_mtime):
        return NATIVE_LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libsvtfastio.{os.getpid()}.tmp"
    cmd = ["g++", *NATIVE_FLAGS, "-o", str(tmp), str(NATIVE_SRC), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed (exit {proc.returncode}):"
                               f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, NATIVE_LIB)
    finally:
        tmp.unlink(missing_ok=True)
    return NATIVE_LIB


def _raise_on_failure(cmd, proc, out: str, err: str) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}{err}")


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call and cached."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.band_dp_v3_fwd_launch.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.band_dp_v3_fwd_launch.restype = i32
        lib.band_dp_v3_rev_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.band_dp_v3_rev_launch.restype = i32
        lib.band_dp_onepass_launch.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.band_dp_onepass_launch.restype = i32
        lib.band_dp_stats_launch.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.band_dp_stats_launch.restype = i32
        lib.band_dp_gather_launch.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.band_dp_gather_launch.restype = i32
        i64 = ctypes.c_longlong
        lib.band_dp_dma_launch.argtypes = [
            ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.band_dp_dma_launch.restype = i32
        lib.band_dp_stats_flat_launch.argtypes = [
            ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.band_dp_stats_flat_launch.restype = i32
        lib.dev_scan_launch.argtypes = [ptr, ptr, i32, i64, i32, i32, ptr, ptr]
        lib.dev_scan_launch.restype = i32
        lib.svjt_cuda_error_string.argtypes = [i32]
        lib.svjt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.svjt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
