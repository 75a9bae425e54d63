"""Build and load the CUDA kernel library at first use.

``nvcc`` compiles ``csrc/dataflow_fire.cu`` (the fire-block and
fire-step kernels) for Hopper (``sm_90a``) into
a shared library with a plain C interface, written under ``build/`` at
the repository root (named by the source's hash) and loaded with
:mod:`ctypes`.  The build happens once per process, at the first launch;
every new process builds afresh (a few seconds), so a library is never
older than its source.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

SOURCE = pathlib.Path(__file__).with_name("csrc") / "dataflow_fire.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME): "
                       "the fire-block kernel is built from source at "
                       "first use")


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built from the current source on first call.
    The returned library carries ``build_seconds`` and ``build_log``
    (the compiler's output, with the ``-Xptxas -v`` register and
    shared-memory report)."""
    source = SOURCE.read_bytes()
    digest = hashlib.sha256(source).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"dataflow_fire_{digest}.so"
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.build_seconds = time.perf_counter() - t0
    lib.build_log = proc.stdout + proc.stderr
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # every pointer and the stream as c_void_p: without argtypes ctypes
    # would pass 32-bit ints and cut them
    lib.fire_block_launch.argtypes = [vp] * 38 + [ci] * 9 + [vp]
    lib.fire_block_launch.restype = ci
    lib.fire_step_launch.argtypes = [vp] * 13 + [ci] * 2 + [vp]
    lib.fire_step_launch.restype = ci
    lib.fire_block_smem_bytes.argtypes = [ci] * 5
    lib.fire_block_smem_bytes.restype = ci
    lib.fire_block_smem_limit.argtypes = [ci]
    lib.fire_block_smem_limit.restype = ci
    lib.fire_block_error_string.argtypes = [ci]
    lib.fire_block_error_string.restype = ctypes.c_char_p
    return lib
