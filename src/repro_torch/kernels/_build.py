"""Build and load the CUDA kernel library at first use.

``nvcc`` compiles every ``csrc/*.cu`` (``dataflow_fire.cu``: the
fire-block kernel's two variants, the fire step's two and two latency
probes; ``schedule_fire.cu``: the static-schedule kernels (the run
kernel's two variants and the slot step's two), both including
``csrc/alu.cuh``; ``multifabric.cu``: the sharded block kernel's two
variants, which include it too; ``flash_attention.cu`` and ``rmsnorm.cu``: the LM
kernels, forward and backward) for Hopper (``sm_90a``), one compiler per source, all started
together, and links
the objects into one shared library with a plain C interface.  It is
written under ``build/`` at the repository root (named by a hash over
every source and header) and loaded with :mod:`ctypes`.  The build
happens once per process, at the first launch; every new process builds
afresh (a few seconds), so a library is never older than its sources.
Nothing here runs at import time.
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

CSRC = pathlib.Path(__file__).with_name("csrc")
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME): "
                       "the CUDA kernels are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for f in (*SOURCES, *HEADERS):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # every pointer and the stream as c_void_p: without argtypes ctypes
    # would pass 32-bit ints and cut them
    for name, n_ptr, n_int in (("fire_block_launch", 42, 14),
                               ("fire_step_launch", 13, 2),
                               ("fire_step_warp_launch", 7, 3),
                               ("fire_empty_launch", 0, 0),
                               ("fire_floor_launch", 1, 1),
                               ("sched_run_launch", 16, 7),
                               ("sched_run_warp_launch", 9, 15),
                               ("sched_slot_step_launch", 25, 7),
                               ("sched_slot_warp_launch", 18, 9),
                               ("mf_block_launch", 22, 14),
                               ("flash_attention_tiled_launch", 5, 10),
                               ("flash_attention_wgmma_launch", 5, 10),
                               ("flash_attention_bwd_dq_launch", 8, 8),
                               ("flash_attention_bwd_dkdv_launch", 8, 8),
                               ("flash_attention_bwd_dq_wgmma_launch", 8, 8),
                               ("flash_attention_bwd_dkdv_wgmma_launch", 8,
                                8),
                               ("rmsnorm_bwd_reduce_launch", 2, 2),
                               ("flash_attention_split_launch", 6, 12),
                               ("flash_attention_combine_launch", 4, 7)):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
        fn.restype = ci
    # RMSNorm: pointers and the stream c_void_p, shapes, dtype code, flag
    # and variant int, eps float
    lib.rmsnorm_launch.argtypes = [vp] * 3 + [ci] * 5 + [ctypes.c_float, vp]
    lib.rmsnorm_launch.restype = ci
    lib.rmsnorm_bwd_launch.argtypes = [vp] * 5 + [ci] * 8 + [ctypes.c_float,
                                                            vp]
    lib.rmsnorm_bwd_launch.restype = ci
    lib.rmsnorm_bwd_rows_occupancy.argtypes = [ci] * 4
    lib.rmsnorm_bwd_rows_occupancy.restype = ci
    lib.fire_block_smem_bytes.argtypes = [ci] * 6
    lib.fire_block_smem_bytes.restype = ci
    lib.sched_warp_plan.argtypes = [ci] * 10 + [vp]
    lib.sched_warp_plan.restype = ci
    lib.sched_slot_plan.argtypes = [ci] * 7 + [vp]
    lib.sched_slot_plan.restype = ci
    lib.mf_block_smem_bytes.argtypes = [ci] * 6
    lib.mf_block_smem_bytes.restype = ci
    lib.fire_block_smem_limit.argtypes = [ci]
    lib.fire_block_smem_limit.restype = ci
    lib.fire_block_error_string.argtypes = [ci]
    lib.fire_block_error_string.restype = ctypes.c_char_p


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built from the current sources on first call.
    The returned library carries ``build_seconds`` and ``build_log``
    (the compilers' output, with the ``-Xptxas -v`` register and
    shared-memory report of every kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"repro_torch_kernels_{_digest()}.so"
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = []
    for src, proc in zip(SOURCES, procs):
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            for p in procs:
                p.wait()
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    tmp = out.with_name(f"{out.stem}.{tag}.so")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
    os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.build_seconds = time.perf_counter() - t0
    lib.build_log = "".join(logs) + link.stdout + link.stderr
    _bind(lib)
    return lib
