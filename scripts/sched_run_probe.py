#!/usr/bin/env python3
"""Where a cycle of the scheduled run's warp variant spends its time, on
one NVIDIA card.

    python3 scripts/sched_run_probe.py      # from the root of a checkout

A copy of ``csrc/schedule_fire.cu`` with ``clock64()`` stamps around the
phases of the warp variant's cycle (stream 0's first thread: the next
cycle's entries and pid, the feed and its barrier, the fire and its
barrier, the drain and the register moves, the chunk's restaging) is
built into ``build/probe/`` with the other sources and run on
dot_prod n = 32 (B = 1024, 8 and 1 streams of 4096 tokens, and phase 4's
B = 8 streams of 9 tokens of ``chip_smoke.py``), on one and two warps a
stream, through the port's own wrapper.  Prints the device time, the
nanoseconds a cycle and the mean SM clocks of each phase a cycle.  The
card's name and power limit come first.  Needs a card; nothing of the
port's results depends on it.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "probe"
PHASES = ("entries", "feed", "fire", "drain", "restage")
# (anchor in the warp kernel, text put in its place)
STAMPS = (
    ("  for (int c = 0; c < d.cycles; ++c) {\n"
     "    // the next cycle's entries",
     "  long long acc[6] = {0, 0, 0, 0, 0, 0};\n"
     "  for (int c = 0; c < d.cycles; ++c) {\n"
     "    const long long s0 = clock64();\n"
     "    // the next cycle's entries"),
    ("    // 1. feed: the token held since the last feed",
     "    const long long s1 = clock64();\n"
     "    // 1. feed: the token held since the last feed"),
    ("    stream_sync<kG>(bar_id);\n    // 2. fire",
     "    stream_sync<kG>(bar_id);\n"
     "    const long long s2 = clock64();\n    // 2. fire"),
    ("    stream_sync<kG>(bar_id);\n    // 3. drain",
     "    stream_sync<kG>(bar_id);\n"
     "    const long long s3 = clock64();\n    // 3. drain"),
    ("    npid = nnpid;\n",
     "    npid = nnpid;\n    const long long s4 = clock64();\n"),
    ("      cp_async_commit();\n    }\n  }\n  cp_async_wait_all();",
     "      cp_async_commit();\n    }\n"
     "    const long long s5 = clock64();\n"
     "    acc[0] += s1 - s0; acc[1] += s2 - s1; acc[2] += s3 - s2;\n"
     "    acc[3] += s4 - s3; acc[4] += s5 - s4; acc[5] += 1;\n  }\n"
     "  if (b == 0 && t == 0)\n"
     "    for (int i = 0; i < 6; ++i) g_stamps[i] = acc[i];\n"
     "  cp_async_wait_all();"),
)


def build(stamps=STAMPS, n=6, after=None, tag="sched") -> ctypes.CDLL:
    """A stamped library: the kernel library with schedule_fire.cu
    replaced by a copy with ``stamps`` applied (only past the text
    ``after``, when given) and ``n`` stamp slots readable by
    ``sched_stamps``; the port's wrappers launch it in place of the
    library."""
    src = (CSRC / "schedule_fire.cu").read_text()
    src = src.replace(
        '#include "alu.cuh"',
        f'#include "alu.cuh"\n__device__ long long g_stamps[{n}];')
    head, tail = ("", src) if after is None else src.split(after, 1)
    for anchor, text in stamps:
        if anchor not in tail:
            raise RuntimeError(f"schedule_fire.cu changed: {anchor[:40]!r}")
        tail = tail.replace(anchor, text, 1)
    src = head + ("" if after is None else after) + tail
    src += ('\nextern "C" int sched_stamps(long long* out) {\n'
            '  return static_cast<int>(cudaMemcpyFromSymbol(\n'
            f'      out, g_stamps, {n} * sizeof(long long)));\n}}\n')
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"schedule_fire_{tag}.cu").write_text(src)
    from repro_torch.kernels import _build
    nvcc = _build._nvcc()
    flags = [*_build.NVCC_FLAGS, "-I", str(CSRC)]
    objs, procs = [], []
    for s in (OUT / f"schedule_fire_{tag}.cu",
              *(f for f in _build.SOURCES if f.name != "schedule_fire.cu")):
        obj = OUT / f"{s.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *flags, "-c", "-o", str(obj), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(log)
    so = OUT / f"{tag}_stamped.so"
    subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    _build._bind(lib)
    lib.sched_stamps.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sched_run_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line, device_ms
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels import schedule_fire as ksf
    print(card_line(), flush=True)
    lib = build()
    _build.load = lambda: lib          # the wrapper launches the stamped copy
    dev = torch.device("cuda")
    ctx = DataflowEngine(library.dot_product_graph(32).graph, device=dev,
                         schedule=True)._sched_ctx()
    n_in = ctx.in_arc.size
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, L in ((1024, 4096), (8, 4096), (1, 4096), (8, 9)):
        plan = ctx.plan_for((L,) * n_in)
        plan.ensure(1 << 20)
        program = ksf.flat_program(*plan.trace_struct(plan.total))
        tabs = ksf.device_sched_tables(ctx, dev)
        fv = torch.randint(0, 9, (B, n_in, L), generator=gen, device=dev,
                           dtype=torch.int32)
        for warps in sorted(tabs.warp["bits"]):
            run = lambda: ksf.launch_sched_variant("warp", tabs, program, fv,
                                                   warps=warps)
            ms = device_ms(run, 3, "sched_run")
            st = (ctypes.c_longlong * 6)()
            lib.sched_stamps(st)
            n = max(st[5], 1)
            print(f"dot_prod B={B} L={L} ({plan.total} cycles), {warps} "
                  f"warp(s) a stream: {ms:.4f} ms, "
                  f"{ms * 1e6 / plan.total:.1f} ns a cycle; SM clocks a "
                  f"cycle: " + ", ".join(f"{p} {st[i] / n:.1f}" for i, p in
                                         enumerate(PHASES))
                  + f", total {sum(st[:5]) / n:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
