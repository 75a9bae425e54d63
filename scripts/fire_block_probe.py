#!/usr/bin/env python3
"""Where a fire-block launch spends its time, on one NVIDIA card.

    python3 scripts/fire_block_probe.py      # from the root of a checkout

1. Device time (torch.profiler) of both block-kernel variants against the
   block length K in {0, 1, 16, 64, 256} on dot_prod n = 32 (dense and
   optimized plans), at B = 1 and B = 1024 streams with every stream
   active and 4096-token feeds: the K = 0 launch is the fixed cost (state
   in and out), the slope the cost per fabric cycle.
2. SM clocks per phase of the warp variant's cycle: a copy of
   ``csrc/dataflow_fire.cu`` with ``clock64()`` stamps at the start of a
   cycle, around its first ``__syncwarp`` and at its end (stream 0's lane
   0; the arc phase's time includes the second ``__syncwarp``) is built into
   ``build/probe/`` and run at B = 1, K = 64 on dot_prod n = 32 and
   bubble_sort(8), dense and optimized; the medians over the 64 cycles.

With ``--step``, instead: the fire step's warp and CTA kernels (row 6) on
dot_prod n = 32, bubble_sort(8) and fibonacci, device time and SM clocks
per phase from a stamped copy (lane 0 of the warp, thread 0 of the CTA),
beside the empty one-warp kernel's time.

Prints the card's name and power limit first.  Needs a card; nothing of
the port's results depends on it.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

KS = (0, 1, 16, 64, 256)


def inputs(tables, B, L, dev):
    """Every stream active, its real feed rows full-length, pointers at
    100: the block's cycles all feed."""
    import torch
    from repro_torch.testing import STATE_KEYS, random_block_inputs
    x = random_block_inputs(tables, B, L, np.random.default_rng(0))
    x["active"][:] = 1
    x["feed_len"][:, :len(tables["plan"]["input_arcs"])] = L
    x["ptr"][:] = 100
    t = {k: torch.tensor(v, device=dev) for k, v in x.items()}
    return [t["feed_vals"], t["feed_len"], *(t[k] for k in STATE_KEYS)], \
        t["active"]


def k_scaling(dev) -> None:
    from chip_smoke import device_ms
    from repro_torch.core import library
    from repro_torch.kernels import dataflow_fire as df
    g = library.dot_product_graph(32).graph
    for opt in (False, True):
        tables = df.block_plan_arrays(g, optimize=opt)
        dt = df.device_tables(tables, dev)
        for B in (1, 1024):
            args, active = inputs(tables, B, 4096, dev)
            for v in df.VARIANTS:
                us = [1e3 * device_ms(
                    lambda: df.launch_variant(v, dt, *args, n_cycles=K,
                                              active=active), 20,
                    "fire_block_") for K in KS]
                per = (us[-1] - us[2]) / (KS[-1] - KS[2])
                print(f"dot_prod opt={opt} B={B} {v}: "
                      + "  ".join(f"K={K} {u:.1f} us" for K, u in
                                  zip(KS, us))
                      + f"  ({per:.3f} us per cycle)", flush=True)


def stamped_source() -> str:
    """dataflow_fire.cu with clock64() stamps at the warp kernel's phase
    boundaries (stream 0, lane 0, the first 64 cycles) and a getter."""
    src = (ROOT / "src/repro_torch/kernels/csrc/dataflow_fire.cu").read_text()
    lines = src.split("\n")
    loop = next(i for i, s in enumerate(lines)
                if s.strip() == "for (int cyc = c0; cyc < c1; ++cyc) {")
    syncs = [i for i, s in enumerate(lines)
             if s.strip() == "__syncwarp();" and i > loop][:2]

    def stamp(k):
        return (f"      if (lane == 0 && b == 0 && cyc < 64) "
                f"g_clk[4 * cyc + {k}] = clock64();")
    out = []
    for i, s in enumerate(lines):
        if i == syncs[0]:                 # the node phase's end
            out.append(stamp(1))
        out.append(s)
        if i == loop:                     # the cycle's start
            out.append(stamp(0))
        if i == syncs[0]:                 # the arc phase's start
            out.append(stamp(2))
        if i == syncs[1]:                 # the cycle's end
            out.append(stamp(3))
    text = "\n".join(out).replace(
        "namespace {\n", "__device__ long long g_clk[256];\nnamespace {\n", 1)
    return text + ('\nextern "C" int fire_probe_clocks(long long* h) {\n'
                   '  return (int)cudaMemcpyFromSymbol(h, g_clk, '
                   'sizeof(g_clk));\n}\n')


def phase_clocks(dev) -> None:
    import torch
    from repro_torch.core import library
    from repro_torch.kernels import _build
    from repro_torch.kernels import dataflow_fire as df
    lib = build_stamped(stamped_source(), "fire_probe")
    lib.fire_probe_clocks.argtypes = [ctypes.c_void_p]
    lib.fire_probe_clocks.restype = ctypes.c_int
    _build.load = lambda: lib              # the wrappers launch the copy
    for name, graph in (("dot_prod", library.dot_product_graph(32).graph),
                        ("bubble_sort", library.bubble_sort_graph(8).graph)):
        for opt in (False, True):
            tables = df.block_plan_arrays(graph, optimize=opt)
            dt = df.device_tables(tables, dev)
            args, active = inputs(tables, 1, 4096, dev)
            for _ in range(3):
                df.launch_variant("warp", dt, *args, n_cycles=64,
                                  active=active)
            torch.cuda.synchronize()
            h = (ctypes.c_longlong * 256)()
            if lib.fire_probe_clocks(h) != 0:
                raise RuntimeError("could not read the clock stamps")
            c = np.array(h[:], dtype=np.int64).reshape(64, 4)
            print(f"{name} opt={opt}: clocks per cycle "
                  f"{np.median(np.diff(c[:, 0])):.0f} (node phase "
                  f"{np.median(c[:, 1] - c[:, 0]):.0f}, first __syncwarp "
                  f"{np.median(c[:, 2] - c[:, 1]):.0f}, arc phase and the "
                  f"second {np.median(c[:, 3] - c[:, 2]):.0f})", flush=True)


# the fire step's two kernels: (anchor, text put in its place); stamps of
# lane 0 (thread 0) into g_step[0..3] (warp variant) and g_step[4..7] (CTA
# variant): the loads issued and landed with the first barrier, the node
# phase with the second, the arc phase, the reduction and the end
STEP_STAMPS = (
    ("  const int lane = threadIdx.x;\n  // slots j < rn (ra)",
     "  const int lane = threadIdx.x;\n  const long long w0 = clock64();\n"
     "  // slots j < rn (ra)"),
    ("  __syncwarp();\n  int fired = 0;\n  auto node_pair",
     "  __syncwarp();\n  const long long w1 = clock64();\n  int fired = 0;\n"
     "  auto node_pair"),
    ("  __syncwarp();\n  arc_quad(Slots<0>{});",
     "  __syncwarp();\n  const long long w2 = clock64();\n"
     "  arc_quad(Slots<0>{});"),
    ("  fired = __reduce_add_sync(0xffffffffu, fired);\n"
     "  if (lane == 0) fired_o[0] = fired;\n}\n",
     "  const long long w3 = clock64();\n"
     "  fired = __reduce_add_sync(0xffffffffu, fired);\n"
     "  if (lane == 0) fired_o[0] = fired;\n"
     "  if (lane == 0) {\n    g_step[0] = w1 - w0; g_step[1] = w2 - w1;\n"
     "    g_step[2] = w3 - w2; g_step[3] = clock64() - w3;\n  }\n}\n"),
    ("  const int nt = blockDim.x;\n  for (int i = tid; i < A2; i += nt) "
     "s_fv[i]",
     "  const int nt = blockDim.x;\n  const long long c0 = clock64();\n"
     "  for (int i = tid; i < A2; i += nt) s_fv[i]"),
    ("  __syncthreads();\n  int nfire = 0;",
     "  __syncthreads();\n  const long long c1 = clock64();\n"
     "  int nfire = 0;"),
    ("  if ((tid & 31) == 0 && nfire) atomicAdd(&s_fired, nfire);\n"
     "  __syncthreads();\n",
     "  if ((tid & 31) == 0 && nfire) atomicAdd(&s_fired, nfire);\n"
     "  __syncthreads();\n  const long long c2 = clock64();\n"),
    ("  if (tid == 0) fired_o[0] = s_fired;\n}\n",
     "  const long long c3 = clock64();\n"
     "  if (tid == 0) fired_o[0] = s_fired;\n"
     "  if (tid == 0) {\n    g_step[4] = c1 - c0; g_step[5] = c2 - c1;\n"
     "    g_step[6] = c3 - c2; g_step[7] = clock64() - c3;\n  }\n}\n"),
)


def step_clocks(dev) -> None:
    """SM clocks per phase of both fire-step kernels on dot_prod n = 32,
    bubble_sort(8) and fibonacci, from a stamped copy of
    dataflow_fire.cu, beside each kernel's device time (the copy's and the
    product's) and the empty one-warp kernel's."""
    import torch
    from chip_smoke import empty_launch, device_ms
    from repro_torch.core import library
    from repro_torch.kernels import _build
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.testing import random_block_inputs
    clean = _build.load()
    src = (ROOT / "src/repro_torch/kernels/csrc/dataflow_fire.cu").read_text()
    for anchor, text in STEP_STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"dataflow_fire.cu changed: {anchor[:40]!r}")
        src = src.replace(anchor, text)
    src = src.replace("namespace {\n",
                      "__device__ long long g_step[8];\nnamespace {\n", 1)
    src += ('\nextern "C" int fire_step_clocks(long long* h) {\n'
            '  return (int)cudaMemcpyFromSymbol(h, g_step, sizeof(g_step));'
            '\n}\n')
    lib = build_stamped(src, "step_probe")
    lib.fire_step_clocks.argtypes = [ctypes.c_void_p]
    lib.fire_step_clocks.restype = ctypes.c_int
    kernels = {"warp": "fire_step_warp", "cta": "fire_step_kernel"}
    empty = device_ms(empty_launch(dev), 200, "fire_empty")
    print(f"empty one-warp kernel: {empty:.5f} ms", flush=True)
    for name, graph in (("dot_prod", library.dot_product_graph(32).graph),
                        ("bubble_sort", library.bubble_sort_graph(8).graph),
                        ("fibonacci", library.fibonacci_graph().graph)):
        tables = df.block_plan_arrays(graph)
        dt = df.device_tables(tables, dev)
        x = random_block_inputs(tables, 1, 1, np.random.default_rng(3))
        full = torch.tensor(x["full"][0], device=dev)
        val = torch.tensor(x["val"][0], device=dev)
        for v in df.STEP_VARIANTS:
            run = lambda: df.launch_step_variant(v, dt, full, val)
            _build.load = lambda: clean
            ms = device_ms(run, 200, kernels[v])
            _build.load = lambda: lib
            ms_stamped = device_ms(run, 200, kernels[v])
            torch.cuda.synchronize()
            h = (ctypes.c_longlong * 8)()
            if lib.fire_step_clocks(h) != 0:
                raise RuntimeError("could not read the clock stamps")
            c = h[:4] if v == "warp" else h[4:]
            print(f"{name} (N2={dt['opcode'].shape[0]}, "
                  f"A2={dt['prod_node'].shape[0]}) fire step, {v}: "
                  f"{ms:.5f} ms ({ms_stamped:.5f} stamped); SM clocks: loads "
                  f"landed and the first barrier {c[0]}, node phase and the "
                  f"second {c[1]}, arc phase {c[2]}, reduction and end "
                  f"{c[3]}", flush=True)
    _build.load = lambda: clean


def build_stamped(src: str, tag: str) -> ctypes.CDLL:
    """The kernel library with dataflow_fire.cu replaced by ``src``,
    built into ``build/probe/``."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    for f in (*_build.SOURCES, *_build.HEADERS):
        (out / f.name).write_text(f.read_text())
    (out / "dataflow_fire.cu").write_text(src)
    nvcc = _build._nvcc()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o",
                               str(out / f"{f.stem}.o"), str(out / f.name)],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
             for f in _build.SOURCES]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed on the stamped sources")
    subprocess.run([nvcc, "-shared", "-o", str(out / f"{tag}.so"),
                    *(str(out / f"{f.stem}.o") for f in _build.SOURCES)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / f"{tag}.so"))
    _build._bind(lib)
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fire_block_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    print(card_line(), flush=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--step", action="store_true",
                    help="time and stamp the fire step's two kernels only")
    dev = torch.device("cuda")
    if ap.parse_args().step:
        step_clocks(dev)
        return 0
    k_scaling(dev)
    phase_clocks(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
