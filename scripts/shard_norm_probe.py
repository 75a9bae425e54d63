#!/usr/bin/env python3
"""Times of the sharded block (row 11) and of RMSNorm's backward (row 14)
on one NVIDIA card, without the rest of ``chip_smoke.py``.

    python3 scripts/shard_norm_probe.py [--rows shard,norm] [--out FILE]

It times, through ``chip_smoke.py``'s own helpers:

1. row 11 at phase 5d's captured states (dot_prod n = 32, 1024 slots, K =
   64, the first 1024 of 2048 requests after 8 heartbeats; P = 2 and 4,
   dense and optimized+profiled): each variant's device ms a block and
   µs a cycle at B = 1024 and on the first active stream alone (B = 1),
   beside row 3's µs a cycle on the unsharded state (``time_mf``,
   ``time_block``);
2. row 14, model rounding, bf16, at [4096, 2048] and [512, 2048]: the
   backward kernel and its reduction (profiler), a wrapper call, the
   plain version, the backward of ``F.rms_norm`` (CUDA-graph replay) and
   the bound, and the rows kernel at every other built shape that holds
   the row (``time_rmsnorm_bwd``).

The card warms up for 3 s first.  Prints one line a measurement and
writes them all as JSON to ``--out`` (default
``build/shard_norm_probe.json``).
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def shard(cs, dev, out):
    from repro_torch.core import library
    from repro_torch.serve.dataflow_server import DataflowServer
    dot = library.dot_product_graph(32)
    reqs, _ = cs.serving_workload("dot_prod", dot, 2048, seed=0)
    st = cs.captured_state(dev, dot.graph, reqs, 1024)
    row3 = cs.time_block(st, st["tables"], None, True)
    out["row3_us_per_cycle"] = row3["us_per_cycle"]
    print(f"row 3: {row3['us_per_cycle']:.3f} µs/cycle", flush=True)
    del st
    for P in (2, 4):
        for opt in (False, True):
            srv = DataflowServer(dot.graph, slots=1024, block_cycles=64,
                                 device=dev, optimize=opt, profile=opt,
                                 partition=P)
            for r in reqs[:1024]:
                srv.submit(r)
            for _ in range(8):
                srv.step()
            t = cs.time_mf(cs.copy_slot_state(srv))
            out[f"P{P}/opt={opt}"] = t
            print(f"row 11 P={P} optimize+profile={opt} ({t['variant']}): "
                  + json.dumps(t["by_variant"]) + f"; bound "
                  f"{t['bound_ms']:.6f} ms", flush=True)
            del srv


def norm(cs, dev, out):
    import torch
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=dev).manual_seed(25)
    for rows in (4096, 512):
        x = (3 * torch.randn((rows, 2048), generator=gen,
                             device=dev)).bfloat16()
        dy = torch.randn((rows, 2048), generator=gen, device=dev).bfloat16()
        w = 1 + 0.3 * torch.randn((2048,), generator=gen, device=dev)
        nv = 2048 // 8
        own = rn.rows_shape(2048, 2)
        others = [s for s in rn.ROWS_SHAPES
                  if s != own and nv <= 32 * s[0] * s[1]]
        t = cs.time_rmsnorm_bwd(x, w, dy, others)
        out[f"rmsnorm_bwd {rows}"] = t
        print(f"row 14 [{rows}, 2048]: " + json.dumps(
            {k: t[k] for k in ("ms", "bwd_kernel_ms", "reduce_kernel_ms",
                               "call_ms", "library_ms", "bound_ms", "plan",
                               "forced_shapes_ms")}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="shard,norm")
    ap.add_argument("--out", default="build/shard_norm_probe.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("shard_norm_probe: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.load()
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.time()
    while time.time() - t0 < 3:
        a @ a
    torch.cuda.synchronize()
    out = {"card": cs.card_line()}
    rows = args.rows.split(",")
    if "shard" in rows:
        shard(cs, dev, out)
    if "norm" in rows:
        norm(cs, dev, out)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(cs.card_line())


if __name__ == "__main__":
    main()
