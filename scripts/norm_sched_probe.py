#!/usr/bin/env python3
"""Times of RMSNorm (Pallas row 10), the static-schedule kernels (rows
7-8) and the fire step (row 6) of one checkout's port, on one NVIDIA card.

    python3 scripts/norm_sched_probe.py [--src DIR] [--tag NAME]
                                        [--rows norm,sched,step]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's; give an unpacked older checkout's to compare two
versions on one card: run them in turns, old, new, new, old).  Through
the public wrappers only, so any version of the port since rows 7-10
exist can be timed; the timing helpers are this checkout's
``chip_smoke.py``.  It times:

1. RMSNorm, model rounding, bf16, weight f32, beside ``F.rms_norm`` on the
   same inputs: at [14812, 2048] (the long wave's prefill) with a cold L2
   (CUDA events per call after a 256 MB write; the kernel, the library
   and, where the port has variants, each variant in turns, medians) and
   warm (profiler); at [4, 2048] (a decode step) from CUDA events over
   replays of a CUDA graph holding one call on each of 4 input sets, and
   with a cold L2 per call (kernel and library in turns);
2. the scheduled run over dot_prod n = 32 at full width (B = 1024 streams
   of 4096 tokens, 8,197 cycles) and at the phase-4 shape of
   ``chip_smoke.py`` (B = 8 streams of 9 tokens), profiler device time,
   through the wrapper and, where the port has them, in each variant
   (the warp one on 1 and 2 warps a stream, and with windows of 16 and 8
   tokens) and its latency floor (``sched_floor_cuda``);
3. the scheduled slot step on random slot states (B = 1024, K = 64, L =
   256), profiler device time, and at the scheduled serving state of
   ``chip_smoke.py`` (dot_prod n = 32, 1024 slots after 8 heartbeats of
   2048 requests of 256..4096 tokens, K = 64): device time and time per
   wrapper call, and where the port has them each variant and the floor
   (``sched_slot_floor_cuda``);
4. the fire step on a random state of dot_prod n = 32: device time and
   time per wrapper call (through ``make_fire_step``, as ``run_fabric``
   calls it), and where the port has them each variant and the floor (an
   empty one-warp kernel).

``--rows`` picks which of RMSNorm (``norm``), the schedule kernels
(``sched``) and the fire step (``step``) are timed.

The card is kept busy for 3 s before the first timing.  Prints the
card's name and power limit, then one JSON object per line,
the last ``{"probe": ...}``, also written to
``build/probe/probe_<tag>.json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def norm_times(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from chip_smoke import cold_turns_ms, cuda_ms, device_ms, graph_ms
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    d = 2048
    x = (3 * torch.randn((14812, d), generator=gen, device=dev)).bfloat16()
    w = 1 + 0.3 * torch.randn((d,), generator=gen, device=dev)
    wc = w.bfloat16()
    run_k = lambda: rn.rmsnorm_cuda(x, w, model=True)
    run_l = lambda: F.rms_norm(x, (d,), wc, eps=1e-5)
    err = float((run_k().float() - rn.rmsnorm(x, w, model=True).float())
                .abs().max())
    turns = dict(kernel=run_k, library=run_l)
    if hasattr(rn, "launch_norm_variant"):
        for v in rn.VARIANTS:
            turns[v] = lambda v=v: rn.launch_norm_variant(v, x, w, model=True)
    cold = cold_turns_ms(turns, 20, flush)
    out["prefill"] = dict(
        shape=[14812, d], max_abs_err=err,
        cold_ms=cold.pop("kernel"), library_cold_ms=cold.pop("library"),
        warm_ms=device_ms(run_k, 20, "rmsnorm"),
        library_warm_ms=device_ms(run_l, 20),
        call_ms=cuda_ms(run_k, 20),
        **{f"{v}_cold_ms": ms for v, ms in cold.items()})
    if hasattr(rn, "launch_norm_variant"):
        for v in rn.VARIANTS:
            run_v = lambda: rn.launch_norm_variant(v, x, w, model=True)
            out["prefill"][f"{v}_warm_ms"] = device_ms(run_v, 20, "rmsnorm")
    sets = [((3 * torch.randn((4, 1, d), generator=gen, device=dev))
             .bfloat16(), 1 + 0.3 * torch.randn((d,), generator=gen,
                                                device=dev))
            for _ in range(4)]
    kern = [lambda s=s: rn.rmsnorm_cuda(s[0], s[1], model=True)
            for s in sets]
    libs = [lambda s=s, c=s[1].bfloat16(): F.rms_norm(s[0], (d,), c,
                                                      eps=1e-5)
            for s in sets]
    cold = cold_turns_ms(dict(kernel=kern[0], library=libs[0]), 50, flush)
    out["decode"] = dict(
        shape=[4, 1, d], graph_ms=graph_ms(kern, 50),
        library_graph_ms=graph_ms(libs, 50),
        cold_ms=cold["kernel"], library_cold_ms=cold["library"],
        call_ms=cuda_ms(kern[0], 50))
    by = getattr(rn.rmsnorm_cuda, "launches_by", None)
    out["launches_by"] = dict(by) if by is not None else None
    return out


def sched_times(dev) -> dict:
    import torch
    from chip_smoke import cuda_ms, device_ms
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine
    from repro_torch.kernels import schedule_fire as ksf
    from repro_torch.testing import STATE_KEYS, random_sched_slot_inputs
    g = library.dot_product_graph(32).graph
    ctx = DataflowEngine(g, device=dev, schedule=True)._sched_ctx()
    n_in = len(ctx.in_arc)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for key, B, L, reps in (("full", 1024, 4096, 10), ("phase4", 8, 9, 50)):
        plan = ctx.plan_for((L,) * n_in)
        plan.ensure(1 << 20)
        program = ksf.flat_program(*plan.trace_struct(plan.total))
        tabs = ksf.device_sched_tables(ctx, dev)
        fv = torch.randint(0, 9, (B, ctx.ia_pad.size, L), generator=gen,
                           device=dev, dtype=torch.int32)
        run = lambda: ksf.sched_run_cuda(tabs, program, fv)
        ms = device_ms(run, reps, "sched_run")
        out[key] = dict(B=B, L=L, cycles=plan.total, ms=ms,
                        us_per_cycle=ms * 1e3 / plan.total,
                        call_ms=cuda_ms(run, reps))
        if hasattr(ksf, "launch_sched_variant"):
            # each variant of the run kernel, the warp one on 1 and 2
            # warps a stream and with shorter windows
            for v, kw in (("cta", {}), ("warp", dict(warps=1)),
                          ("warp", dict(warps=2)),
                          ("warp", dict(warps=2, window=16)),
                          ("warp", dict(warps=2, window=8))):
                run = lambda: ksf.launch_sched_variant(v, tabs, program, fv,
                                                       **kw)
                ms = device_ms(run, reps, "sched_run")
                tag = v + "".join(f" {k}={x}" for k, x in kw.items())
                out[key][tag] = ms
        if hasattr(ksf, "sched_floor_cuda"):
            run = lambda: ksf.sched_floor_cuda(tabs, program, fv)
            ms = device_ms(run, reps, "sched_run")
            out[key]["floor_ms"] = ms
            out[key]["floor_us_per_cycle"] = ms * 1e3 / plan.total
    x = random_sched_slot_inputs(ctx, 1024, 64, 256,
                                 np.random.default_rng(0))
    tabs = ksf.device_sched_tables(ctx, dev)
    t = {k: torch.tensor(x[k], device=dev) for k in ("fv", *STATE_KEYS)}
    args = (t["fv"], x["pids"], x["fsel"], *(t[k] for k in STATE_KEYS))
    run = lambda: ksf.sched_slot_step_cuda(tabs, *args)
    got = run()
    same = all(torch.equal(a, b) for a, b in
               zip(got, ksf.sched_slot_step(tabs, *args)))
    out["slot_step"] = dict(
        B=1024, K=64, L=256, equal_to_plain=same,
        ms=device_ms(run, 20, "sched_slot"))
    out["slot_serving"] = slot_serving_times(dev)
    by = getattr(ksf.sched_run_cuda, "launches_by", None)
    out["launches_by"] = dict(by) if by is not None else None
    return out


def slot_serving_state(dev):
    """The scheduled serving state of ``chip_smoke.py``: dot_prod n = 32,
    1024 slots after 8 heartbeats of 2048 requests of 256..4096 tokens,
    and the next block's pid windows (K = 64).  Returns (tables, the slot
    step's arguments, the slot state, the schedule context)."""
    from chip_smoke import serving_workload
    from repro_torch.core import library
    from repro_torch.kernels import schedule_fire as ksf
    from repro_torch.serve.dataflow_server import DataflowServer
    dot = library.dot_product_graph(32)
    reqs, _ = serving_workload("dot_prod", dot, 2048, seed=0)
    srv = DataflowServer(dot.graph, slots=1024, block_cycles=64,
                         device=dev, optimize=True, profile=True,
                         schedule=True)
    for r in reqs[:1024]:
        srv.submit(r)
    for _ in range(8):
        srv.step()
    st, ctx, K = srv.state, srv.engine._sched_ctx(), 64
    pids = np.zeros((st.slots, K), np.int32)
    fsel = np.full((st.slots,), -1, np.int32)
    for b in np.nonzero(st.active)[0]:
        plan, pos = st.sched.plans[b], int(st.sched.pos[b])
        plan.ensure(pos + K)
        pids[b] = plan.pids_window(pos, pos + K)
        fsel[b] = pids[b, -1]
    tabs = ksf.device_sched_tables(ctx, dev)
    args = (st.fv, pids, fsel, st.full, st.val, st.ptr, st.out_last,
            st.out_count)
    return tabs, args, st, ctx


def slot_serving_times(dev) -> dict:
    """Row 8 at the scheduled serving state (see the module's 3.)."""
    import torch
    from chip_smoke import cuda_ms, device_ms
    from repro_torch.kernels import schedule_fire as ksf
    tabs, args, st, ctx = slot_serving_state(dev)
    K = args[1].shape[1]
    want = ksf.sched_slot_step(tabs, *args)
    run = lambda: ksf.sched_slot_step_cuda(tabs, *args)
    same = all(torch.equal(a, b) for a, b in zip(run(), want))
    out = dict(B=st.slots, K=K, active=int(st.active.sum()),
               patterns=len(ctx.registry), equal_to_plain=same,
               ms=device_ms(run, 20, "sched_slot"),
               call_ms=cuda_ms(run, 200))
    if hasattr(ksf, "launch_slot_variant"):
        for v in ksf.SLOT_VARIANTS:
            run = lambda: ksf.launch_slot_variant(v, tabs, *args)
            out["equal_to_plain"] &= all(torch.equal(a, b) for a, b in
                                         zip(run(), want))
            out[f"{v}_ms"] = device_ms(run, 20, "sched_slot")
            out[f"{v}_call_ms"] = cuda_ms(run, 20)
        b0 = int(np.nonzero(st.active)[0][0])
        one = [x[b0:b0 + 1] for x in args]
        run = lambda: ksf.sched_slot_floor_cuda(tabs, *one)
        out["floor_ms"] = device_ms(run, 20, "sched_slot")
    return out


def step_times(dev) -> dict:
    """Row 6 (see the module's 4.)."""
    import ctypes
    import torch
    from chip_smoke import cuda_ms, device_ms
    from repro_torch.core import library
    from repro_torch.kernels import _build
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.kernels import ops
    from repro_torch.testing import random_block_inputs
    tables, step = ops.make_fire_step(library.dot_product_graph(32).graph,
                                      dev)
    dt = df.device_tables(tables, dev)
    x = random_block_inputs(tables, 1, 1, np.random.default_rng(3))
    full = torch.tensor(x["full"][0], device=dev)
    val = torch.tensor(x["val"][0], device=dev)
    run = lambda: step(full, val)
    out = dict(ms=device_ms(run, 200, "fire_step"),
               call_ms=cuda_ms(run, 200))
    if hasattr(df, "launch_step_variant"):
        for v in df.STEP_VARIANTS:
            run = lambda: df.launch_step_variant(v, dt, full, val)
            out[f"{v}_ms"] = device_ms(run, 200, "fire_step")
            out[f"{v}_call_ms"] = cuda_ms(run, 200)
        lib = _build.load()
        run = lambda: lib.fire_empty_launch(ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream))
        out["floor_ms"] = device_ms(run, 200, "fire_empty")
    return out


def warm_up(dev, seconds: float = 3.0) -> None:
    """Keep the card busy for a few seconds before any timing: a fresh
    process otherwise times its first kernels at lower clocks."""
    import time
    import torch
    a = torch.randn((4096, 4096), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--rows", default="norm,sched,step")
    a = ap.parse_args()
    rows = set(a.rows.split(","))
    import torch
    if not torch.cuda.is_available():
        print("norm_sched_probe: no CUDA device", file=sys.stderr)
        return 1
    # chip_smoke puts this checkout's src first on the path when imported:
    # import it before putting the timed src in front of it
    from chip_smoke import card_line
    sys.path.insert(0, str(pathlib.Path(a.src).resolve()))
    import repro_torch
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    warm_up(dev)
    res = dict(tag=a.tag, src=str(pathlib.Path(repro_torch.__file__)
                                  .resolve().parents[1]),
               card=card_line())
    for key, fn in (("norm", norm_times), ("sched", sched_times),
                    ("step", step_times)):
        if key in rows:
            res[key] = fn(dev)
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"probe_{a.tag}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({"probe": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
