#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero; no phase is caught and skipped):

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds the fire-block kernel from ``src/`` into
             ``build/``; prints the time and the ``-Xptxas -v`` report;
3. kernel  — the kernel against its plain PyTorch version on the card,
             bit for bit (7 benches, B = 64 with parked slots,
             K in {1, 16, 64}; and both serving states the main path
             gives it: dot_prod at B = 1024, L = 4096 and bubble_sort(8)
             at B = 256, K = 64, with the B = 1 slice of each); random
             graphs fed int32 edge operands against the numpy oracle;
             kernel and plain times at the dot_prod serving shapes;
4. engine  — ``DataflowEngine.run`` / ``run_batch`` on the card against
             ``run_reference``, every EngineResult field, 7 benches;
5. serving — ``DataflowServer(slots=1024, block_cycles=64)`` on the
             paper's dot-product fabric at n = 32: 2048 requests of
             256..4096 tokens; then bubble_sort(8) at 256 slots.  The
             launch counts are read here; 16 sampled results per
             deployment are then checked against ``run_reference`` and
             a solo ``run`` (those runs are not counted);
6. trace   — the dot_prod serving run again under ``torch.profiler``
             (CPU and CUDA): the device's busy time and idle share;
7. summary — the ``kernels`` JSON line, the card, and the result line.

The launch counts in the summary come from phases 4 and 5 (the main
path) alone: every count is set to 0 just before phase 4 and read
before the sampled checks.  The script imports torch, numpy and the
port; nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
SCALAR_OPS_PER_S = 67e12     # H100 SXM 32-bit rate outside the tensor cores
SOURCE = "src/repro_torch/kernels/csrc/dataflow_fire.cu"


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiled_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Mean device milliseconds per fn() from torch.profiler: the time of
    the kernels whose name holds ``kernel`` (all kernels if None); 0.0
    when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if kernel is None or kernel in e.key:
            us += getattr(e, "device_time_total", None) or 0.0
    return us / reps / 1e3


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def random_graph(seed: int):
    """A random well-formed acyclic fabric over the whole opcode set,
    reading environment streams, open producer outputs and const buses
    holding int32 edge values."""
    from repro_torch.core.graph import ARITY, Graph, Op
    from repro_torch.testing import EDGE_VALS
    rng = np.random.default_rng(5000 + seed)
    g = Graph(name=f"random{seed}")
    open_arcs: list[str] = []
    n = {"a": 0, "x": 0, "c": 0}

    def fresh(tag):
        n[tag] += 1
        return f"{tag}{n[tag]}"

    def src(first):
        r = rng.random()
        if first:
            return fresh("x")
        if open_arcs and r < 0.55:
            return open_arcs.pop(int(rng.integers(len(open_arcs))))
        if r < 0.75:
            return g.const(fresh("c"), int(rng.choice(EDGE_VALS)))
        return fresh("x")

    ops = list(Op)
    for i in range(int(rng.integers(6, 14))):
        op = ops[seed % len(ops)] if i == 0 else ops[rng.integers(len(ops))]
        n_in, n_out = ARITY[op]
        ins = [src(i == 0 and k == 0) for k in range(n_in)]
        outs = [fresh("a") for _ in range(n_out)]
        g.add(op, ins, outs)
        open_arcs.extend(outs)
    if not open_arcs:
        g.add(Op.ADD, [fresh("x"), g.const(fresh("c"), 1)], ["z_out"])
    g.validate()
    return g


def serving_workload(name, bench, n_req, seed, max_len=4096):
    """n_req requests with stream lengths log-uniform in [256, max_len];
    every 16th carries a 500-cycle budget."""
    from repro_torch.core import library
    from repro_torch.serve.types import Request
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(np.log(256), np.log(max_len),
                              n_req)).astype(int)
    reqs = []
    for i, k in enumerate(lens):
        feeds = {a: np.asarray(v, np.int32) for a, v in
                 library.random_feeds(name, bench, int(k), rng).items()}
        reqs.append(Request(uid=i + 1, feeds=feeds,
                            max_cycles=500 if i % 16 == 15 else None))
    return reqs, lens


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_kernel(dev):
    """Kernel vs plain on random mid-run states, and random graphs fed
    edge operands vs the oracle.  Returns each entry's max |error|."""
    import torch
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine, run_reference
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.testing import (EDGE_VALS, STATE_KEYS,
                                     assert_same_result, random_block_inputs)
    err = {"fire_block": 0, "fire_block_batched": 0}
    for name, build in library.BENCHES.items():
        tables = df.block_plan_arrays(build().graph)
        dt = df.device_tables(tables, dev)
        rng = np.random.default_rng(len(name))
        x = {k: torch.tensor(v, device=dev) for k, v in
             random_block_inputs(tables, 64, 96, rng).items()}
        args = [x["feed_vals"], x["feed_len"], *(x[k] for k in STATE_KEYS)]
        for K in (1, 16, 64):
            got = df.fire_block_batched_cuda(dt, *args, n_cycles=K,
                                             active=x["active"])
            want = df.fire_block_batched(dt, *args, n_cycles=K,
                                         active=x["active"])
            e = max_abs_err(got, want)
            err["fire_block_batched"] = max(err["fire_block_batched"], e)
            check(e == 0, f"batched kernel != plain: {name} K={K}")
            check(int(want[5].sum()) > 0, f"nothing fired: {name} K={K}")
            one = [a[0] for a in args]
            e = max_abs_err(df.fire_block_cuda(dt, *one, n_cycles=K),
                            df.fire_block(dt, *one, n_cycles=K))
            err["fire_block"] = max(err["fire_block"], e)
            check(e == 0, f"single kernel != plain: {name} K={K}")
        log(f"  {name:12s} kernel == plain at B=64, K=1/16/64 "
            f"({int(x['active'].sum())} active)")
    n_cases = 0
    for seed in range(24):
        g = random_graph(seed)
        rng = np.random.default_rng(seed)
        feeds = [{a: rng.choice(EDGE_VALS, 1 + (s + seed) % 5)
                  .astype(np.int32) for a in g.input_arcs()}
                 for s in range(4)]
        wants = [run_reference(g, f, max_cycles=192) for f in feeds]
        eng = DataflowEngine(g, block_cycles=4 + seed % 3 * 6,
                             max_cycles=192, device=dev)
        for f, w in zip(feeds, wants):
            assert_same_result(eng.run(f), w, g.name, dispatches=False)
        for got, w in zip(eng.run_batch(feeds), wants):
            assert_same_result(got, w, g.name, dispatches=False)
        n_cases += len(feeds)
    log(f"  {n_cases} random-graph runs (edge operands) == run_reference")
    return err


def captured_state(dev, graph, reqs, slots, blocks=8):
    """The serving state after ``blocks`` heartbeats of a throwaway
    server over the first ``slots`` requests: the inputs the main path
    gives the kernel, taken outside it so its launch counts stay clean."""
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.serve.dataflow_server import DataflowServer
    srv = DataflowServer(graph, slots=slots, block_cycles=64, device=dev)
    for r in reqs[:slots]:
        srv.submit(r)
    for _ in range(blocks):
        srv.step()
    st = srv.state
    active = st.active_dev
    check(int(active.sum()) > 0, f"{graph.name}: no slot still active")
    return dict(tables=df.device_tables(df.block_plan_arrays(graph), dev),
                K=64, fv=st.fv, fl=st.fl, active=active,
                one=int(active.nonzero()[0]),        # first active slot
                state=[st.full, st.val, st.ptr, st.out_last, st.out_count])


def kernel_vs_plain(st) -> dict:
    """Both entries against their plain versions on a captured serving
    state, bit for bit: the batched one at the full slot count, the
    single one on the first active slot's row.  Returns each entry's
    max |error|."""
    from repro_torch.kernels import dataflow_fire as df
    tables, K, act = st["tables"], st["K"], st["active"]
    args = [st["fv"], st["fl"], *st["state"]]
    want = df.fire_block_batched(tables, *args, n_cycles=K, active=act)
    err = {"fire_block_batched": max_abs_err(
        df.fire_block_batched_cuda(tables, *args, n_cycles=K, active=act),
        want)}
    check(int(want[5].sum()) > 0, "nothing fired in the captured state")
    one = [a[st["one"]].contiguous() for a in args]
    err["fire_block"] = max_abs_err(df.fire_block_cuda(tables, *one,
                                                       n_cycles=K),
                                    df.fire_block(tables, *one, n_cycles=K))
    for k, e in err.items():
        check(e == 0, f"{k} kernel != plain on the serving state")
    return err


def time_kernels(st):
    """CUDA-event times of both entries and their plain versions on a
    captured mid-run serving state (dot_prod, B = 1024, K = 64), with
    the least time the card could take for the same work."""
    import torch
    from repro_torch.kernels import dataflow_fire as df
    tables, K = st["tables"], st["K"]
    state = st["state"]
    B, A2 = state[0].shape
    n_in, n_out = state[2].shape[1], state[3].shape[1]
    N2 = tables["opcode"].shape[0]
    table_bytes = sum(t.numel() * 4 for t in tables.values())

    def bound(rows, active_rows, args, out):
        tokens = int((out[2] - args[4]).sum())       # feed tokens consumed
        nbytes = (table_bytes + 4 * rows * (2 * (2 * A2 + n_in + 2 * n_out)
                                            + n_in + 2 + 1) + 4 * tokens)
        ops = active_rows * K * (N2 + A2 + n_in + n_out)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
                nbytes, tokens)

    def timed(run_k, run_p, reps):
        """Kernel device time (profiler; CUDA events per call when the
        profiler sees no device time), per-call times with events, and
        the plain version's per-call and summed device times."""
        dev_ms = profiled_ms(run_k, reps, "fire_block_kernel")
        call_ms = cuda_ms(run_k, reps)
        return dict(ms=dev_ms or call_ms,
                    ms_from="profiler" if dev_ms else "cuda events",
                    call_ms=call_ms, plain_ms=cuda_ms(run_p, 3, warmup=1),
                    plain_device_ms=profiled_ms(run_p, 2))

    out = {}
    args = [st["fv"], st["fl"], *state]
    act = st["active"]
    run_k = lambda: df.fire_block_batched_cuda(tables, *args, n_cycles=K,
                                               active=act)
    run_p = lambda: df.fire_block_batched(tables, *args, n_cycles=K,
                                          active=act)
    b_ms, b_by, nbytes, tokens = bound(B, int(act.sum()), args, run_k())
    out["fire_block_batched"] = dict(
        **timed(run_k, run_p, 20),
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes, tokens=tokens,
        shape=f"B={B} slots ({int(act.sum())} active), K={K}, "
              f"L={args[0].shape[2]}, N2={N2}, A2={A2}, n_in={n_in}")
    b1 = st["one"]
    one = [a[b1].contiguous() for a in args]
    run_k1 = lambda: df.fire_block_cuda(tables, *one, n_cycles=K)
    run_p1 = lambda: df.fire_block(tables, *one, n_cycles=K)
    r = [x[None] for x in run_k1()]
    b_ms, b_by, nbytes, tokens = bound(1, 1, [a[b1:b1 + 1] for a in args],
                                       r)
    out["fire_block"] = dict(
        **timed(run_k1, run_p1, 50),
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes, tokens=tokens,
        shape=f"B=1, K={K}, L={one[0].shape[1]}")
    for k, v in out.items():
        log(f"  {k:18s} kernel {v['ms']:.4f} ms ({v['ms_from']}; "
            f"{v['call_ms']:.4f} ms per wrapper call)  plain "
            f"{v['plain_ms']:.3f} ms per call ({v['plain_device_ms']:.3f} "
            f"ms on the device)  bound {v['bound_ms']:.5f} ms "
            f"({v['bound_by']}: {v['bytes']} B, {v['tokens']} feed tokens)"
            f"  [{v['shape']}]")
    return out


def phase_engine(dev):
    from repro_torch.core import library
    from repro_torch.core.engine import DataflowEngine, run_reference
    from repro_torch.testing import assert_same_result
    for name, build in library.BENCHES.items():
        bench = build()
        feeds = [library.random_feeds(name, bench, 1 + 3 * b,
                                      np.random.default_rng(b))
                 for b in range(8)]
        wants = [run_reference(bench.graph, f) for f in feeds]
        for K in (1, 16):
            eng = DataflowEngine(bench.graph, block_cycles=K, device=dev)
            for f, w in zip(feeds, wants):
                assert_same_result(eng.run(f), w, (name, K),
                                   dispatches=False)
            got = eng.run_batch(feeds)
            for g, w in zip(got, wants):
                assert_same_result(g, w, (name, K, "batch"),
                                   dispatches=False)
        log(f"  {name:12s} run + run_batch(B=8) == run_reference, K=1/16")


def time_slot_api(engine) -> dict:
    """Wrap the engine's slot-API methods with wall-clock accumulators
    (seconds per method; step_block ends in its one device sync, so its
    time includes the kernel).  Returns the live totals."""
    totals = {}
    for k in ("reset_slots", "step_block", "harvest"):
        fn = getattr(engine, k)
        totals[k] = 0.0

        def timed(*a, _fn=fn, _k=k, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                totals[_k] += time.perf_counter() - t
        setattr(engine, k, timed)
    return totals


def expected_last(name, bench, feeds):
    """Bench.reference on a request's last input vector: the last value
    each output arc must drain."""
    if name == "dot_prod":
        a = np.stack([feeds[f"a{i}"][-1:] for i in range(32)], 1)
        b = np.stack([feeds[f"b{i}"][-1:] for i in range(32)], 1)
        return np.atleast_1d(bench.reference(a, b)[-1])
    v = np.stack([feeds[f"x{i}"][-1:] for i in range(8)], 1)
    return bench.reference(v)[-1]


def phase_serving(dev, name, bench, slots, reqs, lens):
    """Serve the workload; check every result against Bench.reference;
    return the stats, the results sorted by uid and the server's cap."""
    import torch
    from repro_torch.core import library
    from repro_torch.kernels import dataflow_fire as df
    from repro_torch.serve.dataflow_server import DataflowServer
    torch.cuda.reset_peak_memory_stats()
    srv = DataflowServer(bench.graph, slots=slots, block_cycles=64,
                         device=dev)
    host_s = time_slot_api(srv.engine)
    launches0 = df.fire_block_batched_cuda.launches
    half = len(reqs) // 2
    t0 = time.perf_counter()
    for r in reqs[:half]:
        srv.submit(r)
    results = []
    for _ in range(8):
        results += srv.step()
    for r in reqs[half:]:
        srv.submit(r)
    results += srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in list(vars(srv.engine)):
        if k in host_s:
            delattr(srv.engine, k)          # back to the plain methods
    launches = df.fire_block_batched_cuda.launches - launches0
    check(len(results) == len(reqs), "a request got no result")
    results.sort(key=lambda r: r.uid)
    out_arcs = bench.out_arcs or [bench.out_arc]
    truncated = []
    for r, req, k in zip(results, reqs, lens):
        check(r.uid == req.uid and r.error is None, f"request {r.uid}")
        if req.max_cycles is not None:
            check(r.status == "truncated" and r.engine.cycles == 500,
                  f"request {r.uid} should truncate at 500 cycles")
            truncated.append(r.uid)
            continue
        check(r.status == "ok", f"request {r.uid}: {r.status}")
        last = expected_last(name, bench, req.feeds)
        for i, a in enumerate(out_arcs):
            check(r.engine.counts[a] == library.tokens_out(name, int(k)),
                  f"request {r.uid}: {a} count")
            check(int(r.engine.outputs[a]) == int(last[i]),
                  f"request {r.uid}: {a} value")
    check(srv.block <= launches,
          f"{srv.block} server blocks but {launches} kernel launches")
    res = np.array([r.metrics.residency_blocks for r in results])
    stats = dict(requests=len(reqs), slots=slots, blocks=srv.block,
                 launches=launches, wall_s=wall, req_per_s=len(reqs) / wall,
                 tokens=int(lens.sum()), truncated=len(truncated),
                 residency_p50=float(np.percentile(res, 50)),
                 residency_p99=float(np.percentile(res, 99)),
                 launches_per_request=launches / len(reqs),
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 seconds_in={k: round(v, 4) for k, v in host_s.items()},
                 card=card_line())
    log(f"  {bench.graph.name}: {json.dumps(stats)}")
    return stats, results, srv.max_cycles


def check_sampled(dev, bench, reqs, results, max_cycles):
    """16 sampled results (4 truncated) against ``run_reference`` and a
    solo ``DataflowEngine.run`` in every EngineResult field."""
    from repro_torch.core.engine import DataflowEngine, run_reference
    from repro_torch.testing import assert_same_result
    rng = np.random.default_rng(1)
    truncated = [r.uid for r in reqs if r.max_cycles is not None]
    done = [r.uid for r in reqs if r.max_cycles is None]
    sample = list(rng.choice(truncated, min(4, len(truncated)),
                             replace=False)) + list(
        rng.choice(done, min(12, len(done)), replace=False))
    solo = DataflowEngine(bench.graph, block_cycles=64, device=dev)
    t_ref = time.perf_counter()
    for uid in sample:
        req, r = reqs[uid - 1], results[uid - 1]
        cap = req.max_cycles or max_cycles
        assert_same_result(r.engine, run_reference(bench.graph, req.feeds,
                                                   max_cycles=cap),
                           ("sample", uid), dispatches=False)
        # a served request may ride more, shorter blocks than its solo
        # run (a neighbour's budget shortens a heartbeat's block), so
        # the launch counts differ by design; every other field agrees
        assert_same_result(r.engine, solo.run(req.feeds, max_cycles=cap),
                           ("solo", uid), dispatches=False)
    log(f"  {bench.graph.name}: {len(sample)} sampled results == "
        f"run_reference and solo run ({time.perf_counter() - t_ref:.1f} s)")


def device_busy_us(prof) -> tuple[float, dict]:
    """Microseconds in which the card ran anything (union of the device
    events' intervals in a torch.profiler trace), and device time per
    event name."""
    from torch.autograd import DeviceType
    spans, per = [], {}
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, per


def trace_serving(dev, bench, slots, reqs, untraced_wall):
    """Serve the workload again under torch.profiler (CPU and CUDA
    activities): the card's busy time, its idle share of the traced
    wall time, and what the tracing cost in wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.dataflow_server import DataflowServer
    srv = DataflowServer(bench.graph, slots=slots, block_cycles=64,
                         device=dev)
    half = len(reqs) // 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs[:half]:
            srv.submit(r)
        n = 0
        for _ in range(8):
            n += len(srv.step())
        for r in reqs[half:]:
            srv.submit(r)
        n += len(srv.drain())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(n == len(reqs), "the traced run lost a request")
    busy_us, per = device_busy_us(prof)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    out = dict(traced_wall_s=wall, untraced_wall_s=untraced_wall,
               device_busy_s=busy_us / 1e6,
               idle_share=(1 - busy_us / 1e6 / wall) if busy_us else None,
               device_s_by_name={k: v / 1e6 for k, v in top})
    log(f"  {bench.graph.name}: {json.dumps(out)}")
    if not busy_us:
        log("  the profiler recorded no device events: idle share not "
            "measured")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    from repro_torch.core import library
    from repro_torch.kernels import _build
    from repro_torch.kernels import dataflow_fire as df
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("== phase 1: device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    log("== phase 2: build")
    lib = _build.load()
    log(f"  nvcc built {_build.SOURCE.name} in {lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  " + line.strip())

    dot = library.dot_product_graph(32)
    dot_reqs, dot_lens = serving_workload("dot_prod", dot, 2048, seed=0)
    bub = library.bubble_sort_graph(8)
    bub_reqs, bub_lens = serving_workload("bubble_sort", bub, 512, seed=1)

    log("== phase 3: kernel vs plain on the card")
    errs = phase_kernel(dev)
    for name, bench, slots, reqs in (("dot_prod", dot, 1024, dot_reqs),
                                     ("bubble_sort", bub, 256, bub_reqs)):
        st = captured_state(dev, bench.graph, reqs, slots)
        for k, e in kernel_vs_plain(st).items():
            errs[k] = max(errs[k], e)
        log(f"  {name:12s} kernel == plain on the serving state "
            f"(B={slots}, L={st['fv'].shape[2]}, K=64, "
            f"{int(st['active'].sum())} active; B=1 slot {st['one']})")
        if name == "dot_prod":
            times = time_kernels(st)
        del st
    torch.cuda.empty_cache()

    log("== phase 4: engine (main path: counts from here on)")
    df.fire_block_cuda.launches = 0
    df.fire_block_batched_cuda.launches = 0
    phase_engine(dev)

    log("== phase 5: serving")
    serve, served = {}, {}
    for name, bench, slots, reqs, lens in (
            ("dot_prod", dot, 1024, dot_reqs, dot_lens),
            ("bubble_sort", bub, 256, bub_reqs, bub_lens)):
        serve[name], *served[name] = phase_serving(dev, name, bench, slots,
                                                   reqs, lens)
    launches = {"fire_block": df.fire_block_cuda.launches,
                "fire_block_batched": df.fire_block_batched_cuda.launches}
    log(f"  main-path launches (phases 4-5): {json.dumps(launches)}")
    for k, n in launches.items():
        check(n > 0, f"{k} was never launched on the main path")
    for name, bench, reqs in (("dot_prod", dot, dot_reqs),
                              ("bubble_sort", bub, bub_reqs)):
        check_sampled(dev, bench, reqs, *served[name])
    del served, bub_reqs

    log("== phase 6: trace of the dot_prod serving run")
    serve["dot_prod"]["trace"] = trace_serving(
        dev, dot, 1024, dot_reqs, serve["dot_prod"]["wall_s"])
    del dot_reqs

    log("== phase 7: summary")
    replaces = {
        "fire_block": "src/repro/kernels/dataflow_fire.py:477",
        "fire_block_batched": "src/repro/kernels/dataflow_fire.py:519"}
    pallas = {"fire_block": "fire_block_pallas -> _block_kernel (:390)",
              "fire_block_batched": "fire_block_batched_pallas -> "
                                    "_batched_block_kernel (:405)"}
    kernels = [dict(name=k, route="cuda", source=SOURCE,
                    replaces=replaces[k], pallas=pallas[k],
                    launches=launches[k], max_abs_err=errs[k],
                    library_ms=None, matches_plain=errs[k] == 0,
                    **{f: times[k][f] for f in (
                        "ms", "ms_from", "call_ms", "plain_ms",
                        "plain_device_ms", "bound_ms", "bound_by",
                        "shape")})
               for k in ("fire_block", "fire_block_batched")]
    log(json.dumps({"serving": serve}))
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
