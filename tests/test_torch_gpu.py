"""The CUDA kernels on the card: every instantiation of the fire block
(dense or specialized rule, unprofiled or profiled, in its warp and CTA
variants), the fire step and
the two static-schedule kernels against their plain PyTorch versions,
and the engine (dynamic and scheduled), ``run_fabric`` and the server
against the numpy oracle.

Every test here needs a CUDA card and skips without one (the ``cuda``
fixture decides, never the module at import).  Run them on the card
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import pytree  # noqa: E402
from repro_torch.core import library  # noqa: E402
from repro_torch.core.engine import (DataflowEngine, pack_feeds,  # noqa: E402
                                     run_reference)
from repro_torch.kernels import dataflow_fire as df  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import schedule_fire as ksf  # noqa: E402
from repro_torch.serve.dataflow_server import DataflowServer  # noqa: E402
from repro_torch.core.schedule import schedulable  # noqa: E402
from repro_torch.testing import (STATE_KEYS,  # noqa: E402
                                 assert_same_result, edge_ints,
                                 random_block_inputs, random_graph,
                                 random_prof, random_sched_run_inputs,
                                 random_sched_slot_inputs)

pytestmark = pytest.mark.gpu
SCHED_BENCHES = sorted(n for n, b in library.HAND_BUILT.items()
                       if schedulable(b().graph))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bench(name):
    return library.BENCHES[name]()


@pytest.mark.parametrize("name", sorted(library.HAND_BUILT))
def test_kernel_matches_plain(cuda, name):
    tables = df.block_plan_arrays(_bench(name).graph)
    dt = df.device_tables(tables, cuda)
    rng = np.random.default_rng(7)
    x = {k: torch.tensor(v, device=cuda)
         for k, v in random_block_inputs(tables, 16, 24, rng).items()}
    state = [x[k] for k in STATE_KEYS]
    for K in (1, 16, 64):
        n0 = df.fire_block_batched_cuda.launches
        got = df.fire_block_batched_cuda(
            dt, x["feed_vals"], x["feed_len"], *state, n_cycles=K,
            active=x["active"])
        assert df.fire_block_batched_cuda.launches == n0 + 1
        want = df.fire_block_batched(
            dt, x["feed_vals"], x["feed_len"], *state, n_cycles=K,
            active=x["active"])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        n1 = df.fire_block_cuda.launches
        got1 = df.fire_block_cuda(dt, x["feed_vals"][0], x["feed_len"][0],
                                  *(s[0] for s in state), n_cycles=K)
        assert df.fire_block_cuda.launches == n1 + 1
        want1 = df.fire_block(dt, x["feed_vals"][0], x["feed_len"][0],
                              *(s[0] for s in state), n_cycles=K)
        for g, w in zip(got1, want1):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kernel_rejects_bad_arguments(cuda):
    tables = df.block_plan_arrays(_bench("dot_prod").graph)
    dt = df.device_tables(tables, cuda)
    x = random_block_inputs(tables, 2, 4, np.random.default_rng(0))
    t = {k: torch.tensor(v, device=cuda) for k, v in x.items()}
    args = [t[k] for k in ("feed_vals", "feed_len", "full", "val", "ptr",
                           "out_last", "out_count")]
    with pytest.raises(TypeError):      # int64 state
        df.fire_block_batched_cuda(dt, *args[:2], args[2].long(),
                                   *args[3:], n_cycles=4)
    with pytest.raises(ValueError):     # wrong arc count
        df.fire_block_batched_cuda(dt, *args[:2], args[2][:, :-1].clone(),
                                   *args[3:], n_cycles=4)
    with pytest.raises(ValueError):     # mixed devices
        df.fire_block_batched_cuda(dt, *args[:2], args[2].cpu(), *args[3:],
                                   n_cycles=4)


@pytest.mark.parametrize("name", sorted(library.HAND_BUILT))
def test_engine_matches_reference(cuda, name):
    bench = _bench(name)
    feeds = [library.random_feeds(name, bench, 1 + b % 5,
                                  np.random.default_rng(b)) for b in range(6)]
    wants = [run_reference(bench.graph, f) for f in feeds]
    for K in (1, 4, 16):
        eng = DataflowEngine(bench.graph, block_cycles=K, device=cuda)
        got = [eng.run(feeds[0])] + eng.run_batch(feeds)
        for g, w in zip(got, [wants[0]] + wants):
            assert_same_result(g, w, (name, K), dispatches=False)


def test_server_matches_solo_runs(cuda):
    bench = _bench("fibonacci")
    feeds = [bench.make_feeds(1 + (3 * i) % 11) for i in range(10)]
    wants = [run_reference(bench.graph, f) for f in feeds]
    srv = DataflowServer(bench.graph, slots=4, block_cycles=4, device=cuda)
    for f in feeds[:4]:
        srv.submit(f)
    got = srv.step() + srv.step()
    for f in feeds[4:]:
        srv.submit(f)
    got = sorted(got + srv.drain(), key=lambda r: r.uid)
    assert [r.uid for r in got] == list(range(1, 11))
    for r, w in zip(got, wants):
        assert_same_result(r.engine, w, r.uid, dispatches=False)


def test_pack_feeds_layout_feeds_the_kernel(cuda):
    """A packed single stream runs through the kernel exactly as the
    plain version runs it."""
    bench = _bench("pop_count")
    tables = df.block_plan_arrays(bench.graph)
    dt = df.device_tables(tables, cuda)
    fv, fl = pack_feeds(tables["plan"]["input_arcs"],
                        bench.make_feeds([3, 255, 7]), pad_rows=1)
    eng = DataflowEngine(bench.graph, block_cycles=8, device=cuda)
    state = eng._state0()
    args = (torch.tensor(fv, device=cuda), torch.tensor(fl, device=cuda),
            *state)
    for g, w in zip(df.fire_block_cuda(dt, *args, n_cycles=8),
                    df.fire_block(dt, *args, n_cycles=8)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("name", sorted(library.HAND_BUILT))
def test_profiled_and_spec_kernels_match_plain(cuda, name, optimize):
    """The profiled instantiation (random counters in, parked streams
    keep theirs) and, on an optimized plan, the spec instantiation,
    against the plain version; the spec kernel also against the dense
    kernel on the same permuted tables."""
    tables = df.block_plan_arrays(_bench(name).graph, optimize=optimize)
    dt = df.device_tables(tables, cuda)
    assert (dt.class_slices is not None) == optimize
    dense = df.device_tables(dict(tables, class_slices=None), cuda)
    rng = np.random.default_rng(11)
    x = {k: torch.tensor(v, device=cuda)
         for k, v in random_block_inputs(tables, 16, 24, rng).items()}
    prof = tuple(torch.tensor(p, device=cuda)
                 for p in random_prof(tables, 16, rng))
    args = [x["feed_vals"], x["feed_len"], *(x[k] for k in STATE_KEYS)]
    w = df.fire_block_batched_cuda
    for K in (1, 16, 64):
        for pr in (None, prof):
            counts = (w.launches, w.prof_launches, w.spec_launches)
            got = w(dt, *args, n_cycles=K, active=x["active"], prof=pr)
            assert (w.launches, w.prof_launches, w.spec_launches) == (
                counts[0] + (pr is None), counts[1] + (pr is not None),
                counts[2] + optimize)
            _assert_equal(got, df.fire_block_batched(
                dt, *args, n_cycles=K, active=x["active"], prof=pr))
            _assert_equal(got, w(dense, *args, n_cycles=K,
                                 active=x["active"], prof=pr))
            parked = x["active"] == 0
            for g, p in zip(got[7:], pr or ()):
                assert torch.equal(g[parked], p[parked])
            p1 = None if pr is None else tuple(p[0] for p in pr)
            one = [a[0] for a in args]
            _assert_equal(df.fire_block_cuda(dt, *one, n_cycles=K, prof=p1),
                          df.fire_block(dt, *one, n_cycles=K, prof=p1))


@pytest.mark.parametrize("seed", range(16))
def test_spec_kernel_on_random_graphs(cuda, seed):
    """Random fabrics with NDMERGE/DMERGE/BRANCH: spec == dense == plain."""
    tables = df.block_plan_arrays(random_graph(seed), optimize=True)
    dt = df.device_tables(tables, cuda)
    dense = df.device_tables(dict(tables, class_slices=None), cuda)
    rng = np.random.default_rng(seed)
    x = {k: torch.tensor(v, device=cuda)
         for k, v in random_block_inputs(tables, 8, 12, rng).items()}
    prof = tuple(torch.tensor(p, device=cuda)
                 for p in random_prof(tables, 8, rng))
    args = [x["feed_vals"], x["feed_len"], *(x[k] for k in STATE_KEYS)]
    for pr in (None, prof):
        kw = dict(n_cycles=8, active=x["active"], prof=pr)
        got = df.fire_block_batched_cuda(dt, *args, **kw)
        _assert_equal(got, df.fire_block_batched(dt, *args, **kw))
        _assert_equal(got, df.fire_block_batched_cuda(dense, *args, **kw))


def _variant_inputs(cuda, tables, B, L, seed):
    rng = np.random.default_rng(seed)
    x = {k: torch.tensor(v, device=cuda)
         for k, v in random_block_inputs(tables, B, L, rng).items()}
    x["active"][1] = 0
    prof = tuple(torch.tensor(p, device=cuda)
                 for p in random_prof(tables, B, rng))
    return x, prof, [x["feed_vals"], x["feed_len"],
                     *(x[k] for k in STATE_KEYS)]


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("name", ["dot_prod", "bubble_sort", "fibonacci"])
def test_both_variants_match_plain_and_each_other(cuda, name, optimize):
    """The warp and CTA variants on the same inputs: B = 11 streams (the
    warp variant's last CTA part-filled) with parked ones, K past one
    staging chunk and a small chunk restaged many times, unprofiled and
    profiled, against the plain version, the two-phase replay and each
    other; single-stream launches too."""
    tables = df.block_plan_arrays(_bench(name).graph, optimize=optimize)
    dt = df.device_tables(tables, cuda)
    assert dt.variant == "warp"
    x, prof, args = _variant_inputs(cuda, tables, 11, df.STAGE_CYCLES + 40,
                                    5)
    mis = x["feed_vals"].data_ptr() // 4 % 4
    for K, chunk in ((16, None), (df.STAGE_CYCLES + 1, None), (9, 4)):
        for pr in (None, prof):
            kw = dict(n_cycles=K, active=x["active"], prof=pr)
            want = df.fire_block_batched(dt, *args, **kw)
            warp = df.launch_variant("warp", dt, *args, chunk=chunk, **kw)
            cta = df.launch_variant("cta", dt, *args, chunk=chunk, **kw)
            _assert_equal(warp, want)
            _assert_equal(cta, warp)
            _assert_equal(df.fire_block_two_phase(
                dt, *args, chunk=chunk or df.STAGE_CYCLES, misalign=mis,
                **kw), warp)
            p1 = None if pr is None else tuple(p[0] for p in pr)
            one = [a[0] for a in args]
            want1 = df.fire_block(dt, *one, n_cycles=K, prof=p1)
            for v in df.VARIANTS:
                _assert_equal(df.launch_variant(
                    v, dt, *one, n_cycles=K, prof=p1, chunk=chunk,
                    batched=False), want1)


@pytest.mark.parametrize("seed", range(3))
def test_cta_variant_on_a_fabric_above_the_warp_size(cuda, seed):
    """A seeded random fabric with more than WARP_ROWS rows takes the
    CTA-wide kernel (counted under "cta"); the warp variant refuses it."""
    tables = df.block_plan_arrays(random_graph(seed, nodes=150),
                                  optimize=seed % 2 == 1)
    dt = df.device_tables(tables, cuda)
    assert dt.variant == "cta"
    x, prof, args = _variant_inputs(cuda, tables, 6, df.STAGE_CYCLES + 10,
                                    seed)
    w = df.fire_block_batched_cuda
    for K in (8, df.STAGE_CYCLES + 1):
        for pr in (None, prof):
            kw = dict(n_cycles=K, active=x["active"], prof=pr)
            before = dict(w.launches_by)
            got = w(dt, *args, **kw)
            assert w.launches_by == dict(before, cta=before["cta"] + 1)
            _assert_equal(got, df.fire_block_batched(dt, *args, **kw))
    with pytest.raises(ValueError, match="variant"):
        df.launch_variant("warp", dt, *args, n_cycles=4)


def test_launches_by_counts_the_variant_that_ran(cuda):
    tables = df.block_plan_arrays(_bench("dot_prod").graph)
    dt = df.device_tables(tables, cuda)
    x, _, args = _variant_inputs(cuda, tables, 5, 16, 0)
    for w, a, kw in ((df.fire_block_batched_cuda, args,
                      dict(active=x["active"])),
                     (df.fire_block_cuda, [v[0] for v in args], {})):
        before = dict(w.launches_by)
        w(dt, *a, n_cycles=4, **kw)
        assert w.launches_by == dict(before, warp=before["warp"] + 1)
    n = dict(df.fire_block_batched_cuda.launches_by)
    df.launch_variant("cta", dt, *args, n_cycles=4)    # counted nowhere
    assert df.fire_block_batched_cuda.launches_by == n


@pytest.mark.parametrize("name", sorted(library.HAND_BUILT))
def test_fire_step_kernel_matches_plain(cuda, name):
    tables = df.block_plan_arrays(_bench(name).graph)
    dt = df.device_tables(tables, cuda)
    x = random_block_inputs(tables, 8, 1, np.random.default_rng(5))
    for b in range(8):
        full = torch.tensor(x["full"][b], device=cuda)
        val = torch.tensor(x["val"][b], device=cuda)
        n0 = df.fire_step_cuda.launches
        got = df.fire_step_cuda(dt, full, val)
        assert df.fire_step_cuda.launches == n0 + 1
        _assert_equal(got, df.fire_step(dt, full, val))


@pytest.mark.parametrize("name", sorted(library.HAND_BUILT))
def test_optimized_profiled_engine_matches_reference(cuda, name):
    bench = _bench(name)
    feeds = [library.random_feeds(name, bench, 1 + b % 5,
                                  np.random.default_rng(b)) for b in range(6)]
    wants = [run_reference(bench.graph, f, profile=True) for f in feeds]
    for K in (1, 16):
        eng = DataflowEngine(bench.graph, block_cycles=K, device=cuda,
                             optimize=True, profile=True)
        got = eng.run(feeds[0])
        if K == 1:      # one-cycle blocks simulate the oracle's cycles
            assert_same_result(got, wants[0], name, dispatches=False,
                               profile=True)
        for g, w in zip([got] + eng.run_batch(feeds), [wants[0]] + wants):
            assert_same_result(g, w, (name, K), dispatches=False)
            np.testing.assert_array_equal(g.node_fires, w.node_fires)
            g.profile.check()


@pytest.mark.parametrize("name", sorted(library.HAND_BUILT))
def test_run_fabric_matches_reference(cuda, name):
    bench = _bench(name)
    feeds = library.random_feeds(name, bench, 4, np.random.default_rng(2))
    got = ops.run_fabric(bench.graph, feeds, device=cuda)
    assert_same_result(got, run_reference(bench.graph, feeds), name,
                       dispatches=False)
    assert got.dispatches == got.cycles


def test_profiled_optimized_server_matches_solo_runs(cuda):
    bench = _bench("dot_prod")
    feeds = [library.random_feeds("dot_prod", bench, 3 + 7 * i,
                                  np.random.default_rng(i))
             for i in range(12)]
    srv = DataflowServer(bench.graph, slots=4, block_cycles=8, device=cuda,
                         optimize=True, profile=True)
    got = srv.run(feeds)
    solo = DataflowEngine(bench.graph, block_cycles=8, device=cuda,
                          optimize=True, profile=True)
    for r, f in zip(got, feeds):
        want = solo.run(f)
        r.engine.profile.check()
        assert_same_result(r.engine, want, r.uid, profile=True)


# ---------------------------------------------------------------------------
# the static-schedule kernels, the scheduled engine and server
# ---------------------------------------------------------------------------
def _sched_ctx(cuda, name, optimize=False):
    return DataflowEngine(_bench(name).graph, device=cuda, schedule=True,
                          optimize=optimize)._sched_ctx()


def _slot_args(cuda, x):
    t = {k: torch.tensor(x[k], device=cuda) for k in ("fv", *STATE_KEYS)}
    return (t["fv"], x["pids"], x["fsel"], *(t[k] for k in STATE_KEYS))


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("name", SCHED_BENCHES)
def test_sched_kernels_match_plain(cuda, name, optimize):
    """Both schedule kernels against their plain versions: the slot step
    at K in {1, 16, 64} (mixed feed lengths, random mid-plan positions,
    parked slots keep their registers), the run over a batch and one
    stream, whole and clipped."""
    ctx = _sched_ctx(cuda, name, optimize)
    rng = np.random.default_rng(13)
    for K in (1, 16, 64):
        x = random_sched_slot_inputs(ctx, 16, K, 24, rng)
        tabs = ksf.device_sched_tables(ctx, cuda)
        args = _slot_args(cuda, x)
        n0 = ksf.sched_slot_step_cuda.launches
        got = ksf.sched_slot_step_cuda(tabs, *args)
        assert ksf.sched_slot_step_cuda.launches == n0 + 1
        _assert_equal(got, ksf.sched_slot_step(tabs, *args))
        parked = torch.tensor(x["fsel"] < 0, device=cuda)
        assert parked.any() and torch.equal(got[0][parked], args[3][parked])
    fv, plan = random_sched_run_inputs(ctx, 8, 24, rng)
    tabs = ksf.device_sched_tables(ctx, cuda)
    fv = torch.tensor(fv, device=cuda)
    for upto in (plan.total, plan.total // 2 + 1):
        program = ksf.flat_program(*plan.trace_struct(upto))
        n0 = ksf.sched_run_cuda.launches
        got = ksf.sched_run_cuda(tabs, program, fv)
        assert ksf.sched_run_cuda.launches == n0 + 1
        _assert_equal(got, ksf.sched_run(tabs, program, fv))
        _assert_equal(ksf.sched_run_cuda(tabs, program, fv[:1].contiguous()),
                      [g[:1] for g in got])


def test_sched_kernels_reject_bad_arguments(cuda):
    ctx = _sched_ctx(cuda, "fir")
    rng = np.random.default_rng(0)
    x = random_sched_slot_inputs(ctx, 4, 8, 12, rng)
    tabs = ksf.device_sched_tables(ctx, cuda)
    args = list(_slot_args(cuda, x))
    bad = x["pids"].copy()
    bad[0, 0] = tabs.n_patterns                 # a pid the tables lack
    with pytest.raises(ValueError, match="stale"):
        ksf.sched_slot_step_cuda(tabs, args[0], bad, *args[2:])
    with pytest.raises(ValueError, match="host data"):
        ksf.sched_slot_step_cuda(tabs, args[0],
                                 torch.tensor(x["pids"], device=cuda),
                                 *args[2:])
    with pytest.raises(TypeError):              # int64 registers
        ksf.sched_slot_step_cuda(tabs, *args[:3], args[3].long(), *args[4:])
    with pytest.raises(ValueError):             # wrong arc count
        ksf.sched_slot_step_cuda(tabs, *args[:3], args[3][:, :-1].clone(),
                                 *args[4:])
    with pytest.raises(ValueError):             # mixed devices
        ksf.sched_slot_step_cuda(tabs, *args[:3], args[3].cpu(), *args[4:])
    # new feed lengths register new patterns: the old upload is stale
    n_in = ctx.in_arc.size
    plan = ctx.plan_for(tuple(range(20, 20 + n_in)))
    plan.ensure(1 << 20)
    assert len(ctx.registry) > tabs.n_patterns
    program = ksf.flat_program(*plan.trace_struct(plan.total))
    fv = torch.zeros((1, n_in, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="stale"):
        ksf.sched_run_cuda(tabs, program, fv)
    fresh = ksf.device_sched_tables(ctx, cuda)
    _assert_equal(ksf.sched_run_cuda(fresh, program, fv),
                  ksf.sched_run(fresh, program, fv))
    with pytest.raises(TypeError):              # not from device_sched_tables
        ksf.sched_run_cuda(dict(fresh), program, fv)


def _misaligned(fv, ints):
    """fv's tokens at ``ints`` ints past a 16-byte boundary."""
    buf = torch.empty(fv.numel() + 4, dtype=fv.dtype, device=fv.device)
    out = buf[ints:ints + fv.numel()].view(fv.shape)
    out.copy_(fv)
    return out


def _warp_window(tabs, program, B):
    """The feed window the launcher plans for ``program`` at B streams."""
    prog = {k: np.asarray(program[k], np.int32) for k in ksf.PROGRAM_KEYS}
    plan = ksf.warp_plan(tabs, prog, B, torch.cuda.current_device())
    assert plan is not None
    return plan["window"]


@pytest.mark.parametrize("name", SCHED_BENCHES)
def test_sched_run_variants_at_window_edges(cuda, name):
    """Both run variants bit for bit against the plain run at stream
    lengths 1, W - 1, W, W + 1 and an odd one past two windows (the
    launch plan's W, and W = 4; streams of one and of two warps), B = 1
    and 8, half the rows fed two tokens past their end (the clamp),
    tokens off a 16-byte boundary."""
    ctx = _sched_ctx(cuda, name)
    rng = np.random.default_rng(29)
    n_in = ctx.in_arc.size
    tabs = ksf.device_sched_tables(ctx, cuda)
    plan = ctx.plan_for((64,) * n_in)
    plan.ensure(1 << 20)
    tabs = ksf.device_sched_tables(ctx, cuda)
    W = _warp_window(tabs, ksf.flat_program(*plan.trace_struct(plan.total)),
                     8)
    for L in sorted({1, W - 1, W, W + 1, 2 * W + 3, 3, 4, 5, 11}):
        flen = tuple(L + 2 if r % 2 == 0 else L for r in range(n_in))
        plan = ctx.plan_for(flen)
        plan.ensure(1 << 20)
        tabs = ksf.device_sched_tables(ctx, cuda)
        program = ksf.flat_program(*plan.trace_struct(plan.total))
        for B in (1, 8):
            fv = torch.tensor(edge_ints(rng, (B, ctx.ia_pad.size, L)),
                              device=cuda)
            want = ksf.sched_run(tabs, program, fv)
            for f in (fv, _misaligned(fv, 1), _misaligned(fv, 3)):
                _assert_equal(ksf.launch_sched_variant("cta", tabs, program,
                                                       f), want)
                for window in (None, 4):
                    for warps in sorted(tabs.warp["bits"]):
                        _assert_equal(ksf.launch_sched_variant(
                            "warp", tabs, program, f, window=window,
                            warps=warps), want)


@pytest.mark.parametrize("L", [1, 3, 4, 5, 11, 31, 32, 33, 97])
def test_sched_run_warp_variant_feeding_every_cycle(cuda, L):
    """Rows that take a token every cycle: the windows land in time at
    W = 4, 8 and the plan's; against the plain run."""
    from repro_torch.testing import every_cycle_sched
    host, program = every_cycle_sched(5, L, L + 9)
    tabs = ksf.upload_sched_tables(host, cuda, 4)
    fv = torch.tensor(edge_ints(np.random.default_rng(L), (8, 5, L)),
                      device=cuda)
    want = ksf.sched_run(tabs, program, fv)
    for f in (fv, _misaligned(fv, 2)):
        for window in (None, 4, 8):
            _assert_equal(ksf.launch_sched_variant("warp", tabs, program, f,
                                                   window=window), want)
        _assert_equal(ksf.launch_sched_variant("cta", tabs, program, f),
                      want)


def test_sched_run_launches_by_counts_the_variant_that_ran(cuda):
    """dot_prod n = 32 runs the warp variant; a fabric of 160 feed rows
    the CTA one; each launch counted under its variant."""
    for graph, want in ((library.dot_product_graph(32).graph, "warp"),
                        (library.dot_product_graph(80).graph, "cta")):
        ctx = DataflowEngine(graph, device=cuda,
                             schedule=True)._sched_ctx()
        plan = ctx.plan_for((12,) * ctx.in_arc.size)
        plan.ensure(1 << 20)
        tabs = ksf.device_sched_tables(ctx, cuda)
        program = ksf.flat_program(*plan.trace_struct(plan.total))
        fv = torch.tensor(edge_ints(np.random.default_rng(0),
                                    (4, ctx.ia_pad.size, 12)), device=cuda)
        n0 = dict(ksf.sched_run_cuda.launches_by)
        got = ksf.sched_run_cuda(tabs, program, fv)
        _assert_equal(got, ksf.sched_run(tabs, program, fv))
        assert ksf.sched_run_cuda.launches_by[want] == n0[want] + 1
        assert sum(ksf.sched_run_cuda.launches_by.values()) == \
            sum(n0.values()) + 1
    with pytest.raises(ValueError, match="cannot run"):
        ksf.launch_sched_variant("warp", tabs, program, fv)


def test_warp_plan_fits_two_ctas_an_sm(cuda):
    """The launcher's plan for dot_prod n = 32 over 4096 tokens (64 feed
    rows, 13 patterns of 64 fire rows): 4 streams a CTA with W = 32 and
    one warp a stream at B = 1024; two warps below 4 streams an SM; B
    bounds the streams; a fixed window keeps the streams; windows that are
    not powers of two from 4, and warps the tables cannot take, are
    refused.  A launch records the plan it ran."""
    ctx = DataflowEngine(library.dot_product_graph(32).graph, device=cuda,
                         schedule=True)._sched_ctx()
    plan = ctx.plan_for((4096,) * ctx.in_arc.size)
    plan.ensure(1 << 20)
    tabs = ksf.device_sched_tables(ctx, cuda)
    prog = {k: np.asarray(v, np.int32) for k, v in
            ksf.flat_program(*plan.trace_struct(plan.total)).items()}
    index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    wp = lambda B, **kw: ksf.warp_plan(tabs, prog, B, index, **kw)
    assert wp(1024) == dict(window=32, streams=4, warps=1)
    assert wp(4 * sms) == dict(window=32, streams=4, warps=1)
    assert wp(4 * sms - 1)["warps"] == 2
    assert wp(8)["warps"] == 2
    assert wp(2)["streams"] == 2 and wp(1)["streams"] == 1
    assert wp(1024, window=8) == dict(window=8, streams=4, warps=1)
    assert wp(1024, warps=2)["warps"] == 2
    for bad in (dict(window=6), dict(window=2), dict(warps=3)):
        assert wp(1024, **bad) is None
    fv = torch.tensor(edge_ints(np.random.default_rng(1),
                                (8, ctx.ia_pad.size, 64)), device=cuda)
    short = ctx.plan_for((64,) * ctx.in_arc.size)
    short.ensure(1 << 20)
    program = ksf.flat_program(*short.trace_struct(short.total))
    _assert_equal(ksf.sched_run_cuda(tabs, program, fv),
                  ksf.sched_run(tabs, program, fv))
    run = ksf.warp_plan(tabs, {k: np.asarray(v, np.int32)
                               for k, v in program.items()}, 8, index)
    assert ksf.sched_run_cuda.last_plan == dict(variant="warp", **run)
    ksf.sched_floor_cuda(tabs, program, fv)
    assert ksf.sched_run_cuda.last_plan["warps"] == 1
    assert ksf.sched_run_cuda.last_plan["streams"] == 1


@pytest.mark.parametrize("name", SCHED_BENCHES)
def test_slot_step_variants_match_plain(cuda, name):
    """Both slot-step variants bit for bit against the plain slot step and
    its warp-order replay: B = 1, 8 and 64, K = 1, 16, 64 and 65,
    slots riding 4 plans at random positions (a quarter parked, pointers
    clamped), the tokens 0-3 ints off a 16-byte boundary."""
    from repro_torch.testing import random_slot_window_inputs, slot_plans
    ctx = _sched_ctx(cuda, name)
    rng = np.random.default_rng(41)
    plans = slot_plans(ctx, 40, rng, n=4)
    for B in (1, 8, 64):
        for K in (1, 16, 64, 65):
            x = random_slot_window_inputs(ctx, plans, B, K, 40, rng)
            tabs = ksf.device_sched_tables(ctx, cuda)
            args = list(_slot_args(cuda, x))
            want = ksf.sched_slot_step(tabs, *args)
            for mis in range(4):
                args[0] = _misaligned(_slot_args(cuda, x)[0], mis)
                _assert_equal(ksf.sched_slot_step_staged(tabs, *args,
                                                         misalign=mis), want)
                for v in ksf.SLOT_VARIANTS:
                    _assert_equal(ksf.launch_slot_variant(v, tabs, *args),
                                  want)


def test_slot_step_launches_by_counts_the_variant_that_ran(cuda):
    """dot_prod n = 32 runs the warp variant, a fabric of 160 feed rows
    the CTA one; each launch counted under its variant, the plan in
    last_plan; launch_slot_variant and the floor count nothing."""
    from repro_torch.testing import random_slot_window_inputs, slot_plans
    rng = np.random.default_rng(5)
    for graph, want in ((library.dot_product_graph(32).graph, "warp"),
                        (library.dot_product_graph(80).graph, "cta")):
        ctx = DataflowEngine(graph, device=cuda, schedule=True)._sched_ctx()
        x = random_slot_window_inputs(ctx, slot_plans(ctx, 16, rng, n=2), 8,
                                      16, 16, rng)
        tabs = ksf.device_sched_tables(ctx, cuda)
        args = _slot_args(cuda, x)
        n0 = ksf.sched_slot_step_cuda.launches
        by0 = dict(ksf.sched_slot_step_cuda.launches_by)
        _assert_equal(ksf.sched_slot_step_cuda(tabs, *args),
                      ksf.sched_slot_step(tabs, *args))
        assert ksf.sched_slot_step_cuda.launches == n0 + 1
        assert ksf.sched_slot_step_cuda.launches_by == \
            dict(by0, **{want: by0[want] + 1})
        assert ksf.sched_slot_step_cuda.last_plan["variant"] == want
    with pytest.raises(ValueError, match="cannot run"):
        ksf.launch_slot_variant("warp", tabs, *args)
    ctx = _sched_ctx(cuda, "dot_prod")
    x = random_slot_window_inputs(ctx, slot_plans(ctx, 16, rng, n=2), 8, 16,
                                  16, rng)
    tabs = ksf.device_sched_tables(ctx, cuda)
    args = _slot_args(cuda, x)
    by = dict(ksf.sched_slot_step_cuda.launches_by)
    ksf.launch_slot_variant("cta", tabs, *args)
    one = ksf.sched_slot_floor_cuda(tabs, *args)
    assert ksf.sched_slot_step_cuda.launches_by == by
    assert ksf.sched_slot_step_cuda.last_plan == dict(variant="warp",
                                                      streams=1)
    _assert_equal(one, [w[:1] for w in ksf.sched_slot_step(tabs, *args)])


def test_slot_step_back_to_back_calls_read_their_own_pids(cuda):
    """Six wrapper calls in a row with no sync between them, each with its
    own pids and fsel uploaded while the card may still run the calls
    before: every result equals the plain slot step's on its own
    arguments."""
    from repro_torch.testing import random_slot_window_inputs, slot_plans
    ctx = _sched_ctx(cuda, "dot_prod")
    rng = np.random.default_rng(8)
    plans = slot_plans(ctx, 40, rng, n=4)
    tabs = ksf.device_sched_tables(ctx, cuda)
    calls = [_slot_args(cuda, random_slot_window_inputs(ctx, plans, 64, 64,
                                                        40, rng))
             for _ in range(6)]
    torch.cuda.synchronize()
    got = [ksf.sched_slot_step_cuda(tabs, *a) for a in calls]
    for a, g in zip(calls, got):
        _assert_equal(g, ksf.sched_slot_step(tabs, *a))


def test_slot_plan_by_width_slots_and_k(cuda):
    """The launcher's slot plan for dot_prod n = 32 (64 feed rows, 64 fire
    rows a pattern): 4 slots a CTA at B = 1024 and below 4 slots an SM
    (one warp a slot), B bounds the slots; a window too long for a CTA's
    shared memory (K = 16384) sends the call to the CTA variant, which
    runs it."""
    ctx = _sched_ctx(cuda, "dot_prod")
    ctx.plan_for((8,) * ctx.in_arc.size).ensure(1 << 12)
    tabs = ksf.device_sched_tables(ctx, cuda)
    index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    assert ksf.slot_plan(tabs, 64, 1024, index) == dict(streams=4)
    assert ksf.slot_plan(tabs, 65, 4 * sms, index) == dict(streams=4)
    assert ksf.slot_plan(tabs, 64, 8, index) == dict(streams=4)
    assert ksf.slot_plan(tabs, 64, 2, index) == dict(streams=2)
    assert ksf.slot_variant(tabs, 64, 1024, index) == "warp"
    assert ksf.slot_plan(tabs, 1 << 14, 1, index) is None
    assert ksf.slot_variant(tabs, 1 << 14, 1, index) == "cta"
    n_in, n_out = ctx.ia_pad.size, ctx.oa_pad.size
    K, L = 1 << 14, 8
    rng = np.random.default_rng(2)
    x = dict(fv=edge_ints(rng, (1, n_in, L)),
             pids=np.zeros((1, K), np.int32), fsel=np.full((1,), -1, np.int32),
             full=rng.integers(0, 2, (1, ctx.A2)).astype(np.int32),
             val=edge_ints(rng, (1, ctx.A2)),
             ptr=np.zeros((1, n_in), np.int32),
             out_last=edge_ints(rng, (1, n_out)),
             out_count=np.zeros((1, n_out), np.int32))
    by = dict(ksf.sched_slot_step_cuda.launches_by)
    args = _slot_args(cuda, x)
    _assert_equal(ksf.sched_slot_step_cuda(tabs, *args),
                  ksf.sched_slot_step(tabs, *args))
    assert ksf.sched_slot_step_cuda.launches_by["cta"] == by["cta"] + 1


@pytest.mark.parametrize("name", sorted(library.HAND_BUILT))
def test_fire_step_variants_match_plain(cuda, name):
    """Both fire-step variants and the warp order's replay against the
    plain fire step on random registers."""
    tables = df.block_plan_arrays(_bench(name).graph)
    dt = df.device_tables(tables, cuda)
    assert dt.step_variant == "warp"
    x = random_block_inputs(tables, 8, 1, np.random.default_rng(6))
    for b in range(8):
        full = torch.tensor(x["full"][b], device=cuda)
        val = torch.tensor(x["val"][b], device=cuda)
        want = df.fire_step(dt, full, val)
        _assert_equal(df.fire_step_warp_order(dt, full, val), want)
        for v in df.STEP_VARIANTS:
            _assert_equal(df.launch_step_variant(v, dt, full, val), want)


def test_fire_step_launches_by_counts_the_variant_that_ran(cuda):
    """A bench runs the warp fire step, a fabric above 256 rows the CTA
    one (and refuses the warp one); launch_step_variant counts nothing;
    run_fabric launches the warp step once a cycle."""
    for graph, want in ((library.dot_product_graph(32).graph, "warp"),
                        (random_graph(1, nodes=150), "cta")):
        tables = df.block_plan_arrays(graph)
        dt = df.device_tables(tables, cuda)
        x = random_block_inputs(tables, 1, 1, np.random.default_rng(0))
        full = torch.tensor(x["full"][0], device=cuda)
        val = torch.tensor(x["val"][0], device=cuda)
        by0 = dict(df.fire_step_cuda.launches_by)
        _assert_equal(df.fire_step_cuda(dt, full, val),
                      df.fire_step(dt, full, val))
        assert df.fire_step_cuda.launches_by == dict(by0,
                                                     **{want: by0[want] + 1})
        by1 = dict(df.fire_step_cuda.launches_by)
        df.launch_step_variant("cta", dt, full, val)
        assert df.fire_step_cuda.launches_by == by1
    with pytest.raises(ValueError, match="cannot run"):
        df.launch_step_variant("warp", dt, full, val)
    bench = _bench("fir")
    feeds = library.random_feeds("fir", bench, 6, np.random.default_rng(1))
    by0 = dict(df.fire_step_cuda.launches_by)
    got = ops.run_fabric(bench.graph, feeds, device=cuda)
    assert df.fire_step_cuda.launches_by["warp"] == by0["warp"] + got.cycles
    assert df.fire_step_cuda.launches_by["cta"] == by0["cta"]


def test_fire_step_rejects_bad_arguments(cuda):
    """The registers are checked on every call (the tables once, by
    make_fire_step or the first launch): int64, a wrong length, another
    device and tables not from device_tables raise."""
    tables, step = ops.make_fire_step(_bench("dot_prod").graph, cuda)
    A2 = tables["plan"]["A"] + 2
    dt = df.device_tables(tables, cuda)
    full = torch.zeros(A2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        step(full.long(), full)
    with pytest.raises(ValueError):
        step(full[:-1].clone(), full[:-1].clone())
    with pytest.raises(ValueError):
        step(full.cpu(), full)
    with pytest.raises(TypeError):
        df.fire_step_cuda(dict(dt), full, full)
    assert len(step(full, full)) == 3


@pytest.mark.parametrize("name", SCHED_BENCHES)
def test_scheduled_engine_matches_reference(cuda, name):
    """Scheduled run and run_batch go through the run kernel (one launch
    each) and equal the oracle in every field, profile included."""
    bench = _bench(name)
    feeds = [library.random_feeds(name, bench, 6, np.random.default_rng(b))
             for b in range(5)]
    wants = [run_reference(bench.graph, f, profile=True) for f in feeds]
    for opt in (False, True):
        eng = DataflowEngine(bench.graph, block_cycles=16, device=cuda,
                             optimize=opt, profile=True, schedule=True)
        n0 = ksf.sched_run_cuda.launches
        got = [eng.run(feeds[0])] + eng.run_batch(feeds)
        assert ksf.sched_run_cuda.launches == n0 + 2
        for g, w in zip(got, [wants[0]] + wants):
            assert_same_result(g, w, (name, opt), dispatches=False,
                               profile=True)


def test_scheduled_server_matches_reference(cuda):
    """The scheduled server steps every block through the slot kernel and
    answers as solo runs and the oracle do, profile included."""
    bench = _bench("dot_prod")
    feeds = [library.random_feeds("dot_prod", bench, 3 + 7 * i,
                                  np.random.default_rng(i))
             for i in range(12)]
    srv = DataflowServer(bench.graph, slots=4, block_cycles=8, device=cuda,
                         optimize=True, profile=True, schedule=True)
    n0 = ksf.sched_slot_step_cuda.launches
    got = srv.run(feeds)
    assert ksf.sched_slot_step_cuda.launches == n0 + srv.block
    solo = DataflowEngine(bench.graph, block_cycles=8, device=cuda,
                          optimize=True, profile=True)
    for r, f in zip(got, feeds):
        assert_same_result(r.engine, solo.run(f), r.uid, profile=True)
        assert_same_result(r.engine, run_reference(bench.graph, f), r.uid,
                           dispatches=False)

@pytest.mark.parametrize("schedule", [False, True])
def test_hardened_server_on_card(cuda, schedule):
    """chip_smoke.py phase 5b (a, b) at a small size: tenants, transient
    dispatch faults, wedges and poison, a trace and a metrics registry.
    Unfaulted requests equal the oracle, poisoned ones a solo run over
    the poisoned feeds; the trace and the snapshot validate; every block
    is one launch."""
    from repro_torch.obs import (MetricsRegistry, TraceRecorder,
                                 validate_chrome, validate_snapshot)
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.types import Request
    bench = _bench("dot_prod")
    reqs = [Request(uid=i + 1, tenant=f"t{i % 4}",
                    max_cycles=40 if i % 9 == 8 else None,
                    feeds=library.random_feeds("dot_prod", bench, 3 + 5 * i,
                                               np.random.default_rng(i)))
            for i in range(40)]
    plan = FaultPlan(seed=7, dispatch_fail_rate=0.2, transient_attempts=2,
                     wedge_rate=0.1, poison_rate=0.15)
    tr, mr = TraceRecorder(), MetricsRegistry()
    srv = DataflowServer(bench.graph, slots=8, block_cycles=16, device=cuda,
                         optimize=True, profile=True, schedule=schedule,
                         max_retries=3, wedge_timeout_blocks=4, faults=plan,
                         trace=tr, metrics=mr)
    wrapper = ksf.sched_slot_step_cuda if schedule else \
        df.fire_block_batched_cuda
    n0 = wrapper.launches + getattr(wrapper, "prof_launches", 0)
    got = srv.run(reqs)
    assert wrapper.launches + getattr(wrapper, "prof_launches", 0) == \
        n0 + srv.block
    assert [r.uid for r in got] == [q.uid for q in reqs]
    solo = DataflowEngine(bench.graph, block_cycles=16, device=cuda,
                          optimize=True, profile=True)
    kinds = set()
    for r, q in zip(got, reqs):
        cap = q.max_cycles or srv.max_cycles
        if plan.wedge(q.uid):
            kinds.add("wedged")
            assert r.status == ("truncated" if q.max_cycles else "wedged")
        feeds = q.feeds
        if plan.poisoned(q.uid):
            kinds.add("poisoned")
            feeds = FaultPlan(seed=7, poison_rate=0.15).poison(feeds, q.uid)
        want = run_reference(bench.graph, feeds, max_cycles=cap)
        assert_same_result(r.engine, want, q.uid, dispatches=False)
        np.testing.assert_array_equal(
            r.engine.node_fires, solo.run(feeds, max_cycles=cap).node_fires)
    assert kinds == {"wedged", "poisoned"}
    for clock in ("block", "wall"):
        assert validate_chrome(tr.to_chrome(clock))["uids"] == len(reqs)
    snap = mr.snapshot()
    validate_snapshot(snap)
    retries = sum(v for k, v in snap["counters"].items()
                  if k.startswith("dispatch_retries"))
    assert retries == sum(e[0] == "dispatch-transient" for e in plan.log) > 0


def test_persistent_fault_on_card(cuda):
    """chip_smoke.py phase 5b (c) at a small size: a persistent injected
    fault answers the residents with a typed error, the run returns, and
    a compile fault raises from the constructor."""
    from repro_torch.serve.faults import (CompileFault, DispatchFault,
                                          FaultPlan)
    bench = _bench("dot_prod")
    feeds = [library.random_feeds("dot_prod", bench, 2 + 9 * i,
                                  np.random.default_rng(i))
             for i in range(16)]
    srv = DataflowServer(bench.graph, slots=4, block_cycles=16, device=cuda,
                         faults=FaultPlan(persistent_backends={"cuda"},
                                          persistent_from_block=3))
    got = srv.run(feeds)
    assert [r.uid for r in got] == list(range(1, 17)) and srv.block == 3
    statuses = {r.status for r in got}
    assert statuses == {"ok", "error"}
    for r, f in zip(got, feeds):
        if r.status == "ok":
            assert r.metrics.finished_block <= 3
            assert_same_result(r.engine, run_reference(bench.graph, f),
                               r.uid, dispatches=False)
        else:
            assert isinstance(r.error, DispatchFault)
            assert r.metrics.retries == srv.max_retries
    with pytest.raises(CompileFault):
        DataflowServer(bench.graph, slots=4, device=cuda,
                       faults=FaultPlan(compile_fail={"cuda"}))


# ---------------------------------------------------------------------------
# the LM kernels (flash attention, RMSNorm) and the LM serving engine
# ---------------------------------------------------------------------------
# kernel against plain version on the same card: f32 attention 1e-4 and
# RMSNorm 1e-5 (sums in another order), bf16 3e-2 (the JAX kernel tests');
# attention by ``flash_attention.error_ratio`` (rtol = tol, the absolute
# part scaled to the row's RMS up to tol), RMSNorm as allclose with rtol =
# atol = tol
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def _attn_inputs(cuda, B, Sq, Skv, Hkv, G, hd, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=cuda).to(dtype) for s in
            ((B, Sq, Hkv * G, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd))]


def _expected_launches(q, k, **kw):
    """The launches one wrapper call makes, by variant: the kernel the
    dispatch rule names, or the split (none without a visible key) and
    the combine pass."""
    from repro_torch.kernels import flash_attention as fa
    variant = fa.variant_of(q, k)
    if variant != "decode_split":
        return {variant: 1}
    vis = fa.visible_keys(q.shape[1], k.shape[1], **kw)
    return {"decode_split": int(vis > 0), "decode_combine": 1}


def _hold_attention(q, k, v, **kw):
    from repro_torch.kernels import flash_attention as fa
    n0 = (fa.flash_attention_cuda.launches,
          dict(fa.flash_attention_cuda.launches_by))
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want_n = _expected_launches(q, k, **dict(
        dict(causal=True, q_offset=0, kv_len=None), **kw))
    assert {x: n - n0[1][x] for x, n in
            fa.flash_attention_cuda.launches_by.items()} == {
        x: want_n.get(x, 0) for x in fa.VARIANTS}
    assert fa.flash_attention_cuda.launches == n0[0] + sum(want_n.values())
    want = fa.attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert fa.error_ratio(got, want, ATTN_TOL[q.dtype]) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 9, 12])
def test_flash_attention_kernel_matches_plain(cuda, dtype, hd, G):
    """Odd lengths; the Pallas case (causal and not), prefill into a
    longer cache, a chunk at an offset, decode mid-cache and past it.  G
    = 3, 9 (starcoder2's 36 heads over 4) and 12 leave rows of a tile
    unused (64 = 3 * 21 + 1 = 9 * 7 + 1, 16 = 12 + 4 = 9 + 7)."""
    q, k, v = _attn_inputs(cuda, 2, 33, 130, 2, G, hd, dtype, seed=hd + G)
    _hold_attention(q, k[:, :33].contiguous(), v[:, :33].contiguous(),
                    causal=True)
    _hold_attention(q, k, v, causal=False)
    _hold_attention(q, k, v, causal=True, q_offset=0, kv_len=33)
    _hold_attention(q[:, :13].contiguous(), k, v, causal=True, q_offset=60,
                    kv_len=73)
    for off, kv_len in ((70, 71), (129, 130), (150, 151)):
        _hold_attention(q[:, :1].contiguous(), k, v, causal=True,
                        q_offset=off, kv_len=kv_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_full_width(cuda, dtype):
    """internlm2-1.8b's attention (16 heads over 8, hd 128): a prefill of
    1000 tokens into a 1100-entry cache, and decode steps of 4 rows over a
    4160-entry cache."""
    q, k, v = _attn_inputs(cuda, 2, 1000, 1100, 8, 2, 128, dtype)
    _hold_attention(q, k, v, causal=True, q_offset=0, kv_len=1000)
    q, k, v = _attn_inputs(cuda, 4, 1, 4160, 8, 2, 128, dtype, seed=1)
    for off in (0, 2047, 4159, 4200):
        _hold_attention(q, k, v, causal=True, q_offset=off, kv_len=off + 1)


# the split decode's edge cases (as in chip_smoke.py phase 7), reduced:
# (B, Sq, Skv, Hkv, G, hd, q_offset, kv_len)
SPLIT_EDGES = [
    (2, 1, 130, 2, 2, 32, 0, 0),          # no visible key: zeros
    (2, 1, 130, 2, 2, 32, 0, 1),          # one visible key
    (2, 1, 130, 2, 2, 32, 39, 40),        # fewer keys than one split
    (2, 1, 130, 2, 2, 32, 150, 151),      # kv_len past the cache
    (1, 8, 130, 2, 2, 64, 60, 68),        # a split all masked for a row
    (2, 4, 300, 1, 4, 128, 200, 204),     # 16 rows: the largest tile
    (4, 1, 1100, 8, 2, 128, 1000, 1001),  # internlm2's heads, many splits
    (4, 1, 300, 4, 9, 128, 200, 201),     # starcoder2's heads: G = 9
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hkv,G,hd,q_offset,kv_len", SPLIT_EDGES)
def test_split_decode_edge_cases(cuda, dtype, B, Sq, Skv, Hkv, G, hd,
                                 q_offset, kv_len):
    q, k, v = _attn_inputs(cuda, B, Sq, Skv, Hkv, G, hd, dtype,
                           seed=Skv + q_offset)
    _hold_attention(q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hkv,G,hd,q_offset,kv_len", SPLIT_EDGES)
def test_split_partials_and_combine_match_plain(cuda, dtype, B, Sq, Skv, Hkv,
                                                G, hd, q_offset, kv_len):
    """The split kernel's partials against ``attention_partials`` (the
    masked ones, m = -inf, at the same places), and the combine pass on
    the plain partials against ``combine_partials``, each launched alone
    and counted under its own variant."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, B, Sq, Skv, Hkv, G, hd, dtype, seed=G + hd)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    ranges = fa.decode_splits(fa.visible_keys(Sq, Skv, **kw), B * Hkv)
    n0 = dict(fa.flash_attention_cuda.launches_by)
    m, l, acc = fa.decode_partials_cuda(q, k, v, ranges, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches_by["decode_split"] == \
        n0["decode_split"] + bool(ranges)
    pm, pl, pacc = fa.attention_partials(q, k, v, ranges, **kw)
    inf = torch.isinf(pm)
    assert torch.equal(torch.isinf(m), inf)
    tol = dict(rtol=1e-4, atol=1e-4)      # f32 partials of the same inputs
    torch.testing.assert_close(m.masked_fill(inf, 0), pm.masked_fill(inf, 0),
                               **tol)
    torch.testing.assert_close(l, pl, **tol)
    torch.testing.assert_close(acc, pacc, **tol)
    got = fa.combine_cuda(pm, pl, pacc, torch.empty_like(q))
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches_by["decode_combine"] == \
        n0["decode_combine"] + 1
    want = fa.rows_to_heads(fa.combine_partials(pm, pl, pacc), Sq)
    assert fa.error_ratio(got, want.to(dtype), ATTN_TOL[dtype]) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropping_one_split_is_refused(cuda, dtype):
    """The rule the kernels are held to has the power to see a lost split:
    the kernel's partials of a decode over 1001 keys, merged by the
    combine kernel without their last split, are refused."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 4, 1, 1100, 8, 2, 128, dtype, seed=3)
    kw = dict(causal=True, q_offset=1000, kv_len=1001)
    ranges = fa.decode_splits(fa.visible_keys(1, 1100, **kw), 4 * 8)
    assert len(ranges) > 2
    m, l, acc = fa.decode_partials_cuda(q, k, v, ranges, **kw)
    cut = fa.combine_cuda(*(x[:, :, :-1].contiguous() for x in (m, l, acc)),
                          torch.empty_like(q))
    torch.cuda.synchronize()
    assert fa.error_ratio(cut, fa.attention(q, k, v, **kw),
                          ATTN_TOL[dtype]) > 1


# head dim 64 past the first key tile: with Q.K^T and P.V both m64n64k16,
# nvcc put P in the registers of Q, which the next tile still reads, and
# these shapes came out wrong (the kernel now runs P.V as two n32
# halves): (B, Sq, Skv, Hkv, G, causal)
HD64_PAST_FIRST_TILE = [
    (1, 64, 65, 1, 1, False), (1, 64, 65, 1, 2, False),
    (1, 64, 128, 1, 1, False), (1, 64, 128, 1, 2, False),
    (1, 70, 70, 1, 1, True), (1, 70, 70, 1, 2, True),
]


@pytest.mark.parametrize("B,Sq,Skv,Hkv,G,causal", HD64_PAST_FIRST_TILE)
def test_prefill_mma_head_dim_64_past_the_first_key_tile(cuda, B, Sq, Skv,
                                                         Hkv, G, causal):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, B, Sq, Skv, Hkv, G, 64, torch.bfloat16,
                           seed=Skv + G)
    assert fa.variant_of(q, k) == "prefill_mma"
    _hold_attention(q, k, v, causal=causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,G", [(1, 2), (8, 2), (9, 2), (1, 16), (1, 32),
                                  (40, 1)])
def test_dispatch_launches_the_named_variant(cuda, dtype, Sq, G):
    """``launches_by`` counts the variant the dispatch rule names (bf16
    prefill: tensor cores; f32 prefill: CUDA cores; G * Sq <= 16: split
    and combine), and ``launches`` their total."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 2, Sq, 90, 2, G, 64, dtype, seed=Sq * G)
    want = ("decode_split" if Sq * G <= fa.SPLIT_ROWS else
            "prefill_mma" if dtype == torch.bfloat16 else "tiled_f32")
    assert fa.variant_of(q, k) == want
    _hold_attention(q, k, v, causal=True, q_offset=50, kv_len=50 + Sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 8])
def test_flash_attention_hd112_matches_plain(cuda, dtype, G):
    """Head dim 112 (kimi-k2): the prefill kernel of the dtype (bf16: the
    tensor cores on the zero-padded hd 128 tiles; f32: the CUDA cores)
    over odd lengths, into a longer cache and at an offset with an odd
    kv_len, and through the training case's ``with_lse`` at 1 and 27
    queries; decode steps through split and combine."""
    from repro_torch.kernels import flash_attention as fa
    Hkv = 1 if G == 8 else 2
    q, k, v = _attn_inputs(cuda, 2, 27, 131, Hkv, G, 112, dtype,
                           seed=112 + G)
    want_prefill = "prefill_mma" if dtype == torch.bfloat16 else "tiled_f32"
    assert fa.variant_of(q, k) == want_prefill
    _hold_attention(q, k[:, :27].contiguous(), v[:, :27].contiguous(),
                    causal=True)
    _hold_attention(q, k, v, causal=False)
    _hold_attention(q, k, v, causal=True, q_offset=0, kv_len=27)
    _hold_attention(q, k, v, causal=True, q_offset=100, kv_len=127)
    for off, kv_len in ((70, 71), (130, 131), (150, 151)):
        assert fa.variant_of(q[:, :1], k) == "decode_split"
        _hold_attention(q[:, :1].contiguous(), k, v, causal=True,
                        q_offset=off, kv_len=kv_len)
    for Sq in (1, 27):
        qs, ks, vs = (x[:, :Sq].contiguous() for x in (q, k, v))
        n0 = fa.flash_attention_cuda.launches_by[want_prefill]
        out, lse = fa.flash_attention_cuda(qs, ks, vs, causal=True,
                                           with_lse=True)
        torch.cuda.synchronize()
        assert fa.flash_attention_cuda.launches_by[want_prefill] == n0 + 1
        wo, wl = fa.attention(qs, ks, vs, causal=True, with_lse=True)
        assert fa.error_ratio(out, wo, ATTN_TOL[dtype]) <= 1
        torch.testing.assert_close(lse, wl, rtol=1e-4, atol=1e-4)


def test_flash_attention_hd112_kimi_shapes(cuda):
    """kimi-k2's attention (64 heads over 8, hd 112, bf16): prefills of
    4095 and 4096 tokens into a 4104-entry cache (odd kv_len; the second
    at an offset of 1), and decode steps of 4 rows over it, the last past
    the cache."""
    q, k, v = _attn_inputs(cuda, 1, 4096, 4104, 8, 8, 112, torch.bfloat16)
    _hold_attention(q[:, :4095].contiguous(), k, v, causal=True, q_offset=0,
                    kv_len=4095)
    _hold_attention(q, k, v, causal=True, q_offset=1, kv_len=4097)
    q, k, v = _attn_inputs(cuda, 4, 1, 4104, 8, 8, 112, torch.bfloat16,
                           seed=1)
    for off in (0, 2047, 4103, 4200):
        _hold_attention(q, k, v, causal=True, q_offset=off, kv_len=off + 1)


def test_attention_backward_head_dims(cuda):
    """The backward kernels take hd 112 (zamba2-7b); only widths outside
    ``BWD_HEAD_DIMS`` raise: the wrapper at hd 96 raises
    ``ValueError`` and launches nothing (no plain fall-back), while the
    autograd function at hd 112 launches the tensor-core pair once each
    and gives finite gradients."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 1, 80, 80, 1, 8, 96, torch.bfloat16)
    lse = torch.zeros((1, 8, 80), device=cuda)
    n0 = fa.flash_attention_backward_cuda.launches
    with pytest.raises(ValueError, match=r"attention backward takes head "
                       r"dims \(16, 32, 64, 112, 128\).*hd=96"):
        fa.flash_attention_backward_cuda(q, k, v, q, lse, q)
    assert fa.flash_attention_backward_cuda.launches == n0
    q, k, v = _attn_inputs(cuda, 1, 80, 80, 1, 8, 112, torch.bfloat16)
    qg = q.detach().requires_grad_(True)
    n0 = dict(fa.flash_attention_backward_cuda.launches_by)
    fa.FlashAttentionFn.apply(qg, k, v, True).float().sum().backward()
    torch.cuda.synchronize()
    assert {x: fa.flash_attention_backward_cuda.launches_by[x] - n0[x]
            for x in n0} == {"dq_mma": 1, "dkdv_mma": 1, "dq_f32": 0,
                             "dkdv_f32": 0}
    assert bool(torch.isfinite(qg.grad).all())


def test_attention_entry_points_refuse_hd96(cuda):
    """Past the wrapper's check: each C entry point at a head dim it has
    no instantiation for (hd 96) returns cudaErrorInvalidValue (1) from
    its ``switch (hd)``'s default and launches nothing; the wrapper at hd
    96 raises before it builds or launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    lib = _build.load()
    s = torch.cuda.current_stream().cuda_stream
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        q, k, v = _attn_inputs(cuda, 1, 40, 40, 1, 2, 96, dtype)
        o = torch.zeros_like(q)
        lse = torch.empty((1, 2, 40), device=cuda)
        p = [x.data_ptr() for x in (q, k, v, o)]
        entry = (lib.flash_attention_tiled_launch if code == 0 else
                 lib.flash_attention_wgmma_launch)
        assert entry(*p, lse.data_ptr(), 1, 40, 40, 2, 1, 96, code, 1, 0,
                     40, s) == 1
        ws = torch.empty(2 * 2 * (2 + 96), device=cuda)
        assert lib.flash_attention_split_launch(
            *p[:3], ws.data_ptr(), ws.data_ptr(), ws.data_ptr(), 1, 1, 40,
            2, 1, 96, code, 1, 39, 40, 1, 64, s) == 1
        D = torch.empty_like(lse)
        bwd = ((lib.flash_attention_bwd_dq_launch,
                lib.flash_attention_bwd_dkdv_launch) if code == 0 else
               (lib.flash_attention_bwd_dq_wgmma_launch,
                lib.flash_attention_bwd_dkdv_wgmma_launch))
        shape = (1, 40, 40, 2, 1, 96, code, 1, s)
        assert bwd[0](*p, o.data_ptr(), lse.data_ptr(), D.data_ptr(),
                      o.data_ptr(), *shape) == 1
        assert bwd[1](*p[:3], o.data_ptr(), lse.data_ptr(), D.data_ptr(),
                      o.data_ptr(), o.data_ptr(), *shape) == 1
        torch.cuda.synchronize()
        assert int(o.abs().max()) == 0
        n0 = fa.flash_attention_cuda.launches
        with pytest.raises(ValueError, match="hd=96"):
            fa.flash_attention_cuda(q, k, v)
        assert fa.flash_attention_cuda.launches == n0


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_reduced_moe_on_card_matches_cpu(cuda, name):
    """Each MoE config at its reduced width (f32) on the card: every MoE
    layer's routing decisions (experts, capacity mask) and the logits of
    a prefill equal the CPU's (logits at 1e-3: the attention kernel and
    the card's products against the CPU's), and the engine's greedy
    tokens (waves of 2) are the CPU's; the attention kernel ran."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(name).reduced()
    cpu = tfm.init_params(cfg, seed=0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    real, seen = moe.moe_block, []

    def recording(c, p, x):
        r = moe.route(c, p, x.reshape(-1, moe.group_size(c, x.shape[0] *
                                                         x.shape[1]),
                                      x.shape[-1]))
        seen.append((r.idx.cpu(), r.keep.cpu()))
        return real(c, p, x)
    moe.moe_block = recording
    try:
        lc, _ = tfm.prefill(cfg, cpu, {"tokens": toks}, max_len=40)
        n0 = fa.flash_attention_cuda.launches
        lg, _ = tfm.prefill(cfg, card, {"tokens": toks.to(cuda)}, max_len=40)
        assert fa.flash_attention_cuda.launches > n0
    finally:
        moe.moe_block = real
    n_moe = cfg.n_layers - cfg.n_dense_layers
    assert len(seen) == 2 * n_moe
    for (ic, kc), (ig, kg) in zip(seen[:n_moe], seen[n_moe:]):
        assert torch.equal(ic, ig) and torch.equal(kc, kg)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (n,))
                    .astype(np.int32), max_new_tokens=6)
            for i, n in enumerate([3, 9, 5, 12, 7, 20])]
    got = ServeEngine(cfg, card, batch_size=2, max_len=32,
                      device=cuda).run(reqs)
    want = ServeEngine(cfg, cpu, batch_size=2, max_len=32,
                       device="cpu").run(reqs)
    for g, w in zip(got, want):
        assert g.uid == w.uid
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_split_wrappers_reject_bad_arguments(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 2, 1, 300, 2, 2, 32, torch.float32)
    kw = dict(causal=True, q_offset=200, kv_len=201)
    with pytest.raises(ValueError, match="not a split"):
        fa.decode_partials_cuda(q, k, v, [(0, 100), (100, 150)], **kw)
    with pytest.raises(ValueError, match="not a split"):
        fa.decode_partials_cuda(q, k, v, [(0, 64), (64, 201), (201, 300)],
                                **kw)
    big = _attn_inputs(cuda, 1, 9, 300, 1, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="rows"):
        fa.decode_partials_cuda(*big, [(0, 64)], causal=False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.decode_partials_cuda(q.half(), k.half(), v.half(), [(0, 201)],
                                **kw)
    m, l, acc = fa.decode_partials_cuda(
        q, k, v, fa.decode_splits(201, 4), **kw)
    with pytest.raises(ValueError, match="do not fit"):
        fa.combine_cuda(m, l, acc, torch.empty_like(q[:1]))
    with pytest.raises(ValueError, match="do not fit"):
        fa.combine_cuda(m, l, acc.half(), torch.empty_like(q))
    with pytest.raises(ValueError, match="do not fit"):
        fa.combine_cuda(m.cpu(), l, acc, torch.empty_like(q))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", [False, True])
@pytest.mark.parametrize("rows,d", [(1, 32), (7, 130), (300, 512),
                                    (4096, 2048), (4, 2048), (8, 2048),
                                    (133, 2048), (4096, 256)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, model, rows, d):
    """The wrapper launches the variant norm_variant picks (rows of whole
    16-byte vectors split over a CTA at any row count, d = 130 generic)
    and matches the plain version."""
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (3 * torch.randn((rows, d), generator=gen, device=cuda)).to(dtype)
    w = 1 + 0.3 * torch.randn((d,), generator=gen, device=cuda)
    variant = rn.norm_variant(d, x.element_size())
    assert variant == ("generic" if d == 130 else "split")
    n0, by0 = rn.rmsnorm_cuda.launches, rn.rmsnorm_cuda.launches_by[variant]
    got = rn.rmsnorm_cuda(x, w, model=model)
    assert rn.rmsnorm_cuda.launches == n0 + 1
    assert rn.rmsnorm_cuda.launches_by[variant] == by0 + 1
    want = rn.rmsnorm(x, w, model=model)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=NORM_TOL[dtype], atol=NORM_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 32), (4, 2048), (133, 96),
                                    (131, 4096), (1000, 2048)])
def test_rmsnorm_variants_match_plain(cuda, dtype, rows, d):
    """Both variants, launched uncounted, in both roundings; a misaligned
    x runs the generic variant and the split variant refuses it."""
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=cuda).manual_seed(rows * d)
    x = (3 * torch.randn((rows, d), generator=gen, device=cuda)).to(dtype)
    w = 1 + 0.3 * torch.randn((d,), generator=gen, device=cuda)
    n0 = dict(rn.rmsnorm_cuda.launches_by)
    for model in (False, True):
        want = rn.rmsnorm(x, w, model=model).float()
        for variant in rn.VARIANTS:
            got = rn.launch_norm_variant(variant, x, w, model=model)
            torch.testing.assert_close(got.float(), want,
                                       rtol=NORM_TOL[dtype],
                                       atol=NORM_TOL[dtype])
    buf = torch.empty(rows * d + 1, dtype=dtype, device=cuda)
    off = buf[1:].view(rows, d)
    off.copy_(x)
    torch.testing.assert_close(rn.rmsnorm_cuda(off, w).float(),
                               rn.rmsnorm(x, w).float(),
                               rtol=NORM_TOL[dtype], atol=NORM_TOL[dtype])
    assert rn.rmsnorm_cuda.launches_by["generic"] == n0["generic"] + 1
    with pytest.raises(RuntimeError, match="split variant"):
        rn.launch_norm_variant("split", off, w)


def test_lm_wrappers_reject_bad_arguments(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    q, k, v = _attn_inputs(cuda, 1, 4, 8, 2, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="on"):
        fa.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_cuda(*_attn_inputs(cuda, 1, 4, 8, 2, 2, 48,
                                              torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2).contiguous()
                                .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_cuda(q, k, v, q_offset=-1)
    x = torch.randn((4, 64), device=cuda)
    with pytest.raises(ValueError, match="on"):
        rn.rmsnorm_cuda(x, torch.ones(64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rn.rmsnorm_cuda(x.half(), torch.ones(64, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        rn.rmsnorm_cuda(x, torch.ones(63, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        rn.rmsnorm_cuda(x.T, torch.ones(4, device=cuda))


def test_out_of_vocabulary_prompt_on_the_card(cuda):
    """Prompt ids >= V and < 0 (ROADMAP C7) are served on the card
    without a device assert, as the CPU engine serves them and as the
    same prompt with its ids mapped as jnp indexing maps them."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("internlm2-1.8b").reduced()
    cpu = tfm.init_params(cfg, seed=0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(cuda), cpu)
    V = cfg.vocab
    raw = np.array([1, 2, V + 3, -5, -V - 7, 3 * V, 17], np.int32)
    rows = tfm.vocab_rows(torch.from_numpy(raw), V).numpy().astype(np.int32)
    reqs = [Request(uid=0, prompt=raw, max_new_tokens=5),
            Request(uid=1, prompt=rows, max_new_tokens=5)]
    got = ServeEngine(cfg, card, batch_size=2, max_len=24,
                      device=cuda).run(reqs)
    torch.cuda.synchronize()
    want = ServeEngine(cfg, cpu, batch_size=2, max_len=24,
                       device="cpu").run(reqs)
    np.testing.assert_array_equal(got[0].tokens, got[1].tokens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_label_past_the_vocabulary_on_the_card(cuda):
    """A label >= V (ROADMAP C10) makes the loss NaN on the card, as the
    JAX package's does, without a device assert: the next kernel launch
    on the same context succeeds and the in-range loss is finite."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tfm
    cfg = get_arch("internlm2-1.8b").reduced()
    params = tfm.init_params(cfg, seed=0, device=cuda)
    batch = SyntheticLM(cfg.vocab, 64, 2, seed=0).batch_for_step(0)
    for label, finite in ((cfg.vocab, False), (3 * cfg.vocab, False),
                          (cfg.vocab - 1, True)):
        batch["labels"][1, 7] = label
        with torch.no_grad():
            loss, aux = tfm.loss_fn(cfg, params, batch)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(loss)) == finite, (label, float(loss))
        assert float(aux["tokens"]) == 2 * 64
    q, k, v = _attn_inputs(cuda, 1, 64, 64, 2, 2, 64, torch.bfloat16)
    out = fa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert fa.error_ratio(out, fa.attention(q, k, v),
                          ATTN_TOL[torch.bfloat16]) <= 1


def test_reduced_serve_engine_cuda_matches_cpu(cuda):
    """internlm2-1.8b reduced (f32) served on the card through both
    kernels answers as the plain versions on the CPU do: prefill logits
    within 1e-3, the same greedy tokens."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("internlm2-1.8b").reduced()
    cpu = tfm.init_params(cfg, seed=0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 11)).astype(np.int32))
    lc, _ = tfm.prefill(cfg, cpu, {"tokens": toks}, max_len=24)
    lg, _ = tfm.prefill(cfg, card, {"tokens": toks.to(cuda)}, max_len=24)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (n,))
                    .astype(np.int32), max_new_tokens=6)
            for i, n in enumerate([3, 9, 5, 12, 7, 20])]
    n0 = (fa.flash_attention_cuda.launches, rn.rmsnorm_cuda.launches)
    got = ServeEngine(cfg, card, batch_size=4, max_len=24,
                      device=cuda).run(reqs)
    assert fa.flash_attention_cuda.launches > n0[0]
    assert rn.rmsnorm_cuda.launches > n0[1]
    want = ServeEngine(cfg, cpu, batch_size=4, max_len=24,
                       device="cpu").run(reqs)
    for g, w in zip(got, want):
        assert g.uid == w.uid
        np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "starcoder2-7b",
                                  "rwkv6-1.6b", "command-r-plus-104b"])
def test_reduced_families_served_on_card_match_cpu(cuda, name):
    """Each family of the slice at its reduced width (f32) served on the
    card answers as on the CPU: the same greedy tokens; the attention
    families launch the attention kernel."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(name).reduced()
    cpu = tfm.init_params(cfg, seed=0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (n,))
                    .astype(np.int32), max_new_tokens=6)
            for i, n in enumerate([3, 9, 5, 12, 7, 20])]
    n0 = fa.flash_attention_cuda.launches
    got = ServeEngine(cfg, card, batch_size=3, max_len=32,
                      device=cuda).run(reqs)
    torch.cuda.synchronize()
    assert (fa.flash_attention_cuda.launches > n0) != cfg.rwkv
    want = ServeEngine(cfg, cpu, batch_size=3, max_len=32,
                       device="cpu").run(reqs)
    for g, w in zip(got, want):
        assert g.uid == w.uid
        np.testing.assert_array_equal(g.tokens, w.tokens)


# ---------------------------------------------------------------------------
# the "torch" backend and compile() on the card
# ---------------------------------------------------------------------------
TORCH_ALU_EDGES = {
    "int32": [-(2 ** 31), -(2 ** 31) + 1, -40, -2, -1, 0, 1, 5, 31, 32, 33,
              40, 2 ** 31 - 1],
    "uint32": [0, 1, 2, 5, 7, 31, 32, 40, 2 ** 31, 2 ** 32 - 1],
    "float32": [-np.inf, -200.0, -13.0, -1.5, -0.0, 0.0, 0.5, 1.0, 13.0,
                126.0, 200.0, np.inf],
}


@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32"])
def test_torch_alu_edges_on_card(cuda, dtype):
    """The torch ALU on the card against alu_numpy on the JAX package's
    edge operands, bit for bit: int32 wraps (INT_MIN // -1, shifts past
    the clip), uint32 in its int64 carrier, float signed zeros and exp2
    at every integral shift in [-149, 126] (C8; fractional shifts are
    the CPU tests' part)."""
    from repro_torch.core.engine import (_alu_op, alu_numpy, from_carrier,
                                         to_carrier)
    from repro_torch.core.graph import Op
    from repro_torch.testing import tokens_equal
    dt = np.dtype(dtype)
    vals = np.asarray(TORCH_ALU_EDGES[dtype], dt)
    A, B = np.meshgrid(vals, vals)
    a, b = A.ravel(), B.ravel()
    for op in Op:
        if op in (Op.DMERGE, Op.NDMERGE):
            continue
        x, y = a, b
        if dtype == "float32" and op in (Op.SHL, Op.SHR):
            X, Y = np.meshgrid(vals, np.arange(-149, 127, dtype=dt))
            x, y = X.ravel(), Y.ravel()
        got = from_carrier(_alu_op(op, to_carrier(x, dt, cuda),
                                   to_carrier(y, dt, cuda), dt), dt)
        with np.errstate(all="ignore"):
            want = np.asarray(alu_numpy(op, x, y, dt), dt)
        assert tokens_equal(got, want), (op, dtype)


@pytest.mark.parametrize("dtype,ts", [("int32", ()), ("uint32", ()),
                                      ("float32", ()), ("float32", (4,))])
def test_torch_backend_on_card(cuda, dtype, ts):
    """"torch" engines and compile()'s executors on the card against
    run_reference: 4 benches and 4 random fabrics, dense and optimized,
    profiled, solo and batched."""
    from repro_torch.core import compile as tcomp
    from repro_torch.testing import edge_feeds, tokens_equal
    dt = np.dtype(dtype)
    cases = []
    for name in ("fibonacci", "dot_prod", "pop_count", "bubble_sort"):
        bench = _bench(name)
        fb = [library.random_feeds(name, bench, 2 + 3 * s,
                                   np.random.default_rng(s))
              for s in range(3)]
        cases.append((bench.graph, fb))
    for seed in range(4):
        g = random_graph(seed, dtype=dt)
        fb = [edge_feeds(g, dt, 1 + s, np.random.default_rng(seed + s))
              for s in range(3)]
        cases.append((g, fb))
    for g, fb in cases:
        if ts:
            fb = [{a: np.asarray(v)[:, None] + np.arange(4, dtype=dt)
                   for a, v in f.items()} for f in fb]
        wants = [run_reference(g, f, ts, dt, max_cycles=400, profile=True)
                 for f in fb]
        for opt in (False, True):
            eng = DataflowEngine(g, backend="torch", block_cycles=1,
                                 max_cycles=400, device=cuda, optimize=opt,
                                 profile=True, token_shape=ts, dtype=dt)
            got = [eng.run(f) for f in fb] + eng.run_batch(fb)
            for r, w in zip(got, wants + wants):
                assert_same_result(r, w, (g.name, opt), dispatches=False,
                                   profile=eng.block_cycles == 1)
        run = tcomp.compile(g, ts, dt, max_cycles=400, backend="unrolled",
                            device=cuda)
        for f, w in zip(fb, wants):
            assert_same_result(run(f), w, (g.name, "unrolled"),
                               dispatches=False)
        if tcomp.GraphTraits.probe(g).tokens_out_static:
            out = tcomp.compile(g, ts, dt, backend="dag", device=cuda)(fb[1])
            for a, v in out.items():
                assert tokens_equal(v[-1], wants[1].outputs[a])


def test_compile_cuda_launches_the_kernels(cuda):
    """compile(backend="cuda") reaches the kernels: optimize="sched" the
    scheduled-run kernel, optimize="full" with profile=True the profiled
    and specialized fire blocks, single-stream and batched."""
    from repro_torch.core import compile as tcomp
    bench = _bench("dot_prod")
    f = library.random_feeds("dot_prod", bench, 6, np.random.default_rng(0))
    fb = [f] * 3
    one, bat = df.fire_block_cuda, df.fire_block_batched_cuda
    n = ksf.sched_run_cuda.launches
    run = tcomp.compile(bench.graph, backend="cuda", optimize="sched",
                        device=cuda)
    assert_same_result(run(f), run_reference(bench.graph, f), "sched",
                       dispatches=False)
    run.engine.run_batch(fb)
    assert ksf.sched_run_cuda.launches == n + 2
    counts = (one.prof_launches, one.spec_launches, bat.prof_launches,
              bat.spec_launches)
    run = tcomp.compile(bench.graph, backend="cuda", optimize="full",
                        profile=True, device=cuda)
    assert_same_result(run(f), run_reference(bench.graph, f), "full",
                       dispatches=False)
    run.engine.run_batch(fb)
    after = (one.prof_launches, one.spec_launches, bat.prof_launches,
             bat.spec_launches)
    assert all(x > y for x, y in zip(after, counts)), (counts, after)


# ---------------------------------------------------------------------------
# traced programs (repro_torch.front) on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(library.TRACED))
def test_traced_digest_on_the_cards_torch(cuda, name):
    """This machine's torch traces the fabric the CPU tests pinned."""
    from repro_torch.testing import TRACED_ASM_SHA256, asm_sha256
    assert asm_sha256(library.BENCHES[name]().graph) == \
        TRACED_ASM_SHA256[name]


def test_traced_gcd_served_on_card(cuda):
    """DataflowServer.for_fn(gcd) on the card: every result is math.gcd,
    sampled ones equal a solo run_reference in every field, and each
    block is one batched fire-block launch."""
    import math
    bench = library.gcd_graph()
    fn, avals, kw = bench.program
    srv = DataflowServer.for_fn(fn, *avals, slots=64, block_cycles=64,
                                device=cuda, **kw)
    ab = np.random.default_rng(7).integers(1, 257, (200, 2))
    n0 = df.fire_block_batched_cuda.launches
    uids = [srv.submit_args(int(a), int(b)) for a, b in ab]
    res = {r.uid: r for r in srv.drain()}
    assert df.fire_block_batched_cuda.launches - n0 == srv.block
    out = srv.traced.out_arc
    for uid, (a, b) in zip(uids, ab):
        r = res[uid]
        assert r.status == "ok"
        assert int(r.engine.outputs[out]) == math.gcd(int(a), int(b))
    for i in range(0, 200, 13):
        a, b = (int(v) for v in ab[i])
        assert_same_result(res[uids[i]].engine,
                           run_reference(bench.graph, srv.make_feeds(a, b)),
                           (a, b), dispatches=False)


def test_dot_prod_traced_on_cuda_matches_hand_built(cuda):
    """compile_fn(..., backend="cuda") of dot_prod_traced drains the
    hand-built dot_prod's values and token counts on the card."""
    from repro_torch.core.compile import compile_fn
    tb, hb = _bench("dot_prod_traced"), _bench("dot_prod")
    fn, avals, kw = tb.program
    run = compile_fn(fn, *avals, backend="cuda", block_cycles=64,
                     device=cuda, **kw)
    hand = DataflowEngine(hb.graph, block_cycles=64, device=cuda)
    for seed, k in ((0, 1), (1, 33), (2, 300)):
        ft = library.random_feeds("dot_prod_traced", tb, k,
                                  np.random.default_rng(seed))
        fh = library.random_feeds("dot_prod", hb, k,
                                  np.random.default_rng(seed))
        got, want = run(ft), hand.run(fh)
        assert got.counts[run.out_arcs[0]] == want.counts["dot"] == k
        assert int(got.outputs[run.out_arcs[0]]) == int(want.outputs["dot"])
        assert_same_result(got, run_reference(tb.graph, ft), (seed, k),
                           dispatches=False)


# ---------------------------------------------------------------------------
# the sharded block kernel (partition=)
# ---------------------------------------------------------------------------
MF_STATE = ("full", "val", "ptr", "out_last", "out_count")


def _mf_served_state(cuda, name, P, opt, slots=16, blocks=2):
    """A partitioned engine's slot state on the card after a few served
    blocks (random feed lengths, a quarter of the slots parked), with
    random counters."""
    from repro_torch.kernels import multifabric as kmf
    bench = library.BENCHES[name]()
    eng = DataflowEngine(bench.graph, block_cycles=8, device=cuda,
                         partition=P, optimize=opt, profile=True)
    rng = np.random.default_rng(P)
    st = eng.init_state(slots)
    ids = [b for b in range(slots) if b % 4 != 3]
    st = eng.reset_slots(st, ids, [library.random_feeds(
        name, bench, int(rng.integers(1, 40)), rng) for _ in ids])
    for _ in range(blocks):
        st = eng.step_block(st)
    for x in (*st.prof, *st.mf["chprof"]):
        x.copy_(torch.randint_like(x, 0, 50))
    st.mf["chprof"][1].clamp_(0, 1)
    st.prof[4].clamp_(0, 1)
    return eng._mf.tabs, st, kmf


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", ["dot_prod", "bubble_sort", "fibonacci",
                                  "pop_count"])
def test_multifabric_kernel_matches_plain(cuda, name, P):
    """Each variant of the sharded block kernel (the warp variant these
    tables take, the CTA variant forced; feed windows restaged every 2
    cycles too) against the plain block, bit for bit, on served states."""
    from functools import partial
    for opt in (False, True):
        tabs, st, kmf = _mf_served_state(cuda, name, P, opt)
        assert tabs.variant == "warp"
        launches = {v: partial(kmf.launch_mf, variant=v)
                    for v in kmf.VARIANTS}
        launches["warp, chunk 2"] = partial(kmf.launch_mf, variant="warp",
                                            chunk=2)
        for K in (1, 16, 65):
            for prof in (False, True):
                runs = {}
                for what, fn in (*launches.items(), ("plain", kmf.mf_block)):
                    if what.endswith("chunk 2") and K < 2:
                        continue
                    x = [getattr(st, k).clone() for k in MF_STATE]
                    ch = [st.mf[k].clone() for k in ("chf", "chv")]
                    pr = [v.clone() for v in (*st.prof, *st.mf["chprof"])]
                    f, lp = fn(tabs, st.fv, st.fl, *x, *ch, n_cycles=K,
                               active=st.active_dev,
                               prof=pr[:5] if prof else None,
                               chprof=pr[5:] if prof else None)
                    torch.cuda.synchronize()
                    runs[what] = [f, lp, *x, *ch, *(pr if prof else [])]
                want = runs.pop("plain")
                for what, got in runs.items():
                    for a, b in zip(got, want):
                        assert torch.equal(a, b), (name, P, opt, K, prof,
                                                   what)


def test_multifabric_launches_by_counts_the_variant_that_ran(cuda):
    """The wrapper launches the tables' variant and counts it: dot_prod's
    regions fit one warp, a 150-node random fabric's take a CTA; both
    runs equal the numpy oracle."""
    from repro_torch.kernels import multifabric as kmf
    from repro_torch.testing import edge_feeds
    rng = np.random.default_rng(11)
    for g, want in ((library.dot_product_graph(32).graph, "warp"),
                    (random_graph(5, nodes=150), "cta")):
        feeds = [edge_feeds(g, np.int32, k, rng) for k in (3, 1, 6)]
        eng = DataflowEngine(g, block_cycles=16, device=cuda, partition=2,
                             profile=True)
        assert eng._mf.tabs.variant == want
        by0 = dict(kmf.mf_block_cuda.launches_by)
        got = eng.run_batch(feeds)
        torch.cuda.synchronize()
        assert kmf.mf_block_cuda.launches_by == dict(
            by0, **{want: by0[want] + got[0].dispatches})
        for r, f in zip(got, feeds):
            ref = run_reference(g, f, profile=True)
            assert_same_result(r, ref, (g.name, want), dispatches=False)


def test_multifabric_engine_and_server_on_card(cuda):
    from repro_torch.kernels import multifabric as kmf
    for name in sorted(library.HAND_BUILT):
        bench = library.BENCHES[name]()
        feeds = [library.random_feeds(name, bench, k,
                                      np.random.default_rng(k))
                 for k in (3, 1, 6)]
        for P in (2, 4):
            n0 = kmf.mf_block_cuda.prof_launches
            eng = DataflowEngine(bench.graph, block_cycles=16, device=cuda,
                                 partition=P, optimize=True, profile=True)
            got = eng.run_batch(feeds)
            assert kmf.mf_block_cuda.prof_launches - n0 == \
                got[0].dispatches
            for g, f in zip(got, feeds):
                ref = run_reference(bench.graph, f, profile=True)
                assert_same_result(g, ref, (name, P), dispatches=False)
                np.testing.assert_array_equal(g.node_fires, ref.node_fires)
                g.profile.check()
    bench = library.dot_product_graph(8)
    srv = DataflowServer(bench.graph, slots=8, block_cycles=16, device=cuda,
                         partition=2)
    reqs = [library.random_feeds("dot_prod", bench, k,
                                 np.random.default_rng(k))
            for k in range(1, 20)]
    for r, f in zip(srv.run(reqs), reqs):
        assert_same_result(r.engine, run_reference(bench.graph, f),
                           r.uid, dispatches=False)


# ---------------------------------------------------------------------------
# the backward kernels (attention dQ and dK/dV, RMSNorm and its reduction)
# and the training step on the card
# ---------------------------------------------------------------------------
# gradients by ``flash_attention.grad_error_ratio`` (rtol = tol, atol = tol
# x min(1, the tensor's RMS): a gradient row can be 0 in exact arithmetic),
# at the forward's tolerances; RMSNorm's dx and dw as allclose
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("G,causal", [(1, True), (2, True), (2, False),
                                      (3, False)])
def test_attention_backward_kernels_match_plain(cuda, dtype, hd, G, causal):
    from repro_torch.kernels import flash_attention as fa
    S = 333 if hd <= 64 else 130
    q, k, v = _attn_inputs(cuda, 2, S, S, 2, G, hd, dtype, seed=hd * G)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(1), device=cuda).to(dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                       with_lse=True)
    pout, plse = fa.attention(q, k, v, causal=causal, with_lse=True)
    assert fa.error_ratio(out, pout, ATTN_TOL[dtype]) <= 1
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    n0 = dict(fa.flash_attention_backward_cuda.launches_by)
    got = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                           causal=causal)
    torch.cuda.synchronize()
    want_by = dict.fromkeys(fa.BWD_VARIANTS, 0)
    want_by.update(dict.fromkeys(fa.bwd_variant_of(q), 1))
    assert fa.bwd_variant_of(q) == (("dq_mma", "dkdv_mma")
                                    if dtype == torch.bfloat16
                                    else ("dq_f32", "dkdv_f32"))
    assert {x: fa.flash_attention_backward_cuda.launches_by[x] - n0[x]
            for x in n0} == want_by
    want = fa.attention_backward(q, k, v, out, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert fa.grad_error_ratio(g, w, ATTN_TOL[dtype]) <= 1
    again = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                             causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,causal", [(100, 260, True),
                                           (100, 260, False),
                                           (197, 70, True), (64, 3, False)])
def test_attention_backward_kernels_unequal_lengths(cuda, dtype, Sq, Skv,
                                                     causal):
    """Sq != Skv and ragged tails: causal with more keys than queries
    (the keys past the last query get dK = dV = 0), with fewer keys, three
    keys; both routes against the plain version."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 2, Sq, Skv, 2, 2, 64, dtype, seed=Sq + Skv)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(2), device=cuda).to(dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                       with_lse=True)
    got = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                           causal=causal)
    want = fa.attention_backward(q, k, v, out, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert fa.grad_error_ratio(g, w, ATTN_TOL[dtype]) <= 1
    if causal and Skv > Sq:
        assert not got[1][:, Sq:].any() and not got[2][:, Sq:].any()


def test_attention_backward_stablelm_shape(cuda):
    """stablelm-1.6b's heads (32 over 32, hd 64) at seq 256 in bf16: the
    tensor-core backward against the plain one."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 2, 256, 256, 32, 1, 64, torch.bfloat16,
                           seed=64)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(3), device=cuda).to(torch.bfloat16)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    assert fa.bwd_variant_of(q) == ("dq_mma", "dkdv_mma")
    got = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                           causal=True)
    want = fa.attention_backward(q, k, v, out, lse, do, causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert fa.grad_error_ratio(g, w, ATTN_TOL[torch.bfloat16]) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_zamba2_shape(cuda, dtype):
    """zamba2-7b's heads (32 over 32, hd 112: the tensor cores on zero-
    padded hd 128 tiles in bf16, the CUDA-core kernels in f32) at seq 320
    (5 tiles) against the plain backward, causal and not, two calls
    byte-equal; dQ, dK and dV hold 112 dims."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 1, 320, 320, 32, 1, 112, dtype, seed=112)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(4), device=cuda).to(dtype)
    for causal in (True, False):
        out, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                           with_lse=True)
        got = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                               causal=causal)
        want = fa.attention_backward(q, k, v, out, lse, do, causal=causal)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert fa.grad_error_ratio(g, w, ATTN_TOL[dtype]) <= 1
        again = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                 causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_reduced_hybrid_on_card_matches_cpu(cuda):
    """zamba2-7b at its reduced width (f32) on the card: a prefill and 6
    teacher-forced decode steps give the CPU's logits (1e-3: the kernels
    and the card's products against the CPU's) and the Mamba states, the
    engine's greedy tokens are the CPU's, and one training step's loss
    and gradients are the CPU's (1e-3 relative); the attention kernels
    (forward and backward) and RMSNorm at d_in ran."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("zamba2-7b").reduced()
    cpu = tfm.init_params(cfg, seed=0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (6, 4, 1)).astype(np.int32)
    n0 = (fa.flash_attention_cuda.launches, rn.rmsnorm_cuda.launches)
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        logits, cache = tfm.prefill(cfg, params, {"tokens": torch.from_numpy(
            toks).to(dev)}, max_len=40)
        out = [logits.cpu()]
        for t in steps:
            logits, cache = tfm.decode_step(cfg, params, torch.from_numpy(
                t).to(dev), cache)
            out.append(logits.cpu())
        if dev == "cpu":
            want, want_h = out, cache["h"]
    assert fa.flash_attention_cuda.launches > n0[0]
    assert rn.rmsnorm_cuda.launches > n0[1]
    for g, w in zip(out, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(cache["h"].cpu(), want_h, rtol=1e-3,
                               atol=1e-3)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (n,))
                    .astype(np.int32), max_new_tokens=6)
            for i, n in enumerate([3, 9, 5, 12, 7, 20])]
    got = ServeEngine(cfg, card, batch_size=2, max_len=32,
                      device=cuda).run(reqs)
    want = ServeEngine(cfg, cpu, batch_size=2, max_len=32,
                       device="cpu").run(reqs)
    for g, w in zip(got, want):
        assert g.uid == w.uid
        np.testing.assert_array_equal(g.tokens, w.tokens)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=2,
                        seed=0).batch_for_step(0)
    n0 = fa.flash_attention_backward_cuda.launches
    res = []
    for params in (cpu, card):
        flat, treedef = pytree.flatten(params)
        leaves = [x.detach().requires_grad_(True) for x in flat]
        loss, _ = tfm.loss_fn(cfg, pytree.unflatten(treedef, leaves), batch)
        res.append((float(loss.detach()), [g.cpu() for g in
                                  torch.autograd.grad(loss, leaves)]))
    assert fa.flash_attention_backward_cuda.launches > n0
    assert abs(res[0][0] - res[1][0]) <= 1e-3 * abs(res[0][0])
    for w, g in zip(res[0][1], res[1][1]):
        assert float((g - w).norm()) <= 1e-3 * float(w.norm()) + 1e-12


def test_bf16_backward_launches_no_f32_kernel(cuda):
    """bf16 training through FlashAttentionFn runs the tensor-core backward
    alone: no f32 CUDA-core kernel is launched."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (x.requires_grad_() for x in _attn_inputs(
        cuda, 1, 200, 200, 4, 2, 128, torch.bfloat16))
    n0 = dict(fa.flash_attention_backward_cuda.launches_by)
    fa.FlashAttentionFn.apply(q, k, v, True).float().square().sum() \
        .backward()
    torch.cuda.synchronize()
    assert {x: fa.flash_attention_backward_cuda.launches_by[x] - n0[x]
            for x in n0} == {"dq_mma": 1, "dkdv_mma": 1, "dq_f32": 0,
                             "dkdv_f32": 0}
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_attention_backward_rejects_bad_arguments(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_inputs(cuda, 1, 64, 64, 2, 2, 64, torch.bfloat16)
    out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
    assert lse.shape == (1, 4, 64) and lse.dtype == torch.float32
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward_cuda(q, k, v, out, lse[:, :2], out)
    with pytest.raises(ValueError, match="do"):
        fa.flash_attention_backward_cuda(q, k, v, out, lse, out.float())
    with pytest.raises(ValueError, match="training case"):
        fa.flash_attention_cuda(q, k, v, q_offset=3, with_lse=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(4096, 2048), (3, 130), (512, 2048),
                                    (7, 128), (300, 96), (64, 12272)])
def test_rmsnorm_backward_kernels_match_plain(cuda, dtype, rows, d):
    """The backward kernels (the model's rounding) against the plain
    version, up to the widest row they take (d = BWD_MAX_D: the partial of
    dw and the kernel's static sums fill 48 KB of shared memory)."""
    from repro_torch.kernels import rmsnorm as rn
    assert d <= rn.BWD_MAX_D
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (3 * torch.randn((rows, d), generator=gen, device=cuda)).to(dtype)
    w = 1 + 0.3 * torch.randn((d,), generator=gen, device=cuda)
    dy = torch.randn((rows, d), generator=gen, device=cuda).to(dtype)
    variant = rn.bwd_variant(d, x.element_size())
    n0 = dict(rn.rmsnorm_backward_cuda.launches_by)
    dx, dw = rn.rmsnorm_backward_cuda(x, w, dy)
    torch.cuda.synchronize()
    assert {v: rn.rmsnorm_backward_cuda.launches_by[v] - n0[v] for v in n0} \
        == {"rows": variant == "rows", "generic": variant == "generic",
            "reduce": 1}
    assert rn.rmsnorm_backward_cuda.last_plan.variant == variant
    pdx, pdw = rn.rmsnorm_backward(x, w, dy, model=True)
    tol = NORM_TOL[dtype]
    torch.testing.assert_close(dx.float(), pdx.float(), rtol=tol, atol=tol)
    # dw sums rows in another order (per-CTA partials): f32 rounding grows
    # with the row count, so its f32 tolerance is the f32 attention one; in
    # bf16 the model rounding rounds x^ to bf16 first, and a row factor one
    # ulp off the plain one's flips that rounding now and then
    dw_tol = 1e-4 if dtype == torch.float32 else NORM_TOL[dtype]
    torch.testing.assert_close(dw, pdw, rtol=dw_tol, atol=dw_tol)
    dx2, dw2 = rn.rmsnorm_backward_cuda(x, w, dy)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)     # no atomics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(4096, 2048), (512, 2048), (3, 130),
                                    (300, 96), (33, 8192)])
def test_rmsnorm_backward_partials_equal_the_replay(cuda, dtype, rows, d):
    """The backward kernel's partials against the plain replay of its walk
    (within the dw tolerance: the card's rsqrt may put the row factor an
    f32 step off the replay's, and the bf16 rounding of x r then flips),
    its reduction bit for bit the replay of the reduction on the same
    partials, and two launches byte-equal."""
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=cuda).manual_seed(rows * d)
    x = (3 * torch.randn((rows, d), generator=gen, device=cuda)).to(dtype)
    w = 1 + 0.3 * torch.randn((d,), generator=gen, device=cuda)
    dy = torch.randn((rows, d), generator=gen, device=cuda).to(dtype)
    dx = torch.empty_like(x)
    plan = rn.card_plan(x, dx, dy)
    outs = []
    for _ in range(2):
        part = torch.empty((plan.n_cta, d), device=cuda)
        dw = torch.empty((d,), device=cuda)
        rn.launch_backward(plan, x, w, dy, dx, part, dw, 1e-5)
        torch.cuda.synchronize()
        outs.append((dx.clone(), part, dw))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    _, part, dw = outs[0]
    assert torch.equal(dw.cpu(), rn.reduce_partials(part.cpu()))
    want = rn.rmsnorm_backward_partials(x.cpu(), w.cpu(), dy.cpu(),
                                        plan=plan)
    tol = 1e-5 if dtype == torch.float32 else NORM_TOL[dtype]
    torch.testing.assert_close(part.cpu(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_variants_match_plain(cuda, dtype):
    """Every variant and rows shape the backward has, at the LM's widths:
    the rows kernel at each built (vectors a lane, warps a row) that holds
    the row, the generic kernel on the same aligned rows and on a row
    shifted off 16 bytes (which the rule sends to it)."""
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=cuda).manual_seed(3)
    for rows, d in ((512, 2048), (37, 128)):
        x = (3 * torch.randn((rows, d), generator=gen, device=cuda)).to(
            dtype)
        w = 1 + 0.3 * torch.randn((d,), generator=gen, device=cuda)
        dy = torch.randn((rows, d), generator=gen, device=cuda).to(dtype)
        pdx, pdw = rn.rmsnorm_backward(x, w, dy, model=True)
        nv = d // (16 // x.element_size())
        plans = [rn.card_plan(x, x, dy, vpl, wpr)
                 for vpl, wpr in rn.ROWS_SHAPES if nv <= 32 * vpl * wpr]
        plans.append(rn.bwd_plan(rows, d, x.element_size(), "generic"))
        for plan in plans:
            dx = torch.empty_like(x)
            part = torch.empty((plan.n_cta, d), device=cuda)
            dw = torch.empty((d,), device=cuda)
            rn.launch_backward(plan, x, w, dy, dx, part, dw, 1e-5)
            torch.cuda.synchronize()
            tol = NORM_TOL[dtype]
            torch.testing.assert_close(dx.float(), pdx.float(), rtol=tol,
                                       atol=tol, msg=str(plan))
            dw_tol = 1e-4 if dtype == torch.float32 else tol
            torch.testing.assert_close(dw, pdw, rtol=dw_tol, atol=dw_tol,
                                       msg=str(plan))
    buf = torch.empty(64 * 2048 + 1, device=cuda).to(dtype)
    off = buf[1:].view(64, 2048)
    off.copy_(torch.randn((64, 2048), generator=gen, device=cuda))
    w = torch.ones((2048,), device=cuda)
    n0 = dict(rn.rmsnorm_backward_cuda.launches_by)
    dx, dw = rn.rmsnorm_backward_cuda(off, w, off)
    torch.cuda.synchronize()
    assert rn.rmsnorm_backward_cuda.launches_by["generic"] == \
        n0["generic"] + 1
    pdx, pdw = rn.rmsnorm_backward(off, w, off, model=True)
    torch.testing.assert_close(dx.float(), pdx.float(), rtol=NORM_TOL[dtype],
                               atol=NORM_TOL[dtype])


def test_rmsnorm_backward_rejects_rows_past_its_limit(cuda):
    from repro_torch.kernels import rmsnorm as rn
    d = rn.BWD_MAX_D + 8
    x = torch.ones((2, d), device=cuda)
    w = torch.ones((d,), device=cuda)
    with pytest.raises(ValueError, match=f"d <= {rn.BWD_MAX_D}"):
        rn.rmsnorm_backward_cuda(x, w, x)


def test_training_step_on_card_matches_cpu(cuda):
    """A reduced internlm2-1.8b train step on the card (every forward and
    backward kernel launched) against the same step on the CPU's plain
    versions: loss and parameters; the card's step is deterministic."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.optim import adamw
    from repro_torch.train import loop as train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("internlm2-1.8b").reduced()
    ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    batch = SyntheticLM(cfg.vocab, 64, 2, seed=0).batch_for_step(0)
    cpu = train_loop.init_state(cfg, seed=0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(cuda), cpu)
    card2 = pytree.tree_map(torch.clone, card)
    step = train_loop.make_train_step(cfg, ocfg)
    n0 = (fa.flash_attention_backward_cuda.launches,
          rn.rmsnorm_backward_cuda.launches,
          dict(fa.flash_attention_backward_cuda.launches_by))
    card, m = step(card, batch)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward_cuda.launches - n0[0] == 2 * 2
    assert rn.rmsnorm_backward_cuda.launches - n0[1] == 2 * 2 + 1
    assert {x: fa.flash_attention_backward_cuda.launches_by[x] - n0[2][x]
            for x in n0[2]} == {"dq_f32": 2, "dkdv_f32": 2, "dq_mma": 0,
                                "dkdv_mma": 0}     # f32: the CUDA cores
    cpu, mc = step(cpu, batch)
    assert float(m["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-4)
    for a, b in zip(pytree.leaves(card[0]), pytree.leaves(cpu[0])):
        assert float((a.cpu() - b).norm()) <= 1e-4 * float(b.norm())
    card2, _ = step(card2, batch)
    for a, b in zip(pytree.leaves(card), pytree.leaves(card2)):
        assert torch.equal(a, b)
