"""Port vs JAX package: the partition pass (``repro_torch.core.partition``)
and ``partition=`` through ``compile()``, the slot API and the server.

``partition_graph``, ``Partition.spec``/``cut_arcs``/``region_weights``,
``auto_partition(devices=...)`` and ``validate``'s refusals equal the JAX
package's for every hand-built bench and every traced bench that jax
0.9.0 can build, at P = 2, 3 and 4 (the assignment node for node: both
passes are deterministic); ``tests/test_torch_compile.py`` holds
``compile``'s threading of the partition.  The slot
API of a partitioned ``"cuda"`` engine (``device="cpu"``) equals the JAX
partitioned slot API through interleaved resets, steps and harvests; the
sharded server equals the JAX sharded server request for request; the
engine cache never aliases sharded and unsharded engines; and a sharded
hardened server under a seeded fault plan answers every request as the
unsharded one does, with the same block-clock trace, metrics snapshot
and events.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro.serve.dataflow_server import DataflowServer as JServer  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.graph import Graph, Op  # noqa: E402
from repro_torch.serve.dataflow_server import (DataflowServer,  # noqa: E402
                                               cached_engine,
                                               clear_engine_cache)
from repro_torch.obs import MetricsRegistry, TraceRecorder  # noqa: E402
from repro_torch.serve.faults import FaultPlan  # noqa: E402
from repro_torch.serve.types import Request  # noqa: E402
from repro_torch.testing import assert_same_result  # noqa: E402


def _jax_graph(tg):
    return jasm.parse(tasm.emit(tg), name=tg.name)


def _bench(name):
    return tlib.bubble_sort_graph(6) if name == "bubble_sort" \
        else tlib.BENCHES[name]()


def _chain_graph():
    """4-node pipeline with a const — every 2-way partition cuts it."""
    g = Graph(name="chain")
    g.const("c", 1)
    g.add(Op.ADD, ["x", "c"], ["a1"])
    g.add(Op.MUL, ["a1", "c"], ["a2"])
    g.add(Op.ADD, ["a2", "c"], ["a3"])
    g.add(Op.MUL, ["a3", "c"], ["o"])
    g.validate()
    return g


def _loop_graph():
    """Init-bearing accumulator loop + acyclic post-chain."""
    g = Graph(name="loop_post")
    g.const("one", 1)
    g.init("acc", 0)
    g.add(Op.ADD, ["acc", "inc"], ["s"])
    g.add(Op.COPY, ["s"], ["acc", "tap"])
    g.add(Op.MUL, ["tap", "one"], ["post1"])
    g.add(Op.ADD, ["post1", "one"], ["out"])
    g.validate()
    return g


def _graphs():
    """Every hand-built bench, every traced bench jax 0.9.0 builds, and
    the two hand-made fabrics above."""
    out = [_bench(n).graph for n in sorted(tlib.HAND_BUILT)]
    for name in sorted(tlib.TRACED):
        try:
            jlib.BENCHES[name]()
        except Exception:      # noqa: BLE001 — jax 0.9.0 (ROADMAP C3)
            continue
        out.append(tlib.BENCHES[name]().graph)
    return out + [_chain_graph(), _loop_graph()]


GRAPHS = _graphs()


def _outcome(mod, graph, P):
    """What a package's pass makes of (graph, P): the partition's
    identity or the refusal's message."""
    try:
        part = mod.partition_graph(graph, P)
    except ValueError as e:
        return ("refused", str(e))
    return (part.P, part.assign, part.spec(), part.cut_arcs(graph),
            part.region_weights(graph), [list(r) for r in part.regions()])


@pytest.mark.parametrize("g", GRAPHS, ids=lambda g: g.name)
def test_partition_equals_jax(g):
    jg = _jax_graph(g)
    for P in (1, 2, 3, 4):
        assert _outcome(tpart, g, P) == _outcome(jpart, jg, P), (g.name, P)
    for devices in (1, 2, 4, 8):
        a = tpart.auto_partition(g, devices=devices)
        b = jpart.auto_partition(jg, devices=devices)
        assert (a.P, a.assign) == (b.P, b.assign), (g.name, devices)


def test_validate_refusals_equal_jax():
    g = _loop_graph()
    jg = _jax_graph(g)
    for P, assign in ((2, (0, 1, 1, 1)), (2, (0, 0, 0)), (3, (0, 0, 1, 1)),
                      (2, (0, 0, 2, 1))):
        with pytest.raises(ValueError) as want:
            jpart.Partition(P, assign).validate(jg)
        with pytest.raises(ValueError) as got:
            tpart.Partition(P, assign).validate(g)
        assert str(got.value) == str(want.value)
    for spec in ("bogus", 2.5):
        with pytest.raises(ValueError):
            tpart.resolve_partition(g, spec)
    with pytest.raises(ValueError, match="[Ll]oop cycles|supernode"):
        tpart.partition_graph(g, len(g.nodes) + 1)


def test_auto_partition_counts_the_cards(monkeypatch):
    g = tlib.dot_product_graph(32).graph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tpart.auto_partition(g).P == 1        # no card: solo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tpart.auto_partition(g).P == 4
    assert tpart.resolve_partition(g, "auto").P == 4


# ---------------------------------------------------------------------------
# the engine's arguments
# ---------------------------------------------------------------------------
def test_partitioned_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clear_engine_cache()
    g = _chain_graph()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DataflowEngine(g, partition=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DataflowServer(g, partition=2)


def _slot_script(eng, bench, name):
    """Interleaved admissions, steps (one shortened), and harvests with
    a capped request; returns every harvested result in order."""
    rng = np.random.default_rng(5)
    f = [tlib.random_feeds(name, bench, k, rng) for k in (4, 2, 6, 3, 5)]
    out = []
    st = eng.init_state(4)
    st = eng.reset_slots(st, [0, 2], [f[0], f[1]])
    st = eng.step_block(st)
    st = eng.reset_slots(st, [1], [f[2]], caps=[7])
    for n in (None, 3, None):
        st = eng.step_block(st, n_cycles=n)
        done = st.quiesced_slots()
        st, res = eng.harvest(st, done)
        out += list(zip(done, res))
    free = st.free_slots()[:2]
    st = eng.reset_slots(st, free, [f[3], f[4]][:len(free)])
    for _ in range(12):
        if not st.active.any():
            break
        st = eng.step_block(st)
        busy = [b for b in range(4) if st.active[b]
                and (st.quiesced[b] or st.base[b] >= st.cap[b])]
        st, res = eng.harvest(st, busy)
        out += list(zip(busy, res))
    return out


@pytest.mark.parametrize("name,P,opt", [("vector_sum", 2, False),
                                        ("fibonacci", 2, True),
                                        ("dot_prod", 4, True)])
def test_slot_api_equals_jax(name, P, opt):
    bench = _bench(name)
    jeng = JEngine(_jax_graph(bench.graph), backend="xla", block_cycles=4,
                   partition=P, optimize=opt, profile=True)
    eng = DataflowEngine(bench.graph, block_cycles=4, device="cpu",
                         partition=P, optimize=opt, profile=True)
    want, got = _slot_script(jeng, bench, name), _slot_script(eng, bench,
                                                              name)
    assert [b for b, _ in got] == [b for b, _ in want] and got
    for (b, g), (_, w) in zip(got, want):
        assert_same_result(g, w, (name, P, b), profile=True)


def test_slot_api_refused_on_torch_backend():
    bench = _bench("vector_sum")
    eng = DataflowEngine(bench.graph, backend="torch", device="cpu",
                         partition=2)
    with pytest.raises(ValueError, match='backend="cuda"'):
        eng.init_state(2)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
def test_server_sharded_equals_jax():
    g = _chain_graph()
    batches = [{"x": [1, 2]}, {"x": [9]}, {"x": [3, 1, 4]}, {"x": [7] * 6},
               {"x": [5, 5]}]
    srv = DataflowServer(g, slots=2, block_cycles=4, device="cpu",
                         partition=2, profile=True)
    jsrv = JServer(_jax_graph(g), slots=2, block_cycles=4, backend="xla",
                   partition=2, profile=True)
    assert srv.engine._part_on and jsrv.engine._part_on
    got = {r.uid: r for r in srv.run(batches)}
    want = {r.uid: r for r in jsrv.run(batches)}
    assert sorted(got) == sorted(want)
    for uid in got:
        assert got[uid].status == want[uid].status == "ok"
        assert_same_result(got[uid].engine, want[uid].engine, uid,
                           profile=True)
        assert got[uid].metrics.residency_blocks == \
            want[uid].metrics.residency_blocks


def test_cached_engine_partition_collision():
    """Sharded and unsharded engines of one asm signature never alias, nor
    do two region assignments; a P = 1 partition is the unsharded key."""
    g = _chain_graph()
    clear_engine_cache()
    solo = cached_engine(g, block_cycles=4, device="cpu")
    p2 = cached_engine(g, block_cycles=4, device="cpu", partition=2)
    assert solo is not p2
    assert not solo._part_on and p2._part_on
    other = cached_engine(g, block_cycles=4, device="cpu",
                          partition=tpart.Partition(2, (0, 1, 1, 1)))
    assert other is not p2
    assert cached_engine(g, block_cycles=4, device="cpu",
                         partition=2) is p2
    assert cached_engine(g, block_cycles=4, device="cpu",
                         partition=1) is solo
    assert DataflowServer(g, block_cycles=4, device="cpu",
                          partition=2).engine is p2


def _hardened(partition):
    """A seeded fault plan over the vector_sum server: poisoned feeds, a
    wedged request, and dispatch faults at blocks 6 and 12 that outlive
    the heartbeat's three retries (the residents are answered with the
    error, harvested from the state the failed launch never replaced) and
    clear at the next heartbeat's launch."""
    bench = tlib.vector_sum_graph(8)
    plan = FaultPlan(seed=11, poison_rate=0.25, wedge_uids=(8,),
                     dispatch_fail_blocks=(6, 12), transient_attempts=5)
    srv = DataflowServer(bench.graph, slots=3, block_cycles=2,
                         max_retries=3, wedge_timeout_blocks=4, faults=plan,
                         trace=TraceRecorder(), metrics=MetricsRegistry(),
                         device="cpu", partition=partition, profile=True)
    results = []
    for uid in range(1, 15):
        srv.submit(Request(uid=uid, feeds=tlib.random_feeds(
            "vector_sum", bench, 1 + (3 * uid) % 6,
            np.random.default_rng(100 + uid)),
            max_cycles=5 if uid in (1, 9) else None))
        if uid % 2 == 0:
            results += srv.step()
    return srv, sorted(results + srv.drain(), key=lambda r: r.uid)


def _block_trace(tr):
    out = tr.to_chrome("block")
    for ev in out["traceEvents"]:
        ev.get("args", {}).pop("wall_s", None)
    return out


def test_hardened_server_sharded_equals_unsharded():
    srv, got = _hardened(2)
    assert srv.engine._part_on
    solo, want = _hardened(None)
    # the lifecycle trace (block clock) and the metrics snapshot agree too
    assert _block_trace(srv.trace) == _block_trace(solo.trace)
    assert srv.metrics.snapshot() == solo.metrics.snapshot()
    assert srv.events == solo.events
    assert [r.uid for r in got] == [r.uid for r in want] == list(range(1, 15))
    statuses = {r.status for r in got}
    assert {"ok", "wedged", "truncated", "error"} <= statuses
    for g, w in zip(got, want):
        assert (g.status, repr(g.error)) == (w.status, repr(w.error)), g.uid
        assert_same_result(g.engine, w.engine, g.uid, profile=True,
                           channels=False)
        assert dataclasses.asdict(g.metrics) == dataclasses.asdict(w.metrics)
    kinds = [e["kind"] for e in srv.events]
    assert kinds.count("dispatch-failed") == 2 and "poison" in kinds
