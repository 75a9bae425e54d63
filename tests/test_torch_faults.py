"""Fault injection and the port's hardened server.

``repro_torch.serve.faults.FaultPlan`` makes every decision the JAX
package's plan makes for the same seed and key (the sha256 coin, dispatch
faults, wedges, poison and its output, the injection log).  The server
tests mirror tests/test_server_robustness.py (watchdog, transient retry,
poison isolation, strict harvest accounting) and the chaos soak of
tests/test_server_soak.py on the port alone (``device="cpu"``: the
kernels' plain versions), and pin what the port does in place of the
JAX server's degradation chain: an injected fault that outlives its
retries answers every resident request with a typed error and the server
goes on; a planned compile fault raises from the constructor; any other
exception from a launch propagates on its first attempt, unretried.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import faults as jfaults  # noqa: E402
from repro_torch.core import library  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.obs import (MetricsRegistry, TraceRecorder,  # noqa: E402
                             validate_chrome, validate_snapshot)
from repro_torch.serve import faults  # noqa: E402
from repro_torch.serve.dataflow_server import DataflowServer  # noqa: E402
from repro_torch.serve.faults import (CompileFault,  # noqa: E402
                                      DispatchFault, FaultPlan,
                                      InjectedFault)
from repro_torch.serve.types import Request  # noqa: E402
from repro_torch.testing import assert_same_result  # noqa: E402

PLANS = {
    "rates": dict(dispatch_fail_rate=0.3, transient_attempts=2,
                  wedge_rate=0.2, poison_rate=0.25),
    "explicit": dict(dispatch_fail_blocks=(0, 3, 4), transient_attempts=1,
                     wedge_uids=(2, 5), poison_uids=(1, 7),
                     compile_fail=("cuda", "xla")),
    "persistent": dict(persistent_backends=("cuda", "xla"),
                       persistent_from_block=3, dispatch_fail_rate=0.5,
                       wedge_rate=0.5, poison_rate=0.5),
}


def _decisions(plan, backend):
    """Every decision of a plan over a grid of keys, in one fixed order,
    and the plan's log after them."""
    out = [plan._u("dispatch", backend, b) for b in range(8)]
    out += [plan._u("wedge", u) for u in range(8)]
    for b, a in itertools.product(range(8), range(3)):
        e = plan.dispatch_error(backend, b, a)
        out.append(None if e is None else (type(e).__name__, str(e)))
    out += [(plan.wedge(u), plan.poisoned(u)) for u in range(24)]
    for u, dt in itertools.product(range(12), (np.int32, np.float32)):
        feeds = {"a": np.arange(1, 5), "b": np.array([3]),
                 "c": np.array([], np.int32)}
        got = plan.poison(feeds, u, dt)
        out.append("same" if got is feeds else
                   {k: (v.dtype.str, v.tolist()) for k, v in got.items()})
    for be in ("cuda", "xla", "pallas"):
        try:
            plan.check_compile(be)
            out.append(None)
        except RuntimeError as e:       # either package's CompileFault
            out.append((type(e).__name__, str(e)))
    return out, [tuple(e) for e in plan.log]


@pytest.mark.parametrize("backend", ["cuda", "xla"])
@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_fault_plan_decisions_match_jax(plan, seed, backend):
    got = _decisions(FaultPlan(seed, **PLANS[plan]), backend)
    want = _decisions(jfaults.FaultPlan(seed, **PLANS[plan]), backend)
    # NaN never equals itself: compare the poison output as text
    assert repr(got) == repr(want)
    assert got[1], "the plan injected nothing"


@pytest.mark.parametrize("mode", ["", "off", "full"])
def test_scaled_follows_repro_faults_like_jax(monkeypatch, mode):
    monkeypatch.setenv("REPRO_FAULTS", mode)
    kw = dict(dispatch_fail_rate=0.3, wedge_rate=0.6, poison_rate=0.1)
    got = FaultPlan.scaled(5, **kw)
    want = jfaults.FaultPlan.scaled(5, **kw)
    assert (got is None) == (want is None) == (mode == "off")
    if got is not None:
        for k in kw:
            assert getattr(got, k) == getattr(want, k)
        assert _decisions(got, "cuda")[0][:16] == \
            _decisions(want, "cuda")[0][:16]


def test_fault_classes():
    for cls in (CompileFault, DispatchFault):
        assert issubclass(cls, InjectedFault)
    assert issubclass(InjectedFault, RuntimeError)
    assert faults.__all__ == jfaults.__all__
    assert not hasattr(FaultPlan, "reference_error")


# ---------------------------------------------------------------------------
# the server under faults (tests/test_server_robustness.py, mirrored)
# ---------------------------------------------------------------------------
@pytest.fixture()
def bench():
    return library.vector_sum_graph(8)


def _feeds(bench, k, seed=0):
    return library.random_feeds("vector_sum", bench, k,
                                np.random.default_rng(seed))


def _solo(bench, K=4):
    return DataflowEngine(bench.graph, block_cycles=K, device="cpu")


def _server(bench, **kw):
    kw.setdefault("block_cycles", 4)
    return DataflowServer(bench.graph, device="cpu", **kw)


def test_watchdog_harvests_wedged_slot(bench):
    plan = FaultPlan(wedge_uids={1})
    srv = _server(bench, slots=2, wedge_timeout_blocks=3, faults=plan)
    srv.submit(_feeds(bench, 2, 0))              # uid 1: wedged
    srv.submit(_feeds(bench, 3, 1))              # uid 2: clean
    results = {r.uid: r for r in srv.drain()}
    assert results[1].status == "wedged" and results[1].metrics.wedged
    assert results[2].status == "ok"
    # the wedge suppressed the signal, not the computation
    eng = _solo(bench)
    assert_same_result(results[1].engine, eng.run(_feeds(bench, 2, 0)),
                       "wedged", dispatches=False)
    assert_same_result(results[2].engine, eng.run(_feeds(bench, 3, 1)),
                       "clean")
    assert not srv.state.active.any() and srv.pending == 0


@pytest.mark.parametrize("attempts", [1, 3])
def test_transient_dispatch_fault_is_retried(bench, attempts):
    plan = FaultPlan(dispatch_fail_blocks={0, 1}, transient_attempts=attempts)
    srv = _server(bench, slots=2, max_retries=3, faults=plan)
    srv.submit(_feeds(bench, 2, 0))
    results = {r.uid: r for r in srv.drain()}
    assert results[1].status == "ok"
    # two blocks, ``attempts`` retries each
    assert results[1].metrics.retries == 2 * attempts
    assert [e["kind"] for e in srv.events].count("dispatch-retry") == \
        2 * attempts
    assert_same_result(results[1].engine, _solo(bench).run(
        _feeds(bench, 2, 0)), "retried")


@pytest.mark.parametrize("max_retries,heartbeats", [(0, 1), (3, 1), (2, 2)])
def test_transient_fault_outliving_retries_clears(bench, max_retries,
                                                  heartbeats):
    """A transient fault that outlives ``heartbeats`` heartbeats' retries
    answers only the residents of those heartbeats with the fault; its
    attempts count on towards block 1, so a later heartbeat's launch
    succeeds and every later request is served."""
    plan = FaultPlan(dispatch_fail_blocks={1},
                     transient_attempts=heartbeats * (max_retries + 1))
    srv = _server(bench, slots=2, block_cycles=2, max_retries=max_retries,
                  faults=plan)
    feeds = {u: _feeds(bench, 2 + u % 3, u) for u in range(1, 9)}
    for u, f in feeds.items():
        srv.submit(Request(uid=u, feeds=f))
    results = {r.uid: r for r in srv.drain()}
    assert sorted(results) == list(feeds)
    failed = [e for e in srv.events if e["kind"] == "dispatch-failed"]
    assert [e["block"] for e in failed] == [1] * heartbeats
    errored = sorted(u for e in failed for u in e["uids"])
    assert errored == sorted(u for u, r in results.items()
                             if r.status == "error")
    eng = _solo(bench, K=2)
    for u, r in results.items():
        if u in errored:
            assert isinstance(r.error, DispatchFault)
            assert r.metrics.finished_block == 1
            assert r.metrics.retries == max_retries
        else:
            assert r.status == "ok" and r.error is None, u
            assert_same_result(r.engine, eng.run(feeds[u]), u,
                               dispatches=False)
    assert any(r.status == "ok" and r.metrics.admitted_block >= 1
               for r in results.values())
    assert srv.block > 1 and srv.pending == 0
    assert sum(k[0] == "dispatch-transient" for k in plan.log) == \
        plan.transient_attempts


def test_poisoned_feeds_do_not_perturb_neighbours(bench):
    plan = FaultPlan(poison_uids={2})
    srv = _server(bench, slots=3, faults=plan)
    feeds = [_feeds(bench, 3, i) for i in range(3)]
    for f in feeds:
        srv.submit({a: np.array(v) for a, v in f.items()})
    results = {r.uid: r for r in srv.drain()}
    eng = _solo(bench)
    assert_same_result(results[1].engine, eng.run(feeds[0]), "clean 1")
    assert_same_result(results[3].engine, eng.run(feeds[2]), "clean 3")
    # the poisoned request computes deterministically over the poisoned
    # feeds (poison() is idempotent)
    assert_same_result(results[2].engine, eng.run(plan.poison(feeds[1], 2)),
                       "poisoned")
    assert ("poison", 2) in plan.log
    assert any(e["kind"] == "poison" and e["uid"] == 2 for e in srv.events)


def test_harvest_accounting_is_strict(bench):
    srv = _server(bench, slots=1)
    uid = srv.submit(_feeds(bench, 2, 0))
    srv.step()                              # admit + first block
    del srv._queued_at[uid]                 # corrupt the books
    with pytest.raises(KeyError):
        srv.drain()


# ---------------------------------------------------------------------------
# what replaces the degradation chain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("from_block", [0, 2])
def test_persistent_fault_answers_error_and_server_goes_on(bench,
                                                           from_block):
    """Residents of a launch that outlives its retries are answered with
    the fault and their partial results; queued requests are admitted and
    answered in turn; nothing raises; a fresh server then serves."""
    plan = FaultPlan(persistent_backends={"cuda"},
                     persistent_from_block=from_block)
    tr, mr = TraceRecorder(), MetricsRegistry()
    srv = _server(bench, slots=2, block_cycles=2, max_retries=2,
                  faults=plan, trace=tr, metrics=mr)
    feeds = {u: _feeds(bench, 1 + u % 3, u) for u in range(1, 6)}
    for u, f in feeds.items():
        srv.submit(Request(uid=u, feeds=f, tenant="t"))
    results = {r.uid: r for r in srv.drain()}       # must not raise
    assert sorted(results) == list(feeds)
    assert srv.block == from_block and srv.pending == 0
    eng = _solo(bench, K=2)
    partial = 0
    for u, r in results.items():
        assert r.status == "error" and isinstance(r.error, DispatchFault)
        assert r.metrics.retries == 2 and r.metrics.slot >= 0
        assert r.metrics.finished_block == from_block
        assert r.metrics.residency_blocks == r.engine.dispatches \
            == from_block - r.metrics.admitted_block
        if r.metrics.admitted_block == from_block:     # never launched
            assert r.engine.cycles <= 1 and r.engine.fired == 0
        else:               # partial results up to the last good block
            assert 0 < r.engine.fired < eng.run(feeds[u]).fired
            partial += 1
    assert partial == (2 if from_block else 0)
    failed = [e for e in srv.events if e["kind"] == "dispatch-failed"]
    assert sorted(u for e in failed for u in e["uids"]) == list(feeds)
    assert validate_chrome(tr.to_chrome())["uids"] == len(feeds)
    assert {e.status for e in tr.events if e.kind == "harvest"} == \
        {"error"}
    snap = mr.snapshot()
    validate_snapshot(snap)
    assert snap["counters"]["requests_finished{status=error}"] == 5
    srv2 = _server(bench, slots=2, block_cycles=2)
    srv2.submit(feeds[1])
    assert srv2.drain()[0].status == "ok"


def test_persistent_fault_after_some_requests_finish(bench):
    """Requests that quiesce before the fault's block answer ok; the
    rest error."""
    plan = FaultPlan(persistent_backends={"cuda"}, persistent_from_block=4)
    srv = _server(bench, slots=4, block_cycles=2, faults=plan)
    lens = [1, 6, 1, 6, 6, 1]
    for i, k in enumerate(lens):
        srv.submit(_feeds(bench, k, i))
    results = {r.uid: r for r in srv.drain()}
    eng = _solo(bench, K=2)
    for uid, r in results.items():
        if r.metrics.finished_block < 4 or r.status == "ok":
            assert r.status == "ok" and r.metrics.finished_block <= 4
            assert_same_result(r.engine, eng.run(_feeds(bench, lens[uid - 1],
                                                         uid - 1)), uid)
        else:
            assert r.status == "error", uid
    assert {r.status for r in results.values()} == {"ok", "error"}


def test_compile_fault_raises_from_the_constructor(bench):
    plan = FaultPlan(compile_fail={"cuda"})
    with pytest.raises(CompileFault, match="cuda"):
        _server(bench, slots=2, faults=plan)
    assert plan.log == [("compile", "cuda")]
    # a plan that fails only another backend builds the server
    assert _server(bench, slots=2, faults=FaultPlan(
        compile_fail={"xla"})).backend == "cuda"


def test_real_launch_failure_is_not_retried(bench, monkeypatch):
    srv = _server(bench, slots=2, max_retries=5,
                  faults=FaultPlan(dispatch_fail_blocks={0}))
    calls = []

    def broken(state, n_cycles=None):
        calls.append(n_cycles)
        raise RuntimeError("CUDA error: an illegal memory access")
    srv.submit(_feeds(bench, 2, 0))
    monkeypatch.setattr(srv.engine, "step_block", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        srv.step()
    # the injected transient was retried once; the real failure not at all
    assert calls == [4]
    assert [e["kind"] for e in srv.events] == ["dispatch-retry"]


# ---------------------------------------------------------------------------
# chaos soak (tests/test_server_soak.py, on the port alone)
# ---------------------------------------------------------------------------
def test_server_chaos_soak_under_seeded_fault_plan():
    """>= 200 blocks of mixed traffic (tenants, deadlines, budgets)
    through a seeded plan of transient dispatch faults, wedges and
    poison.  The server never raises, every uid gets exactly one Result,
    no slot leaks, and every unfaulted request finishes ok or wedged
    with the values of a solo run."""
    plan = FaultPlan.scaled(seed=7, dispatch_fail_rate=0.04,
                            transient_attempts=1, wedge_rate=0.10,
                            poison_rate=0.12)
    if plan is None:
        pytest.skip("REPRO_FAULTS=off")
    bench = library.vector_sum_graph(8)
    tr, mr = TraceRecorder(), MetricsRegistry()
    srv = _server(bench, slots=4, block_cycles=2, max_retries=3,
                  wedge_timeout_blocks=4, faults=plan, trace=tr, metrics=mr)
    rng = np.random.default_rng(1234)
    submitted, results, uid, safety = {}, {}, 0, 0
    while srv.block < 200:
        safety += 1
        assert safety < 20_000, "chaos soak stalled"
        if rng.random() < 0.5 and len(submitted) - len(results) < 14:
            uid += 1
            k = int(rng.integers(1, 7))
            roll = rng.random()
            req = Request(
                uid=uid, feeds=library.random_feeds("vector_sum", bench, k,
                                                    rng),
                tenant=("a", "b", None)[uid % 3],
                deadline_blocks=int(rng.integers(1, 40))
                if roll < 0.15 else None,
                max_cycles=int(rng.integers(1, 6)) if roll > 0.9 else None)
            srv.submit(req)
            submitted[uid] = req
        for r in srv.step():
            assert r.uid not in results, "duplicate result"
            results[r.uid] = r
    for r in srv.drain():
        assert r.uid not in results, "duplicate result"
        results[r.uid] = r

    assert set(results) == set(submitted) and len(submitted) > 30
    assert srv.pending == 0 and not srv.queue
    assert not srv.state.active.any()
    assert srv._resident == {} and srv._queued_at == {}
    assert {r.status for r in results.values()} <= {
        "ok", "truncated", "expired", "wedged", "error"}
    kinds = {k for k, *_ in plan.log}
    assert "poison" in kinds and "dispatch-transient" in kinds
    assert validate_chrome(tr.to_chrome())["uids"] == len(submitted)
    snap = mr.snapshot()
    validate_snapshot(snap)
    retries = sum(v for k, v in snap["counters"].items()
                  if k.startswith("dispatch_retries"))
    assert retries == sum(k == "dispatch-transient" for k, *_ in plan.log)

    eng = _solo(bench, K=2)
    checked = 0
    for u, req in submitted.items():
        if req.deadline_blocks is not None or req.max_cycles is not None \
                or plan.poisoned(u):
            continue
        r = results[u]
        assert r.status in ("ok", "wedged"), (u, r.status)
        assert_same_result(r.engine, eng.run(req.feeds), u, dispatches=False)
        checked += 1
    assert checked > 10, "soak must exercise enough unfaulted requests"
