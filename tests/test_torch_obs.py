"""Port vs JAX package: the observability recorders.

``repro_torch.obs.metrics`` and ``repro_torch.obs.trace`` are copies of
the JAX package's modules: the same calls give snapshots and Chrome
exports that compare with ``==``, each validator rejects every broken log
the JAX tests break (tests/test_obs.py) and accepts the other package's
exports; ``FairQueue.depths`` and the ``RequestMetrics`` fields follow the
JAX package's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.serve.admission import FairQueue as JFairQueue  # noqa: E402
from repro.serve.types import RequestMetrics as JRequestMetrics  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.serve.admission import FairQueue  # noqa: E402
from repro_torch.serve.types import Request, RequestMetrics  # noqa: E402


def test_exports_and_constants_match_jax():
    assert tobs.__all__ == jobs.__all__
    assert ttrace.TERMINAL_KINDS == jtrace.TERMINAL_KINDS
    assert ttrace.US_PER_BLOCK == jtrace.US_PER_BLOCK
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    assert issubclass(ttrace.TraceInvariantError, AssertionError)


def test_request_metrics_fields_follow_jax():
    """The JAX fields in the JAX order, ``degraded`` left out."""
    want = [(f.name, f.default) for f in dataclasses.fields(JRequestMetrics)
            if f.name != "degraded"]
    assert [(f.name, f.default)
            for f in dataclasses.fields(RequestMetrics)] == want


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def _ops_basic(mr):
    """tests/test_obs.py's primitives."""
    mr.counter("reqs").inc(2)
    mr.counter("reqs", tenant="a").inc(1)
    mr.gauge("depth").set(7)
    h = mr.histogram("wait")
    for v in (0.5, 2.0, 100.0):
        h.observe(v)


def _ops_labels_and_buckets(mr):
    """Label order, gauge high water, overflow bucket, custom bounds, an
    empty histogram."""
    mr.counter("dispatches", backend="cuda", region=3).inc(4)
    mr.counter("dispatches", region=3, backend="cuda").inc(1)
    g = mr.gauge("queue_depth", tenant="x")
    for v in (3, 9, 2):
        g.set(v)
    h = mr.histogram("residency_cycles")
    for v in (1, 1, 7, 250, 99_999, 100_001, 3e6):
        h.observe(v)
    mr.histogram("custom", buckets=(0.5, 4))
    mr.histogram("custom", buckets=(0.5, 4)).observe(4)
    mr.histogram("never")


@pytest.mark.parametrize("ops", [_ops_basic, _ops_labels_and_buckets])
def test_metrics_snapshot_matches_jax(ops, tmp_path):
    mr, jmr = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    ops(mr)
    ops(jmr)
    snap = mr.snapshot()
    assert snap == jmr.snapshot()
    tmetrics.validate_snapshot(snap)
    jmetrics.validate_snapshot(snap)
    mr.save(str(tmp_path / "m.json"))
    jmr.save(str(tmp_path / "j.json"))
    assert (tmp_path / "m.json").read_text() == \
        (tmp_path / "j.json").read_text()


def test_metrics_primitives():
    mr = tmetrics.MetricsRegistry()
    _ops_basic(mr)
    snap = mr.snapshot()
    assert snap["counters"]["reqs"] == 2
    assert snap["counters"]["reqs{tenant=a}"] == 1
    assert snap["gauges"]["depth"]["value"] == 7
    hist = snap["histograms"]["wait"]
    assert hist["count"] == 3 and hist["sum"] == pytest.approx(102.5)
    with pytest.raises(ValueError, match="only go up"):
        mr.counter("reqs").inc(-1)


@pytest.mark.parametrize("bad", [
    {"counters": 3},
    {"counters": {}, "gauges": {}},
    {"counters": {"x": -1}, "gauges": {}, "histograms": {}},
    {"counters": {"x": 1.5}, "gauges": {}, "histograms": {}},
    {"counters": {}, "gauges": {"g": {"value": 1}}, "histograms": {}},
    {"counters": {}, "gauges": {},
     "histograms": {"h": {"count": 2, "buckets": {"1": 1, "+inf": 0}}}},
])
def test_validate_snapshot_rejects_like_jax(bad):
    with pytest.raises(ValueError) as got:
        tmetrics.validate_snapshot(bad)
    with pytest.raises(ValueError) as want:
        jmetrics.validate_snapshot(bad)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# trace recorder and validator
# ---------------------------------------------------------------------------
LIFECYCLE = [
    ("submit", dict(block=0, uid=1, tenant="a", queue_depth=1)),
    ("submit", dict(block=0, uid=2, tenant="b", queue_depth=2)),
    ("submit", dict(block=0, uid=3, queue_depth=3)),
    ("admit", dict(block=0, uid=1, slot=0, tenant="a", queue_wait_blocks=0)),
    ("admit", dict(block=0, uid=2, slot=1, tenant="b", queue_wait_blocks=0)),
    ("fault", dict(block=1, injected="dispatch-transient",
                   key=["cuda", "1", "0"])),
    ("retry", dict(block=1, attempt=1, backend="cuda", error="boom")),
    ("wedge", dict(block=2, uid=2, slot=1, tenant="b")),
    ("harvest", dict(block=3, uid=1, slot=0, tenant="a", status="ok",
                     cycles=9, fired=30, tokens_out=4, backend="cuda")),
    ("expire", dict(block=4, uid=3, status="expired", queued_block=0)),
    ("harvest", dict(block=6, uid=2, slot=1, tenant="b", status="error",
                     cycles=5, fired=12, tokens_out=1, backend="cuda")),
]


def _record(rec, events):
    for kind, kw in events:
        rec.record(kind, **kw)
    return rec


def test_trace_export_matches_jax(tmp_path):
    tr = _record(ttrace.TraceRecorder(), LIFECYCLE)
    jtr = _record(jtrace.TraceRecorder(), LIFECYCLE)
    assert len(tr) == len(jtr) == len(LIFECYCLE)
    got, want = tr.to_chrome("block"), jtr.to_chrome("block")
    for out in (got, want):
        for ev in out["traceEvents"]:
            ev.get("args", {}).pop("wall_s", None)
    assert got == want
    for clock in ("block", "wall"):
        info = ttrace.validate_chrome(tr.to_chrome(clock))
        assert info == jtrace.validate_chrome(jtr.to_chrome(clock))
        assert info["uids"] == 3
        assert ttrace.validate_chrome(jtr.to_chrome(clock)) == info
    path = tmp_path / "trace.json"
    tr.save(str(path))
    assert ttrace.validate_chrome(ttrace.load_chrome(str(path)))["uids"] == 3
    with pytest.raises(ValueError, match="clock"):
        tr.to_chrome("cycles")


# tests/test_obs.py:283-330, one broken log each
BROKEN = {
    "missing_terminal": ([("submit", dict(block=0, uid=1))], "terminal"),
    "missing_terminal_async": ([("submit", dict(block=0, uid=1)),
                                ("submit", dict(block=1, uid=2,
                                                tenant="t"))], None),
    "backwards_clock": ([("submit", dict(block=5, uid=1, tenant="t")),
                         ("harvest", dict(block=3, uid=1, tenant="t",
                                          status="ok"))], "backwards"),
    "unbalanced_slot_span": ([("submit", dict(block=0, uid=1, tenant="t")),
                              ("admit", dict(block=1, uid=1, slot=0,
                                             tenant="t")),
                              ("expire", dict(block=2, uid=1,
                                              tenant="t"))], None),
    "double_submit": ([("submit", dict(block=0, uid=1)),
                       ("submit", dict(block=1, uid=1)),
                       ("harvest", dict(block=2, uid=1, status="ok"))],
                      "submitted"),
    "admits_without_close": ([("submit", dict(block=0, uid=1)),
                              ("admit", dict(block=0, uid=1, slot=0)),
                              ("admit", dict(block=1, uid=1, slot=1)),
                              ("harvest", dict(block=2, uid=1, slot=0,
                                               status="ok"))], None),
    "terminal_without_submit": ([("harvest", dict(block=2, uid=9,
                                                  status="ok"))],
                                "without a submit"),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_validator_rejects_broken_log(case):
    events, match = BROKEN[case]
    export = _record(ttrace.TraceRecorder(), events).to_chrome()
    with pytest.raises(ttrace.TraceInvariantError, match=match):
        ttrace.validate_chrome(export)
    with pytest.raises(jtrace.TraceInvariantError, match=match):
        jtrace.validate_chrome(export)


@pytest.mark.parametrize("bad", [{"traceEvents": [{"ph": "i"}]},
                                 {"nope": []}, [],
                                 {"traceEvents": [{"name": "x", "ph": "i",
                                                   "pid": 1, "tid": 1}]}])
def test_validator_rejects_malformed_shape(bad):
    with pytest.raises(ttrace.TraceInvariantError):
        ttrace.validate_chrome(bad)


# ---------------------------------------------------------------------------
# FairQueue.depths
# ---------------------------------------------------------------------------
def test_fair_queue_depths_match_jax():
    queues = (FairQueue(), JFairQueue())
    pushes = [(1, "a"), (2, "a"), (3, "b"), (4, None), (5, "b")]
    for q in queues:
        for uid, t in pushes:
            q.push(Request(uid=uid, feeds={}, tenant=t))
    assert queues[0].depths() == queues[1].depths() == \
        {"a": 2, "b": 2, None: 1}
    for _ in range(3):
        assert queues[0].pop().uid == queues[1].pop().uid
        assert queues[0].depths() == queues[1].depths()
    assert queues[0].drop_oldest().uid == queues[1].drop_oldest().uid
    assert queues[0].depths() == queues[1].depths() == {"b": 1}
    queues[0].pop()
    assert queues[0].depths() == {}
