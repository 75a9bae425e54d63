"""Port vs JAX package: the hardened server, event for event.

The same served scenarios go through the JAX ``DataflowServer`` (the
``"xla"`` backend) and the port's (``device="cpu"``: the kernels' plain
PyTorch versions), each with a seeded ``FaultPlan``, a ``TraceRecorder``
and a ``MetricsRegistry``.  Every ``Result`` (status, error, every
``EngineResult`` field, ``RequestMetrics`` but ``degraded``), the
block-clock Chrome export without its wall-clock stamps, the metrics
snapshot, the server's ``events`` log and the plan's injection log must
be equal once the backend name ``"xla"`` reads ``"cuda"``.  Dispatch
faults come from explicit ``dispatch_fail_blocks`` (the dispatch coin is
keyed on the backend's name); wedges and poison are keyed on uids, so
their rates give both packages the same faults.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import library as jlib  # noqa: E402
from repro.obs import MetricsRegistry as JMetrics  # noqa: E402
from repro.obs import TraceRecorder as JTrace  # noqa: E402
from repro.obs import validate_chrome as jvalidate  # noqa: E402
from repro.serve.dataflow_server import DataflowServer as JServer  # noqa: E402
from repro.serve.faults import FaultPlan as JPlan  # noqa: E402
from repro.serve.types import Request as JRequest  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.obs import (MetricsRegistry, TraceRecorder,  # noqa: E402
                             validate_chrome, validate_snapshot)
from repro_torch.serve.dataflow_server import DataflowServer  # noqa: E402
from repro_torch.serve.faults import FaultPlan  # noqa: E402
from repro_torch.serve.types import Request  # noqa: E402
from repro_torch.testing import assert_same_result  # noqa: E402

PORT = dict(server=DataflowServer, request=Request, plan=FaultPlan,
            trace=TraceRecorder, metrics=MetricsRegistry, lib=tlib,
            kw=dict(device="cpu"))
JAX = dict(server=JServer, request=JRequest, plan=JPlan, trace=JTrace,
           metrics=JMetrics, lib=jlib, kw=dict(backend="xla"))


def _as_port(x):
    """A JAX-side record with the backend name the port's server uses."""
    return json.loads(json.dumps(x, default=str).replace("xla", "cuda"))


def _feeds(bench, k, seed):
    return tlib.random_feeds("vector_sum", bench, k,
                             np.random.default_rng(seed))


def _served(pkg, flags):
    """tests/test_obs.py's ``_served_scenario``: ok harvests, a queued
    expiry, a drop-oldest eviction."""
    bench = pkg["lib"].vector_sum_graph(8)
    tr, mr = pkg["trace"](), pkg["metrics"]()
    srv = pkg["server"](bench.graph, slots=2, block_cycles=4,
                        policy="drop-oldest", max_queue=5, trace=tr,
                        metrics=mr, **flags, **pkg["kw"])
    answers = [srv.submit(pkg["request"](
        uid=uid, feeds=_feeds(bench, 4 + uid % 3, uid), tenant="ab"[uid % 2],
        deadline_blocks=1 if uid == 5 else None)) for uid in range(1, 7)]
    return srv, None, tr, mr, answers, srv.drain()


def _faults(pkg, flags):
    """tests/test_obs.py's ``test_fault_injections_land_in_the_trace``."""
    bench = pkg["lib"].vector_sum_graph(8)
    tr, mr = pkg["trace"](), pkg["metrics"]()
    plan = pkg["plan"](seed=3, poison_uids=(2,), wedge_uids=(3,),
                       dispatch_fail_blocks=(1,), transient_attempts=1)
    srv = pkg["server"](bench.graph, slots=2, block_cycles=4,
                        wedge_timeout_blocks=3, faults=plan, trace=tr,
                        metrics=mr, **flags, **pkg["kw"])
    answers = [srv.submit(pkg["request"](
        uid=uid, feeds=_feeds(bench, 4, uid), tenant="t"))
        for uid in (1, 2, 3)]
    return srv, plan, tr, mr, answers, srv.drain()


def _mix(pkg, flags, policy):
    """Three tenants (one untagged) over a bounded queue, deadlines that
    expire queued and resident requests, a cycle budget, uid-keyed poison
    and wedges, and transients that eat two retries each; submissions
    interleaved with heartbeats."""
    bench = pkg["lib"].vector_sum_graph(8)
    tr, mr = pkg["trace"](), pkg["metrics"]()
    plan = pkg["plan"](seed=11, poison_rate=0.25, wedge_uids=(4,),
                       wedge_rate=0.05, dispatch_fail_blocks=(0, 3, 7),
                       transient_attempts=2)
    srv = pkg["server"](bench.graph, slots=3, block_cycles=2,
                        max_queue=5, policy=policy, max_retries=3,
                        wedge_timeout_blocks=4, faults=plan, trace=tr,
                        metrics=mr, **flags, **pkg["kw"])
    answers, results = [], []
    for uid in range(1, 15):
        req = pkg["request"](
            uid=uid, feeds=_feeds(bench, 1 + (3 * uid) % 6, 100 + uid),
            tenant=("x", "y", None)[uid % 3],
            deadline_blocks=(3 if uid % 5 == 0 else
                             9 if uid == 7 else None),
            max_cycles=5 if uid in (1, 9) else None)
        r = srv.submit(req)
        answers.append(r if isinstance(r, int) else
                       (r.uid, r.reason, r.queue_depth, r.tenant))
        if uid % 2 == 0:
            results += srv.step()
    return srv, plan, tr, mr, answers, results + srv.drain()


# the exits each scenario must reach besides "ok"
COVERS = {"served": {"error", "expired"}, "faults": {"wedged"},
          "mix_drop": {"wedged", "expired", "truncated", "error"},
          "mix_reject": {"wedged", "expired", "truncated"}}
SCENARIOS = {"served": _served, "faults": _faults,
             "mix_drop": functools.partial(_mix, policy="drop-oldest"),
             "mix_reject": functools.partial(_mix, policy="reject")}


@functools.lru_cache(maxsize=None)
def _jax_run(scenario, schedule, profile):
    return SCENARIOS[scenario](JAX, dict(schedule=schedule, profile=profile))


def _block_trace(tr):
    out = tr.to_chrome("block")
    for ev in out["traceEvents"]:
        ev.get("args", {}).pop("wall_s", None)
    return out


def _metrics(m):
    d = dataclasses.asdict(m)
    d.pop("degraded", None)
    return d


@pytest.mark.parametrize("profile", [False, True])
@pytest.mark.parametrize("schedule", [False, "auto"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_hardened_server_matches_jax(scenario, schedule, profile):
    flags = dict(schedule=schedule, profile=profile)
    jsrv, jplan, jtr, jmr, janswers, jres = _jax_run(scenario, schedule,
                                                     profile)
    srv, plan, tr, mr, answers, res = SCENARIOS[scenario](PORT, flags)
    assert answers == janswers
    got = sorted(res, key=lambda r: r.uid)
    want = sorted(jres, key=lambda r: r.uid)
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.status == w.status, (g.uid, g.status, w.status)
        assert type(g.error).__name__ == type(w.error).__name__, g.uid
        assert _as_port(str(g.error)) == _as_port(str(w.error)), g.uid
        if w.engine is None:
            assert g.engine is None, g.uid
        else:
            assert_same_result(g.engine, w.engine, (scenario, g.uid),
                               profile=profile)
        assert _metrics(g.metrics) == _as_port(_metrics(w.metrics)), g.uid
    statuses = {r.status for r in got}
    assert statuses >= {"ok"} | COVERS[scenario], statuses
    if plan is not None:
        assert any(e["kind"] == "dispatch-retry" for e in srv.events)
        assert {"fault", "retry", "wedge", "poison"} <= {
            e.kind for e in tr.events}
    assert _block_trace(tr) == _as_port(_block_trace(jtr))
    assert mr.snapshot() == _as_port(jmr.snapshot())
    assert srv.events == _as_port(jsrv.events)
    if plan is not None:
        assert [list(e) for e in plan.log] == _as_port(
            [list(e) for e in jplan.log])
    assert (srv.block, srv.admission_rounds, srv.max_queue_depth) == \
        (jsrv.block, jsrv.admission_rounds, jsrv.max_queue_depth)
    # each package's validator takes the other's export
    for clock in ("block", "wall"):
        assert validate_chrome(jtr.to_chrome(clock))["uids"] == \
            jvalidate(tr.to_chrome(clock))["uids"] == len(got)
    validate_snapshot(mr.snapshot())


def test_hooks_change_no_result():
    """Fault-free, the hooks record and change nothing: every Result
    field equals the same server's without trace and metrics."""
    bench = tlib.vector_sum_graph(8)
    runs = []
    for hooks in (False, True):
        extra = dict(trace=TraceRecorder(), metrics=MetricsRegistry()) \
            if hooks else {}
        srv = DataflowServer(bench.graph, slots=2, block_cycles=4,
                             device="cpu", profile=True, **extra)
        for uid in range(1, 7):
            srv.submit(Request(uid=uid, feeds=_feeds(bench, 2 + uid, uid),
                               tenant="ab"[uid % 2],
                               max_cycles=6 if uid == 4 else None))
        runs.append(sorted(srv.drain(), key=lambda r: r.uid))
        assert srv.events == []
    for g, w in zip(*runs):
        assert g.status == w.status and g.error is None
        assert_same_result(g.engine, w.engine, g.uid, profile=True)
        assert dataclasses.asdict(g.metrics) == dataclasses.asdict(w.metrics)
    assert {r.status for r in runs[0]} == {"ok", "truncated"}
