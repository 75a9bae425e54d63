"""Port vs JAX package: the continuous-batching server and the slot state.

The port's ``DataflowServer`` (``device="cpu"``: the host loop over the
kernel's plain PyTorch version) and the JAX package's ``DataflowServer``
(over an xla-backend engine, as tests/test_dataflow_server.py drives it)
serve the same requests; every Result must match field for field.  The
carry-across test moves a JAX server's mid-flight slot state into the
port and steps both packages side by side.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro.serve.dataflow_server import DataflowServer as JServer  # noqa: E402
from repro.serve.types import Request as JRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.serve.dataflow_server import DataflowServer  # noqa: E402
from repro_torch.serve.types import Request  # noqa: E402
from repro_torch.testing import assert_same_result  # noqa: E402

SLOT_FIELDS = convert.DEVICE_FIELDS + convert.HOST_FIELDS


def _check(got, want, tag):
    """tests/test_dataflow_server.py's ``_check``, mirrored."""
    assert got.cycles == want.cycles, (tag, got.cycles, want.cycles)
    assert got.fired == want.fired, (tag, got.fired, want.fired)
    for a, c in want.counts.items():
        assert got.counts[a] == c, (tag, a)
        if c:
            assert int(np.asarray(got.outputs[a])) == \
                int(np.asarray(want.outputs[a])), (tag, a)


def _jax_metrics(m):
    """The JAX server's RequestMetrics as a dict, without ``degraded``
    (the port's server has no degradation chain; a fault-free run leaves
    it at its default).  ``retries`` stays and is compared as a field."""
    d = dataclasses.asdict(m)
    assert d.pop("degraded") is False, d
    return d


def _requests(name, bench):
    """10 requests over two tenants, unequal lengths; uid 3 carries a
    deadline it cannot meet, uid 5 a cycle budget it cannot finish in."""
    reqs = []
    for i in range(10):
        k = 2 + (5 * i) % 9
        feeds = tlib.random_feeds(name, bench, k, np.random.default_rng(i))
        reqs.append(dict(uid=i + 1, feeds=feeds, tenant="ab"[i % 2],
                         deadline_blocks=2 if i == 2 else None,
                         max_cycles=6 if i == 4 else None))
    return reqs


def _serve(srv, reqs, make):
    """Four requests up front, the rest after two heartbeats."""
    for r in reqs[:4]:
        srv.submit(make(**r))
    got = srv.step() + srv.step()
    for r in reqs[4:]:
        srv.submit(make(**r))
    return sorted(got + srv.drain(), key=lambda r: r.uid)


@pytest.mark.parametrize("name", ["fibonacci", "dot_prod"])
def test_server_matches_jax_server(name):
    tb = tlib.BENCHES[name]()
    jb = jlib.BENCHES[name]()
    reqs = _requests(name, tb)
    jeng = JEngine(jb.graph, backend="xla", block_cycles=4)
    want = _serve(JServer(jb.graph, slots=3, engine=jeng), reqs, JRequest)
    got = _serve(DataflowServer(tb.graph, slots=3, block_cycles=4,
                                device="cpu"), reqs, Request)
    assert [r.uid for r in got] == [r.uid for r in want] == \
        list(range(1, 11))
    statuses = {r.status for r in got}
    assert {"ok", "truncated", "expired"} <= statuses, statuses
    for g, w in zip(got, want):
        assert g.status == w.status, g.uid
        assert (g.error is None) == (w.error is None)
        if w.engine is None:
            assert g.engine is None
        else:
            assert_same_result(g.engine, w.engine, (name, g.uid))
            _check(g.engine, w.engine, (name, g.uid))
        gm, wm = dataclasses.asdict(g.metrics), _jax_metrics(w.metrics)
        assert gm.pop("backend") == "cuda"
        wm.pop("backend")
        assert gm == wm, (name, g.uid)


def _slot_arrays(st):
    return {k: np.asarray(getattr(st, k)) for k in SLOT_FIELDS}


def _assert_same_state(got, want, tag):
    for k in SLOT_FIELDS:
        g = getattr(got, k)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(getattr(want, k))
        assert g.shape == w.shape, (tag, k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} {k}")
        if k in convert.HOST_FIELDS:
            assert g.dtype == w.dtype, (tag, k, g.dtype, w.dtype)


def test_slot_state_carries_across():
    """A JAX server's mid-flight slot state, carried into the port as
    numpy, steps, harvests and admits identically in both packages."""
    jb = jlib.fibonacci_graph()
    tg = convert.graph_from_asm(jasm.emit(jb.graph))
    jeng = JEngine(jb.graph, backend="xla", block_cycles=4)
    srv = JServer(jb.graph, slots=4, engine=jeng)
    for n in (3, 9, 14):
        srv.submit(jb.make_feeds(n))
    srv.submit(JRequest(uid=99, feeds=jb.make_feeds(12), max_cycles=30))
    for _ in range(3):
        srv.step()
    jst = srv.state
    assert jst.active.sum() >= 2                 # really mid-flight
    eng = DataflowEngine(tg, block_cycles=4, device="cpu")
    tst = convert.slot_state_from_numpy(_slot_arrays(jst), device="cpu")
    _assert_same_state(tst, jst, "carried")
    for step in range(4):
        jst, tst = jeng.step_block(jst), eng.step_block(tst)
        _assert_same_state(tst, jst, ("step", step))
    done = jst.quiesced_slots()
    assert done == tst.quiesced_slots() and done
    jst, jres = jeng.harvest(jst, done)
    tst, tres = eng.harvest(tst, done)
    for g, w in zip(tres, jres):
        assert_same_result(g, w, "harvest")
    _assert_same_state(tst, jst, "harvested")
    # an admission whose stream outgrows the buffer (L doubles)
    feeds = jb.make_feeds(40)
    jst = jeng.reset_slots(jst, done[:1], [feeds], caps=[50])
    tst = eng.reset_slots(tst, done[:1], [feeds], caps=[50])
    _assert_same_state(tst, jst, "admitted")
    jst, tst = jeng.step_block(jst), eng.step_block(tst)
    _assert_same_state(tst, jst, "stepped")


@functools.lru_cache(maxsize=None)
def _jax_fib_engine():
    return JEngine(jlib.fibonacci_graph().graph, backend="xla",
                   block_cycles=4)


@pytest.mark.parametrize("policy", ["reject", "drop-oldest", "block"])
def test_bounded_admission_matches_jax(policy):
    """max_queue=2 under each policy: the same submit answers (uids or
    typed rejections), the same drops, the same results."""
    tb, jb = tlib.fibonacci_graph(), jlib.fibonacci_graph()
    servers = (JServer(jb.graph, slots=2, engine=_jax_fib_engine(),
                       max_queue=2, policy=policy),
               DataflowServer(tb.graph, slots=2, block_cycles=4,
                              max_queue=2, policy=policy, device="cpu"))
    answers, results = [], []
    for srv in servers:
        got = []
        for i, n in enumerate((6, 2, 9, 3, 5, 4, 7)):
            r = srv.submit(tb.make_feeds(n))
            got.append(r if isinstance(r, int) else (r.uid, r.reason,
                                                     r.queue_depth))
            if i == 3:
                got.append([x.uid for x in srv.step()])
        answers.append(got)
        results.append(sorted(srv.drain(), key=lambda r: r.uid))
    assert answers[1] == answers[0]
    want, got = results
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.status == w.status
        assert type(g.error).__name__ == type(w.error).__name__
        if w.engine is not None:
            assert_same_result(g.engine, w.engine, (policy, g.uid))
        gm, wm = dataclasses.asdict(g.metrics), _jax_metrics(w.metrics)
        gm.pop("backend"), wm.pop("backend")
        assert gm == wm, (policy, g.uid)


def test_stall_watchdog_harvests_a_wedged_slot(monkeypatch):
    """A slot whose quiescence signal is withheld stalls block after
    block; the watchdog force-harvests it as wedged, with the values a
    solo run gives (only the signal was lost)."""
    bench = tlib.fibonacci_graph()
    srv = DataflowServer(bench.graph, slots=2, block_cycles=4,
                         wedge_timeout_blocks=3, device="cpu")
    step_block = srv.engine.step_block

    def withhold_slot0(state, n_cycles=None):
        state = step_block(state, n_cycles)
        state.quiesced[0] = False
        return state
    monkeypatch.setattr(srv.engine, "step_block", withhold_slot0)
    feeds = [bench.make_feeds(n) for n in (3, 5)]
    for f in feeds:
        srv.submit(f)
    got = sorted(srv.drain(), key=lambda r: r.uid)
    assert [r.status for r in got] == ["wedged", "ok"]
    solo = DataflowEngine(bench.graph, block_cycles=4, device="cpu")
    for r, f in zip(got, feeds):
        assert_same_result(r.engine, solo.run(f), r.uid, dispatches=False)
    assert got[0].metrics.residency_blocks > solo.run(feeds[0]).dispatches
