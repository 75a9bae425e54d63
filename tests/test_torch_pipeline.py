"""Port vs JAX package: the pipeline schedules
(``repro_torch.core.pipeline``) and ``run_reference(trace=)``.

``dataflow_schedule`` is read off the engine's own firing trace, so its
tables and the trace's event lists must equal the JAX package's, and
``dense_schedule`` its wavefront; the schedule properties of JAX's
``tests/test_pipeline.py`` hold on the port's tables.  The multi-device
executor (``pipeline_apply``, ``make_stage_fn``) is not ported and
refuses, naming ROADMAP Queue A 10b; no test here starts a multi-device
process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.engine import run_reference as jref  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.engine import run_reference  # noqa: E402

SHAPES = [(1, 1), (2, 2), (3, 5), (4, 6), (8, 3), (5, 11)]


@pytest.mark.parametrize("S,M", SHAPES)
def test_schedules_equal_jax(S, M):
    np.testing.assert_array_equal(tpipe.dataflow_schedule(S, M),
                                  jpipe.dataflow_schedule(S, M))
    np.testing.assert_array_equal(tpipe.dense_schedule(S, M),
                                  jpipe.dense_schedule(S, M))
    assert tasm.emit(tpipe.stage_chain_graph(S)) == \
        jasm.emit(jpipe.stage_chain_graph(S))


def test_dataflow_schedule_handshake_cadence():
    S, M = 4, 6
    t = tpipe.dataflow_schedule(S, M)
    # one token per two cycles per arc: 2M + S - 2 steps, stage s fires
    # microbatch m at row s + 2m
    assert t.shape == (2 * M + S - 2, S)
    for s in range(S):
        rows = [r for r in range(t.shape[0]) if t[r, s] >= 0]
        assert [int(t[r, s]) for r in rows] == list(range(M))
        assert rows == [s + 2 * m for m in range(M)]
    d = tpipe.dense_schedule(S, M)
    assert d.shape == (M + S - 1, S)


def _events(run, graph, feeds, **kw):
    events = []
    res = run(graph, feeds, trace=events.append, **kw)
    return events, res


@pytest.mark.parametrize("name", sorted(tlib.HAND_BUILT))
def test_trace_events_equal_jax(name):
    """Every firing's (cycle, node, value), control operators, sinks and
    loops included, in the order the JAX oracle reports them."""
    bench = tlib.bubble_sort_graph(6) if name == "bubble_sort" \
        else tlib.BENCHES[name]()
    feeds = tlib.random_feeds(name, bench, 4, np.random.default_rng(3))
    jg = jasm.parse(tasm.emit(bench.graph), name=bench.graph.name)
    got, res = _events(run_reference, bench.graph, feeds, profile=True)
    want, _ = _events(jref, jg, feeds)
    assert got == want and len(got) == res.fired
    assert all(isinstance(v, int) for _, _, v in got)
    # a trace changes nothing else
    plain = run_reference(bench.graph, feeds, profile=True)
    assert (res.cycles, res.fired, res.counts) == (plain.cycles, plain.fired,
                                                   plain.counts)
    np.testing.assert_array_equal(res.node_fires, plain.node_fires)


def test_trace_is_keyword_only():
    g = tpipe.stage_chain_graph(2)
    res = run_reference(g, {"mb_in": [1, 2]}, (), np.int32, 100, True)
    assert res.profile is not None            # the sixth stays profile


def test_executor_not_ported():
    for fn in (tpipe.pipeline_apply, tpipe.make_stage_fn):
        with pytest.raises(NotImplementedError, match="A 10b"):
            fn(None, None)
