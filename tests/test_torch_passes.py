"""Port vs JAX package: the graph-rewriting passes.

``optimize_graph`` runs constant folding, identity splicing and dead-node
elimination to a fixpoint.  The same fabric (sent across as asm text)
goes through both packages' passes at int32 and float32; the rewritten
fabrics must emit the same asm text and the reports must be equal.  The
rewritten fabric then runs on the port's engine and keeps the authored
fabric's last values and token counts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core import passes as jpasses  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core import passes as tpasses  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.engine import run_reference  # noqa: E402
from repro_torch.core.graph import Graph, Op  # noqa: E402
from repro_torch.testing import random_graph  # noqa: E402

DTYPES = [np.int32, np.float32]


def _both(tg, dtype):
    jg = jasm.parse(tasm.emit(tg), name=tg.name)
    jo, jrep = jpasses.optimize_graph(jg, dtype)
    to, trep = tpasses.optimize_graph(tg, dtype)
    assert tasm.emit(to) == jasm.emit(jo)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.summary() == jrep.summary()
    return to, trep


def _identities_graph():
    """x + 0, then * 1, then a folded const chain, and a dead const
    region: every pass has work."""
    g = Graph(name="rewrites")
    g.add(Op.ADD, ["x", g.const("zero", 0)], ["s"])
    g.add(Op.MUL, ["s", g.const("one", 1)], ["m"])
    g.add(Op.ADD, [g.const("c2", 2), g.const("c3", 3)], ["k"])
    g.add(Op.SUB, ["m", "k"], ["y"])
    g.add(Op.MUL, [g.const("d1", 7), g.const("d2", 9)], ["dead"])
    g.add(Op.SINK, ["dead"], [])
    g.validate()
    return g


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(tlib.HAND_BUILT))
def test_optimize_graph_matches_jax_on_benches(name, dtype):
    _both(tlib.BENCHES[name]().graph, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(24))
def test_optimize_graph_matches_jax_on_random_graphs(seed, dtype):
    _both(random_graph(seed), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_pass_rewrites(dtype):
    g, rep = _both(_identities_graph(), dtype)
    assert rep.folded and rep.identities and rep.dead, rep
    assert len(g.nodes) < rep.nodes_before


def test_passes_bail_out_on_a_racy_ndmerge():
    g = Graph(name="racy")
    g.add(Op.NDMERGE, ["p", "q"], ["m"])
    g.add(Op.ADD, ["m", g.const("zero", 0)], ["y"])
    g.validate()
    to, rep = _both(g, np.int32)
    assert not rep.changed and tasm.emit(to) == tasm.emit(g)


@pytest.mark.parametrize("name", ["pop_count", "fir"])
def test_rewritten_fabric_keeps_outputs(name):
    """The spliced fabric drains the same last values and token counts
    on the port's engine (cycles and firings may shrink)."""
    bench = tlib.BENCHES[name]()
    g, rep = tpasses.optimize_graph(bench.graph)
    assert rep.changed
    feeds = tlib.random_feeds(name, bench, 5, np.random.default_rng(0))
    want = run_reference(bench.graph, feeds)
    got = DataflowEngine(g, block_cycles=8, device="cpu",
                         optimize=True).run(feeds)
    assert got.counts == want.counts
    for a, c in want.counts.items():
        if c:
            assert int(got.outputs[a]) == int(want.outputs[a])
    assert got.fired < want.fired


def test_jax_bench_graph_round_trips():
    """The benches the tests above send across are node-for-node the
    JAX package's."""
    for name in tlib.HAND_BUILT:
        assert tasm.emit(tlib.BENCHES[name]().graph) == \
            jasm.emit(jlib.BENCHES[name]().graph)
