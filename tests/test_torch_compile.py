"""Port vs JAX package: ``repro_torch.core.compile``.

The capability probe and the executor ``compile`` picks equal the JAX
package's on the 7 benches and on random fabrics; every argument error
of the JAX ``compile`` raises the same exception type; the rewrite
pipeline (``optimize="full"``/``"sched"``) rewrites to the same fabric;
and every executor's results equal the JAX package's: ``"dag"`` streams
against JAX ``"dag"`` and each bench's own reference, ``"unrolled"``
against JAX ``compile_cyclic`` in every field (fibonacci's initial
tokens included), the engine backends against the JAX package's
reference engine and ``"xla"``.  Other dtypes and tensor tokens are held
against ``run_reference``.  ``partition=`` threads through ``compile`` as
through the JAX ``compile`` (resolved on the rewritten graph, refused by
the SSA executors), ``"auto"`` routing a P > 1 partition to ``"cuda"``
for scalar int32 tokens and to ``"torch"`` otherwise.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core import compile as jcomp  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import compile as tcomp  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.engine import run_reference  # noqa: E402
from repro_torch.core.graph import Graph, Op  # noqa: E402
from repro_torch.core.partition import partition_graph  # noqa: E402
from repro_torch.testing import (assert_same_result,  # noqa: E402
                                 random_graph, tokens_equal)

NAMES = sorted(tlib.HAND_BUILT)
DAG_NAMES = [n for n in NAMES if n != "fibonacci"]
LEVELS = [False, "spec", "full", "sched"]
RANDOM_SEEDS = range(12)


def _bench(lib, name):
    return lib.bubble_sort_graph(6) if name == "bubble_sort" \
        else lib.BENCHES[name]()


def _feeds(name, k=5, seed=1):
    return tlib.random_feeds(name, _bench(tlib, name), k,
                             np.random.default_rng(seed))


def _jax_graph(tg):
    return jasm.parse(tasm.emit(tg), name=tg.name)


def _executor_of_jax(run):
    """The executor a JAX ``compile(backend="auto")`` callable runs."""
    if hasattr(run, "engine"):
        return run.engine.backend
    return "dag" if run.traits.tokens_out_static else "unrolled"


# ---------------------------------------------------------------------------
# the probe and the executor choice
# ---------------------------------------------------------------------------
def _graphs():
    out = [(f"bench:{n}", _bench(tlib, n).graph) for n in NAMES]
    out += [(f"random:{s}", random_graph(s)) for s in RANDOM_SEEDS]
    return out


@pytest.mark.parametrize("tag,g", _graphs(), ids=[t for t, _ in _graphs()])
def test_traits_and_auto_executor_match_jax(tag, g):
    jg = _jax_graph(g)
    tt, jt = tcomp.GraphTraits.probe(g), jcomp.GraphTraits.probe(jg)
    assert (tt.cyclic, tt.control_ops, tt.has_inits) == (
        jt.cyclic, jt.control_ops, jt.has_inits), tag
    assert tt.tokens_out_static == jt.tokens_out_static
    assert tt.blockers() == jt.blockers()
    run = tcomp.compile(g, device="cpu")
    assert run.executor == _executor_of_jax(jcomp.compile(jg))
    assert run.traits == tt and run.report is None and run.partition is None


def test_executors_named():
    assert tcomp.EXECUTORS == ("auto", "dag", "unrolled", "torch", "cuda",
                               "reference")
    assert tcomp.BACKENDS_NOTE == "torch | cuda | reference"
    assert tcomp.OPTIMIZE_LEVELS == jcomp.OPTIMIZE_LEVELS


# every argument error of the JAX compile, as (kwargs, graph name); the
# port's names for the engine backends stand in for "xla"/"pallas"
ERRORS = [
    (dict(block_cycles=0), "dot_prod"),
    (dict(optimize="bogus"), "dot_prod"),
    (dict(backend="bogus"), "dot_prod"),
    (dict(optimize="spec"), "dot_prod"),
    (dict(optimize="spec", backend="dag"), "dot_prod"),
    (dict(optimize="sched", backend="unrolled"), "dot_prod"),
    (dict(optimize="sched", backend="auto"), "fibonacci"),
    (dict(profile=True), "dot_prod"),
    (dict(profile=True, backend="dag"), "dot_prod"),
    (dict(profile=True, backend="unrolled"), "fibonacci"),
    (dict(backend="dag"), "fibonacci"),
    (dict(backend="dag"), "random:2"),
    (dict(backend="dag", optimize="full"), "fibonacci"),
]


def _graph_named(name):
    if name.startswith("random:"):
        return random_graph(int(name.split(":")[1]))
    return _bench(tlib, name).graph


@pytest.mark.parametrize("kw,name", ERRORS,
                         ids=[f"{n}-{sorted(k.items())}" for k, n in ERRORS])
def test_errors_raise_as_jax(kw, name):
    g = _graph_named(name)
    with pytest.raises(Exception) as jerr:
        jcomp.compile(_jax_graph(g), **kw)
    with pytest.raises(jerr.type):
        tcomp.compile(g, device="cpu", **kw)


def test_lockstep_executor_refuses_token_presence_fabrics():
    fib = tlib.fibonacci_graph().graph
    jfib = jlib.fibonacci_graph().graph
    ctl = random_graph(2)
    assert tcomp.GraphTraits.probe(ctl).control_ops
    init_dag = Graph(name="init_dag")
    init_dag.add(Op.ADD, ["x", "i"], ["z"])
    init_dag.init("i", 5)
    for g, jg in ((fib, jfib), (ctl, _jax_graph(ctl)),
                  (init_dag, _jax_graph(init_dag))):
        with pytest.raises(ValueError) as jerr:
            jcomp.compile_dag(jg)
        with pytest.raises(ValueError):
            tcomp.compile_dag(g, device="cpu")
        assert jerr.type is ValueError
    with pytest.raises(ValueError, match="token-presence"):
        tcomp.compile(fib, backend="dag", device="cpu")


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


def test_compile_partition_threading():
    g = _chain_graph()
    feeds = {"x": [3, 4, 5]}
    ref = run_reference(g, feeds, profile=True)
    run = tcomp.compile(g, backend="auto", partition=2, profile=True,
                        device="cpu")
    assert run.partition.P == 2 and run.executor == "cuda"
    assert run.engine._part_on     # auto routed off the SSA path
    r = run(feeds)
    assert_same_result(r, ref, "auto", dispatches=False)
    np.testing.assert_array_equal(r.node_fires, ref.node_fires)
    r.profile.check()
    # other dtypes route to the stacked PyTorch program
    runf = tcomp.compile(g, dtype=np.float32, partition=2, device="cpu")
    assert runf.executor == "torch" and runf.engine._part_on
    assert float(runf({"x": [2.5]}).outputs["o"]) == 4.5
    # a degenerate resolution takes the traits dispatch (dag here)
    run1 = tcomp.compile(g, partition=1, device="cpu")
    assert run1.partition.P == 1 and not hasattr(run1, "engine")
    assert run1.executor == "dag"
    # "auto" resolves from the card count: P = 1 without a card
    runa = tcomp.compile(g, backend="cuda", partition="auto", device="cpu")
    assert runa.partition.P >= 1
    # the JAX compile threads the same partition
    jrun = jcomp.compile(
        _jax_graph(g), backend="auto", partition=2, profile=True)
    assert jrun.partition.assign == run.partition.assign
    assert_same_result(r, jrun(feeds), "jax", profile=True)
    # compile_graph passes it through; the resolution follows the rewrite
    rung = tcomp.compile_graph(g, backend="torch", partition=2,
                               optimize="full", device="cpu")
    assert rung.partition.P == 2
    assert len(rung.partition.assign) == len(rung.graph.nodes)


def test_partition_refused():
    """What a partition still cannot do: the SSA executors, the reference
    oracle, ``schedule=True``, tensor tokens, other dtypes on ``"cuda"``,
    and placement across cards (the JAX ``test_compile_partition_errors``
    and more)."""
    g = _chain_graph()
    with pytest.raises(ValueError, match="shard"):
        tcomp.compile(g, backend="dag", partition=2, device="cpu")
    with pytest.raises(ValueError, match="shard"):
        tcomp.compile(g, backend="unrolled", partition=2, device="cpu")
    with pytest.raises(ValueError, match="reference"):
        DataflowEngine(g, backend="reference", partition=2, device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        DataflowEngine(g, schedule=True, partition=2, device="cpu")
    with pytest.raises(ValueError, match="scalar"):
        DataflowEngine(g, backend="torch", partition=2, device="cpu",
                       token_shape=(2,))
    with pytest.raises(ValueError, match="int32"):
        DataflowEngine(g, partition=2, device="cpu", dtype=np.float32)
    # profile with the SSA executors still refuses once P resolves to 1
    with pytest.raises(ValueError, match="profile"):
        tcomp.compile(g, partition=1, profile=True, device="cpu")
    # schedule="auto" lets the partition win
    eng = DataflowEngine(g, schedule="auto", partition=2, device="cpu")
    assert eng._part_on and not eng._sched_on
    from repro_torch.core.multifabric import MultiFabric
    with pytest.raises(NotImplementedError, match="A 10b"):
        MultiFabric(g, partition_graph(g, 2), placement="shard_map")


def test_compile_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tlib.dot_product_graph(4).graph
    for backend in tcomp.EXECUTORS:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tcomp.compile(g, backend=backend)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcomp.compile_cyclic(tlib.fibonacci_graph().graph)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcomp.compile_dag_stream(g)


# ---------------------------------------------------------------------------
# results: the engine backends and the rewrite pipeline
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_reference_run(name, optimize):
    """The JAX compile's reference engine at ``optimize`` (no jit): its
    rewritten graph, report and profiled result on ``_feeds(name)``."""
    run = jcomp.compile(_bench(jlib, name).graph, backend="reference",
                        optimize=optimize, profile=True)
    return run.graph, run.report, run(_feeds(name))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("optimize", LEVELS, ids=[str(o) for o in LEVELS])
@pytest.mark.parametrize("backend", ["torch", "reference"])
def test_engine_executors_match_jax(name, optimize, backend):
    """One-cycle blocks simulate exactly the oracle's cycles, so every
    field (profile included) equals the JAX reference engine's; the
    rewritten fabric and its report equal the JAX pipeline's."""
    jg, jrep, want = _jax_reference_run(name, optimize)
    run = tcomp.compile(_bench(tlib, name).graph, backend=backend,
                        block_cycles=1, optimize=optimize, profile=True,
                        device="cpu")
    assert tasm.emit(run.graph) == jasm.emit(jg)
    if jrep is None:
        assert run.report is None
    else:
        assert (run.report.folded, run.report.identities, run.report.dead,
                run.report.nodes_after) == (jrep.folded, jrep.identities,
                                            jrep.dead, jrep.nodes_after)
    assert run.executor == backend and run.engine.backend == backend
    assert run.engine.optimize is (optimize is not False)
    sched = optimize == "sched" and name != "fibonacci"
    assert run.engine._sched_on is sched
    got = run(_feeds(name))
    assert_same_result(got, want, (name, optimize, backend),
                       dispatches=False, profile=True)
    assert got.dispatches == (1 if backend == "torch" else None)


@pytest.mark.parametrize("name", ["fibonacci", "dot_prod", "pop_count"])
def test_torch_executor_matches_xla(name):
    """K = 16 through compile: every field (dispatches and the profile's
    idle tail included) equals the JAX compile's "xla" engine."""
    f = _feeds(name)
    want = jcomp.compile(_bench(jlib, name).graph, backend="xla",
                         optimize="full", profile=True)(f)
    run = tcomp.compile(_bench(tlib, name).graph, backend="torch",
                        optimize="full", profile=True, device="cpu")
    assert run.engine.block_cycles == 16
    assert_same_result(run(f), want, name, profile=True)


def test_cuda_executor_on_the_plain_versions():
    """backend="cuda" with device="cpu" runs the kernels' plain versions:
    every field of the dynamic and the scheduled engine equals
    run_reference; other tokens are refused."""
    g = tlib.dot_product_graph(8).graph
    f = tlib.random_feeds("dot_prod", tlib.dot_product_graph(8), 6,
                          np.random.default_rng(0))
    for opt in (False, "full", "sched"):
        run = tcomp.compile(g, backend="cuda", optimize=opt, device="cpu")
        assert_same_result(run(f), run_reference(run.graph, f), opt,
                           dispatches=False)
        assert run.engine._sched_on is (opt == "sched")
    with pytest.raises(ValueError, match='backend="torch"'):
        tcomp.compile(g, backend="cuda", dtype=np.float32, device="cpu")


# ---------------------------------------------------------------------------
# results: the SSA executors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DAG_NAMES)
def test_dag_matches_jax_and_reference(name):
    tb, jb = _bench(tlib, name), _bench(jlib, name)
    f = _feeds(name, k=7, seed=3)
    run = tcomp.compile(tb.graph, backend="dag", device="cpu")
    assert run.executor == "dag"
    got = run(f)
    want = jcomp.compile(jb.graph, backend="dag")(f)
    assert set(got) == set(want) == set(tb.graph.output_arcs())
    for a in want:
        assert got[a].shape == (7,) and got[a].dtype == np.int32
        assert tokens_equal(got[a], want[a]), (name, a)
    ref = run_reference(tb.graph, f)
    for a, v in got.items():
        assert tokens_equal(v[-1], ref.outputs[a]) and ref.counts[a] == 7
    # the bench's own reference: the last output arc of bubble_sort
    # holds the largest key, the others one value each
    if name == "bubble_sort":
        v = np.stack([f[f"x{i}"] for i in range(6)], 1)
        np.testing.assert_array_equal(
            np.stack([got[a] for a in tb.out_arcs], 1), tb.reference(v))
    elif name == "dot_prod":
        n = len(tb.graph.input_arcs()) // 2
        a = np.stack([f[f"a{i}"] for i in range(n)], 1)
        b = np.stack([f[f"b{i}"] for i in range(n)], 1)
        np.testing.assert_array_equal(got[tb.out_arc], tb.reference(a, b))


def test_compile_dag_single_token():
    """compile_dag evaluates the fabric once on one token per input."""
    tb, jb = tlib.dot_product_graph(4), jlib.dot_product_graph(4)
    rng = np.random.default_rng(4)
    one = {a: np.int32(rng.integers(-50, 50)) for a in tb.graph.input_arcs()}
    got = tcomp.compile_dag(tb.graph, device="cpu")(one)
    want = jcomp.compile_dag(jb.graph)(one)
    for a in want:
        assert tokens_equal(got[a], want[a])


@functools.lru_cache(maxsize=None)
def _jax_unrolled(name):
    run = jcomp.compile(_bench(jlib, name).graph, backend="unrolled")
    return run(_feeds(name))


@pytest.mark.parametrize("name", NAMES)
def test_unrolled_matches_jax(name):
    """Every field, as the JAX compile_cyclic reports them (dispatches
    None, no profile)."""
    run = tcomp.compile(_bench(tlib, name).graph, backend="unrolled",
                        device="cpu")
    assert run.executor == "unrolled"
    got = run(_feeds(name))
    want = _jax_unrolled(name)
    assert_same_result(got, want, name)
    assert got.dispatches is None and got.profile is None \
        and got.node_fires is None
    assert_same_result(got, run_reference(_bench(tlib, name).graph,
                                          _feeds(name)), name,
                       dispatches=False)


@pytest.mark.parametrize("n", [0, 3, 10])
def test_fibonacci_compiled_matches_engine(n):
    """compile_cyclic against the engine (initial tokens, a cyclic
    fabric): outputs, cycles and fired, as the JAX package's own test
    holds them, and against the JAX compile_cyclic in every field."""
    tb = tlib.fibonacci_graph()
    feeds = tb.make_feeds(n)
    run = tcomp.compile_cyclic(tb.graph, dtype=np.int32, device="cpu")
    r2 = run(feeds)
    for backend in ("torch", "cuda"):
        r1 = DataflowEngine(tb.graph, backend=backend, device="cpu").run(feeds)
        assert int(r1.outputs["fibo"]) == int(r2.outputs["fibo"])
        assert r1.cycles == r2.cycles and r1.fired == r2.fired
    assert int(r2.outputs["fibo"]) == int(tb.reference(n))
    assert int(r2.outputs["pf"]) == n
    want = jcomp.compile_cyclic(jlib.fibonacci_graph().graph,
                                dtype=np.int32)(feeds)
    assert_same_result(r2, want, n)


def test_unrolled_max_cycles_cut():
    tb = tlib.fibonacci_graph()
    feeds = tb.make_feeds(12)
    run = tcomp.compile_cyclic(tb.graph, max_cycles=23, device="cpu",
                               block_cycles=8)
    got = run(feeds)
    assert got.cycles == 23
    assert_same_result(got, run_reference(tb.graph, feeds, max_cycles=23),
                       "cut", dispatches=False)
    assert_same_result(run(feeds, max_cycles=5),
                       run_reference(tb.graph, feeds, max_cycles=5), "cut5",
                       dispatches=False)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype,ts", [("uint32", ()), ("float32", ()),
                                      ("int32", (4,)), ("float32", (4,))])
def test_executors_in_dtype_and_shape(name, dtype, ts):
    """"dag", "unrolled", "torch" and "reference" in uint32 / float32 and
    on tokens of shape (4,), against run_reference bit for bit (the
    benches' float shifts are integral, C8)."""
    dt = np.dtype(dtype)
    tb = _bench(tlib, name)
    f = _feeds(name, k=4, seed=7)
    if ts:
        f = {a: np.asarray(v)[:, None] + np.arange(ts[0])
             for a, v in f.items()}
    ref = run_reference(tb.graph, f, ts, dt)
    for backend in ("unrolled", "torch", "reference"):
        run = tcomp.compile(tb.graph, ts, dt, backend=backend, device="cpu")
        got = run(f)
        assert_same_result(got, ref, (name, dtype, ts, backend),
                           dispatches=False)
        for a, c in got.counts.items():
            if c:
                assert got.outputs[a].dtype == dt
                assert np.shape(got.outputs[a]) == ts
    if name in DAG_NAMES:
        out = tcomp.compile(tb.graph, ts, dt, backend="dag",
                            device="cpu")(f)
        for a, v in out.items():
            assert v.dtype == dt and v.shape == (4, *ts)
            assert tokens_equal(v[-1], ref.outputs[a]), (name, a)


def test_compile_graph_is_compile():
    g = tlib.fir_filter_graph().graph
    f = _feeds("fir")
    a = tcomp.compile_graph(g, (), np.int32, 1000, "torch", 4, "full", True,
                            device="cpu")
    b = tcomp.compile(g, backend="torch", max_cycles=1000, block_cycles=4,
                      optimize="full", profile=True, device="cpu")
    assert tasm.emit(a.graph) == tasm.emit(b.graph)
    assert a.engine.block_cycles == 4 and a.engine.max_cycles == 1000
    assert_same_result(a(f), b(f), "compile_graph", profile=True)


def test_engine_callable_exposes_batches():
    """The engine executors hand out ``.engine`` (run_batch), as the JAX
    package's do."""
    g = tlib.dot_product_graph(4).graph
    run = tcomp.compile(g, backend="torch", device="cpu")
    fb = [tlib.random_feeds("dot_prod", tlib.dot_product_graph(4), 1 + b,
                            np.random.default_rng(b)) for b in range(3)]
    jeng = JEngine(_jax_graph(g), backend="xla", block_cycles=16)
    for got, want in zip(run.engine.run_batch(fb), jeng.run_batch(fb)):
        assert_same_result(got, want, "batch")
