"""The port's tracing frontend (``repro_torch.front``) held against the
JAX package's (``repro.front``), case for case with tests/test_front.py.

Each program is written twice, in torch and in JAX, and the two traces
must be the same fabric: equal per-opcode node counts and equal
``asm.emit`` text, and equal ``outputs``/``counts``/``cycles``/``fired``
under each package's ``run_reference`` on the same numpy-seeded streams.
Where JAX cannot build a program through ``jnp.where``/``jnp.maximum``/
``jnp.clip`` under jax 0.9.0 (ROADMAP C3), its JAX side is written with
``lax.select``/``lax.max``/``lax.min``/``lax.clamp``.  The port then runs
its fabrics on its own executors (``device="cpu"``: the kernels' plain
versions, nothing built) against numpy.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax import lax  # noqa: E402

from repro.core import asm as jasm  # noqa: E402
from repro.core.compile import compile_fn as jcompile_fn  # noqa: E402
from repro.core.engine import run_reference as jrun_reference  # noqa: E402
from repro.front import trace as jtrace  # noqa: E402
from repro_torch.core import asm, library  # noqa: E402
from repro_torch.core.compile import compile_fn, compile_graph  # noqa: E402
from repro_torch.core.engine import (DataflowEngine,  # noqa: E402
                                     run_reference)
from repro_torch.front import SUPPORTED, LoweringError, trace  # noqa: E402
from repro_torch.testing import assert_same_result  # noqa: E402

BACKENDS = ["reference", "torch", "cuda"]
I32 = np.int32


def op_counts(graph) -> dict:
    return dict(collections.Counter(n.op.name for n in graph.nodes))


def same_fabric(tprog, jprog, tag) -> None:
    """The two traces are one fabric: opcode counts, then asm text."""
    assert op_counts(tprog) == op_counts(jprog), tag
    assert asm.emit(tprog) == jasm.emit(jprog), tag


def same_runs(tprog, jprog, streams, tag, dtype=np.int32) -> None:
    """Both packages' oracles agree on every EngineResult field."""
    want = jrun_reference(jprog, jprog.make_feeds(*streams), dtype=dtype)
    got = run_reference(tprog, tprog.make_feeds(*streams), dtype=dtype)
    assert_same_result(got, want, tag, dispatches=False)


# ---------------------------------------------------------------------------
# the acceptance program suite: (torch fn, JAX fn, numpy reference, arity)
# every reference computes in int32 so wraparound matches the fabric
# ---------------------------------------------------------------------------
def _prog_where(x, y):
    return torch.where(x > y, x - y, y - x)


def _jprog_where(x, y):
    return lax.select(x > y, x - y, y - x)


def _ref_where(x, y):
    return np.where(x > y, x - y, y - x)


def _prog_horner(x):
    return ((2 * x + 3) * x - 7) * x + 5


def _ref_horner(x):
    return ((I32(2) * x + I32(3)) * x - I32(7)) * x + I32(5)


def _prog_saxpy(x, y):
    return 3 * x + y


def _prog_popc8(x):
    acc = (x >> 0) & 1
    for k in range(1, 8):
        acc = acc + ((x >> k) & 1)
    return acc


def _ref_popc8(x):
    acc = (x >> 0) & I32(1)
    for k in range(1, 8):
        acc = acc + ((x >> k) & I32(1))
    return acc


def _prog_clamp_relu(x):
    return torch.clamp(torch.clamp(x, min=0) * 3, 0, 100)


def _jprog_clamp_relu(x):
    return lax.clamp(0, lax.max(x, 0) * 3, 100)


def _ref_clamp_relu(x):
    return np.clip(np.maximum(x, I32(0)) * I32(3), 0, 100)


def _prog_logic(x, y):
    return ((x ^ y) | (x & 3)) + (x > y)


def _ref_logic(x, y):
    return ((x ^ y) | (x & I32(3))) + (x > y).astype(I32)


def _prog_powsum(x):
    return x ** 3 + x ** 2 - x


def _ref_powsum(x):
    return x ** 2 * x + x ** 2 - x


def _prog_negabs(x, y):
    return -x + abs(y) * 2


def _ref_negabs(x, y):
    return -x + np.abs(y) * I32(2)


def _prog_minmax(x, y):
    return torch.clamp(torch.maximum(x, y) - torch.minimum(x, y), max=1000)


def _jprog_minmax(x, y):
    return lax.min(lax.max(x, y) - lax.min(x, y), 1000)


def _ref_minmax(x, y):
    return np.minimum(np.maximum(x, y) - np.minimum(x, y), I32(1000))


PROGRAMS = {
    # name: (torch fn, JAX fn, numpy ref, arity)
    "where_absdiff": (_prog_where, _jprog_where, _ref_where, 2),
    "horner": (_prog_horner, _prog_horner, _ref_horner, 1),
    "saxpy": (_prog_saxpy, _prog_saxpy, lambda x, y: I32(3) * x + y, 2),
    "popc8": (_prog_popc8, _prog_popc8, _ref_popc8, 1),
    "clamp_relu": (_prog_clamp_relu, _jprog_clamp_relu, _ref_clamp_relu, 1),
    "logic_mix": (_prog_logic, _prog_logic, _ref_logic, 2),
    "powsum": (_prog_powsum, _prog_powsum, _ref_powsum, 1),
    "negabs": (_prog_negabs, _prog_negabs, _ref_negabs, 2),
    "minmax_span": (_prog_minmax, _jprog_minmax, _ref_minmax, 2),
}


def _streams(name, k=5, seed=0):
    arity = PROGRAMS[name][3]
    rng = np.random.default_rng([seed, len(name)])
    return [rng.integers(-99, 100, (k,)).astype(I32) for _ in range(arity)]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_traced_program_is_the_jax_fabric(name):
    fn, jfn, _, arity = PROGRAMS[name]
    tprog = trace(fn, *([I32] * arity), name=name)
    jprog = jtrace(jfn, *([I32] * arity), name=name)
    same_fabric(tprog, jprog, name)
    for seed in range(3):
        same_runs(tprog, jprog, _streams(name, seed=seed), (name, seed))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_traced_program_matches_numpy_reference(name, backend):
    fn, _, ref, arity = PROGRAMS[name]
    streams = _streams(name)
    want = np.asarray(ref(*streams), I32)
    run = compile_fn(fn, *([I32] * arity), backend=backend,
                     block_cycles=4, optimize="full", device="cpu")
    res = run(run.make_feeds(*streams))
    out = run.out_arcs[0]
    assert res.counts[out] == len(want), (name, backend)
    assert int(np.asarray(res.outputs[out])) == int(want[-1]), \
        (name, backend)


def test_traced_program_full_stream_bit_identical():
    """The auto executor (lockstep SSA over the stream) exposes every
    stream element, so the whole stream — not just the last drained
    token — is checked bit for bit against numpy for the select-free
    programs."""
    for name in ("horner", "saxpy", "popc8", "clamp_relu", "logic_mix",
                 "powsum", "negabs", "minmax_span"):
        fn, _, ref, arity = PROGRAMS[name]
        streams = _streams(name, k=16)
        want = np.asarray(ref(*streams), I32)
        run = compile_fn(fn, *([I32] * arity), backend="auto",
                         device="cpu")
        assert run.executor == "dag", name
        got = run(run.make_feeds(*streams))
        np.testing.assert_array_equal(
            np.asarray(got[run.out_arcs[0]], I32), want, err_msg=name)


def test_where_lowering_consumes_both_sides_per_token():
    """The select schema must consume BOTH operands every firing (the
    untaken side rides a BRANCH into a SINK) — alternating predicates
    over a long stream would otherwise deadlock on stale tokens."""
    prog = trace(_prog_where, I32, I32, name="where")
    ops = [n.op.name for n in prog.nodes]
    assert ops.count("BRANCH") == 2 and ops.count("DMERGE") == 1
    assert ops.count("SINK") == 2
    x = np.asarray([5, 1, 7, -9, 0, 3, 3, 100], I32)
    y = np.asarray([2, 9, 7, 4, -1, 3, 4, -100], I32)
    want = _ref_where(x, y)
    for backend in BACKENDS:
        eng = DataflowEngine(prog, backend=backend, block_cycles=4,
                             device="cpu")
        for i in range(len(x)):
            r = eng.run(prog.make_feeds(x[i:i + 1], y[i:i + 1]))
            assert r.counts[prog.out_arc] == 1
            assert int(np.asarray(r.outputs[prog.out_arc])) == \
                int(want[i]), (backend, i)


def test_const_heavy_program_folds_visibly():
    """Const-bound arguments (the paper's sticky input buses) become
    genuine const-fed operators, and the folding pass collapses them at
    compile time — the same report as the JAX package's."""
    def poly(x, a, b):
        return (a * b + a) * x + (a - b) * x

    run = compile_fn(poly, I32, I32, I32, backend="torch", block_cycles=4,
                     optimize="full", const_args={1: 6, 2: 7}, device="cpu")
    jrun = jcompile_fn(poly, I32, I32, I32, backend="xla", block_cycles=4,
                       optimize="full", const_args={1: 6, 2: 7})
    rep = run.report
    assert rep is not None and rep.folded >= 2
    assert rep.summary() == jrun.report.summary()
    assert asm.emit(run.graph) == jasm.emit(jrun.graph)
    assert len(run.graph.nodes) < len(run.traced.nodes)
    x = np.asarray([0, 1, -2, 10], I32)
    want = I32(6 * 7 + 6) * x + I32(6 - 7) * x
    res = run(run.make_feeds(x))
    out = run.out_arcs[0]
    assert res.counts[out] == 4
    assert int(np.asarray(res.outputs[out])) == int(want[-1])
    want_ref = run_reference(run.traced, run.make_feeds(x))
    assert want_ref.counts[out] == 4
    assert int(np.asarray(want_ref.outputs[out])) == int(want[-1])


def test_float_programs_reference_and_torch():
    """Float fabrics ("cuda" is int32-only) stay bit-identical to the
    engines' float ALU semantics, including -0.0 through neg."""
    def f(x, y):
        return 2.5 * x + y / 2.0 - torch.maximum(-x, y)

    def jf(x, y):
        return 2.5 * x + y / 2.0 - lax.max(-x, y)

    prog = trace(f, np.float32, np.float32)
    same_fabric(prog, jtrace(jf, np.float32, np.float32), "float")
    x = np.asarray([1.5, -2.0, 0.0, -0.0], np.float32)
    y = np.asarray([0.5, 0.25, -1.0, 4.0], np.float32)
    want = (np.float32(2.5) * x + y / np.float32(2.0)
            - np.maximum(-x, y)).astype(np.float32)
    feeds = prog.make_feeds(x, y)
    ref = run_reference(prog, feeds, dtype=np.float32)
    eng = DataflowEngine(prog, backend="torch", block_cycles=4,
                         device="cpu", optimize=True, dtype=np.float32)
    for res in (ref, eng.run(feeds)):
        assert res.counts[prog.out_arc] == 4
        got = np.asarray(res.outputs[prog.out_arc], np.float32)
        np.testing.assert_array_equal(got, want[-1])
    # neg of +0.0 must produce -0.0 (MUL by -1, not SUB from 0)
    pneg = trace(lambda x: -x, np.float32)
    rneg = run_reference(pneg, pneg.make_feeds(
        np.asarray([0.0], np.float32)), dtype=np.float32)
    assert np.signbit(np.asarray(rneg.outputs[pneg.out_arc]))


def test_float_consts_roundtrip_through_asm_signature():
    prog = trace(lambda x: 2.5 * x - 0.75, np.float32)
    assert asm.emit(prog) == jasm.emit(jtrace(lambda x: 2.5 * x - 0.75,
                                              np.float32))
    text = asm.emit(prog)
    g2 = asm.parse(text)
    assert sorted(g2.consts.values()) == sorted(prog.consts.values())
    assert asm.emit(g2) == text         # emit is a fixed point


# ---------------------------------------------------------------------------
# traced regenerations of hand-assembled library benches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hand,traced", [
    ("dot_prod", "dot_prod_traced"),
    ("pop_count", "pop_count_traced"),
    ("fir", "fir_traced"),
])
def test_traced_bench_matches_hand_built(hand, traced):
    hb = library.BENCHES[hand]()
    tb = library.BENCHES[traced]()
    fh = library.random_feeds(hand, hb, 4, np.random.default_rng(11))
    ft = library.random_feeds(traced, tb, 4, np.random.default_rng(11))
    want = run_reference(hb.graph, fh)
    got = run_reference(tb.graph, ft)
    assert got.counts[tb.out_arc] == want.counts[hb.out_arc] == 4
    assert int(np.asarray(got.outputs[tb.out_arc])) == \
        int(np.asarray(want.outputs[hb.out_arc]))


def test_traced_benches_run_every_backend_optimized():
    for name in ("horner", "saxpy", "relu_chain", "fir_traced"):
        bench = library.BENCHES[name]()
        feeds = library.random_feeds(name, bench, 3,
                                     np.random.default_rng(5))
        want = run_reference(bench.graph, feeds)
        for backend in ("torch", "cuda"):
            run = compile_graph(bench.graph, backend=backend,
                                block_cycles=4, optimize="full",
                                device="cpu")
            got = run(feeds)
            for a, c in want.counts.items():
                assert got.counts[a] == c, (name, backend, a)
                if c:
                    assert int(np.asarray(got.outputs[a])) == \
                        int(np.asarray(want.outputs[a])), (name, backend)


def test_fir_traced_identity_splice_visible():
    """fir_traced's c0 == 1 tap is a MUL-by-one the identity pass
    splices out, mirroring the hand-built fir bench's contract."""
    bench = library.BENCHES["fir_traced"]()
    run = compile_graph(bench.graph, backend="torch", block_cycles=4,
                        optimize="full", device="cpu")
    assert run.report.identities >= 1
    assert len(run.graph.nodes) < len(bench.graph.nodes)


# ---------------------------------------------------------------------------
# serving integration: a traced program is just another asm signature
# ---------------------------------------------------------------------------
def test_traced_program_through_dataflow_server():
    """Equal traces share one engine; the port's server answers every
    request as the JAX server does (same fabric, same feeds)."""
    from repro.serve.dataflow_server import DataflowServer as JServer
    from repro_torch.serve.dataflow_server import (DataflowServer,
                                                   cached_engine,
                                                   clear_engine_cache)
    clear_engine_cache()
    prog = trace(_prog_where, I32, I32, name="where_srv")
    prog2 = trace(_prog_where, I32, I32, name="where_srv")
    e1 = cached_engine(prog, block_cycles=4, device="cpu")
    e2 = cached_engine(prog2, block_cycles=4, device="cpu")
    assert e1 is e2
    jprog = jtrace(_jprog_where, I32, I32, name="where_srv")
    srv = DataflowServer(prog, slots=2, block_cycles=4, device="cpu")
    jsrv = JServer(jprog, slots=2, block_cycles=4, backend="xla")
    rng = np.random.default_rng(3)
    reqs = [prog.make_feeds(rng.integers(-99, 99, (k,)),
                            rng.integers(-99, 99, (k,)))
            for k in (1, 4, 2, 6, 3)]
    uids = [srv.submit(f) for f in reqs]
    juids = [jsrv.submit(f) for f in reqs]
    assert uids == juids
    got = {r.uid: r for r in srv.drain()}
    want = {r.uid: r for r in jsrv.drain()}
    eng = DataflowEngine(prog, block_cycles=4, device="cpu")
    for uid, feeds in zip(uids, reqs):
        r = got[uid].engine
        assert_same_result(r, want[uid].engine, uid, dispatches=False)
        assert_same_result(r, eng.run(feeds), uid, dispatches=False)
        assert got[uid].metrics.tokens_out == \
            want[uid].metrics.tokens_out == sum(r.counts.values())
        assert got[uid].metrics.residency_blocks == \
            want[uid].metrics.residency_blocks


def test_dataflow_server_for_fn():
    from repro_torch.serve.dataflow_server import DataflowServer
    srv = DataflowServer.for_fn(_prog_where, I32, I32, slots=2,
                                block_cycles=4, device="cpu")
    assert srv.traced.name == "_prog_where"
    x = np.asarray([5, 1, 7], I32)
    y = np.asarray([2, 9, 7], I32)
    srv.submit(srv.make_feeds(x, y))
    uid = srv.submit_args(x[:2], y[:2])
    res = {r.uid: r for r in srv.drain()}
    out = srv.traced.out_arc
    assert res[1].metrics.tokens_out == 3
    assert int(np.asarray(res[1].engine.outputs[out])) == \
        int(_ref_where(x, y)[-1])
    assert res[uid].engine.counts[out] == 2
    with pytest.raises(AttributeError, match="for_fn"):
        DataflowServer(srv.graph, slots=1, device="cpu").submit_args(1, 2)


# ---------------------------------------------------------------------------
# precise rejection + feed adapter behavior
# ---------------------------------------------------------------------------
def test_lowering_errors_name_the_op():
    with pytest.raises(LoweringError, match="'floor_divide.default'"):
        trace(lambda x, y: x // y, I32, I32)
    with pytest.raises(LoweringError, match="'div.Tensor' is true div"):
        trace(lambda x, y: x / y, I32, I32)
    with pytest.raises(LoweringError, match="'div.Tensor_mode'"):
        trace(lambda x, y: torch.div(x, y, rounding_mode="floor"),
              np.float32, np.float32)
    with pytest.raises(LoweringError, match="'sin.default'"):
        trace(lambda x: torch.sin(x), np.float32)
    with pytest.raises(LoweringError, match="'remainder.Tensor'"):
        trace(lambda x, y: torch.clamp(x % y, min=0), I32, I32)
    with pytest.raises(LoweringError, match="'pow.Tensor_Scalar'"):
        trace(lambda x: x ** 3, np.float32)
    with pytest.raises(LoweringError, match="'add.Tensor' mixes"):
        trace(lambda x: x + 1.5, I32)
    with pytest.raises(LoweringError, match="'gt.Scalar' mixes"):
        trace(lambda x: torch.where(x > 0.5, x, 0), I32)
    with pytest.raises(LoweringError, match="'_to_copy.default' converts"):
        trace(lambda x: x.to(torch.float32) * 2.0, I32)
    with pytest.raises(LoweringError, match="'bitwise_not.default'"):
        trace(lambda x: (~(x > 0)).to(torch.int32), I32)
    with pytest.raises(LoweringError, match="compile-time constant"):
        trace(lambda x: 5, I32)
    with pytest.raises(LoweringError, match="mixed aval dtypes"):
        trace(lambda x, y: x + y, I32, np.float32)
    with pytest.raises(LoweringError, match="shape"):
        trace(lambda x: x, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(LoweringError, match="shape"):
        trace(lambda x: x + torch.zeros(3, dtype=torch.int32), I32)
    with pytest.raises(LoweringError, match="closure constant of shape"):
        table = torch.arange(4, dtype=torch.int32)
        trace(lambda x: x * table.sum(), I32)
    with pytest.raises(LoweringError, match="at least one aval"):
        trace(lambda: 1)
    with pytest.raises(LoweringError, match="const-bound"):
        trace(lambda x: x + 1, I32, const_args={0: 3})
    with pytest.raises(LoweringError, match="out of range"):
        trace(lambda x, y: x + y, I32, I32, const_args={7: 3})
    with pytest.raises(LoweringError, match="dtype bool"):
        trace(lambda x: x, torch.bool)
    with pytest.raises(LoweringError, match="dtype complex64"):
        trace(lambda x: x, np.complex64)


def test_avals_and_constants_canonicalize_as_jax():
    """numpy and torch dtypes, Python and numpy scalars and 0-d tensors
    name the same fabric dtype (64-bit narrows to 32, as JAX's avals do);
    0-d constants of any spelling become the same const bus."""
    for aval, dt in ((np.int32, I32), (torch.int32, I32), (3, I32),
                     (True, I32), (np.int64, I32), (torch.int64, I32),
                     (2.5, np.float32), (torch.float64, np.float32),
                     (np.float32(1), np.float32),
                     (torch.zeros((), dtype=torch.float32), np.float32)):
        assert trace(lambda x: x + 1, aval).dtype == np.dtype(dt), aval
    want = asm.emit(trace(lambda x: x + 5, I32))
    five = torch.tensor(5, dtype=torch.int32)
    for spell in (lambda x: x + torch.full((), 5, dtype=torch.int32),
                  lambda x: x + torch.scalar_tensor(5, dtype=torch.int32),
                  lambda x: x + five):
        assert asm.emit(trace(spell, I32)) == want
    assert set(SUPPORTED) >= {"add.Tensor", "where.self", "while_loop",
                              "pow.Tensor_Scalar", "clamp.default"}


def test_feed_adapter_contract():
    prog = trace(lambda x, y: x + y, I32, I32)
    with pytest.raises(ValueError, match="expected 2 argument streams"):
        prog.make_feeds([1, 2])
    with pytest.raises(ValueError, match="tokens"):
        prog.make_feeds([1, 2, 3], [1, 2])
    with pytest.raises(ValueError, match="shape"):
        prog.make_feeds(np.zeros((2, 2)), [1, 2])
    # scalars broadcast to the common stream length
    feeds = prog.make_feeds(7, [1, 2, 3])
    assert feeds["in0"].shape == (3,) and (feeds["in0"] == 7).all()
    # unused arguments take (and ignore) a stream slot
    p2 = trace(lambda x, y: x * 2, I32, I32)
    assert p2.arg_arcs[1] is None
    r = run_reference(p2, p2.make_feeds([1, 2], [9, 9]))
    assert int(np.asarray(r.outputs[p2.out_arc])) == 4
    jp2 = jtrace(lambda x, y: x * 2, I32, I32)
    for args in ((7, [1, 2, 3]), ([1, 2], [9, 9])):
        got = p2.make_feeds(*args)
        want = jp2.make_feeds(*args)
        assert got.keys() == want.keys()
        for a in want:
            np.testing.assert_array_equal(got[a], want[a])
            assert got[a].dtype == want[a].dtype


def test_multi_output_and_duplicate_outputs():
    prog = trace(lambda x, y: (x + y, x - y, x + y), I32, I32)
    assert len(prog.out_arcs) == 3
    assert len(set(prog.out_arcs)) == 3     # duplicates get own buses
    assert asm.emit(prog) == jasm.emit(
        jtrace(lambda x, y: (x + y, x - y, x + y), I32, I32))
    feeds = prog.make_feeds([5, 8], [2, 3])
    r = run_reference(prog, feeds)
    vals = [int(np.asarray(r.outputs[a])) for a in prog.out_arcs]
    assert vals == [11, 5, 11]
    assert all(r.counts[a] == 2 for a in prog.out_arcs)


def test_passthrough_output_keeps_arc_classes_disjoint():
    prog = trace(lambda x, y: x, I32, I32)
    prog.validate()
    assert set(prog.input_arcs()).isdisjoint(prog.output_arcs())
    assert asm.emit(prog) == jasm.emit(jtrace(lambda x, y: x, I32, I32))
    r = run_reference(prog, prog.make_feeds([3, 1, 4], [0, 0, 0]))
    assert r.counts[prog.out_arc] == 3
    assert int(np.asarray(r.outputs[prog.out_arc])) == 4


def test_trace_is_deterministic():
    a = asm.emit(trace(_prog_clamp_relu, I32))
    b = asm.emit(trace(_prog_clamp_relu, I32))
    assert a == b
