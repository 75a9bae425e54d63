"""Port vs JAX package: the ``"torch"`` backend and its ALU.

The torch ALU is held bit for bit to the JAX package's ``_alu_op`` and to
the port's ``alu_numpy`` on the edge operands of the JAX package's own
ALU tests, in int32, uint32 and float32: the signed-zero tie of MAX/MIN
(ROADMAP C1) and uint32 arithmetic in its int64 carrier (C2) included.
Float SHL/SHR are held to ``alu_numpy`` alone (C8): bit for bit at
integral shifts in [-149, 126]; elsewhere they differ in exp2 alone.

``DataflowEngine(backend="torch", device="cpu")`` is held against the
JAX package's ``"xla"`` engine in every EngineResult field, the profile
included at every K (the counters cover every simulated cycle, the idle
tail of the last block and the remainder cycles included, as on
``"xla"``), and against ``run_reference``: here on a cap in mid-block,
tensor tokens and scheduled runs; and what the backends refuse.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import library as jlib  # noqa: E402
from repro.core import passes as jpasses  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro.core.engine import _alu_op as j_alu_op  # noqa: E402
from repro.core.engine import run_reference as j_run_reference  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core import passes as tpasses  # noqa: E402
from repro_torch.core.engine import (DataflowEngine, _alu_op,  # noqa: E402
                                     alu_numpy, from_carrier, run_reference,
                                     to_carrier)
from repro_torch.core.graph import Graph, Op  # noqa: E402
from repro_torch.testing import assert_same_result, tokens_equal  # noqa: E402

VALUE_OPS = [op for op in Op if op not in (Op.DMERGE, Op.NDMERGE)]
# the JAX package's ALU edge operands (tests/test_passes.py)
EDGES = {
    np.int32: [-(2 ** 31), -(2 ** 31) + 1, -40, -2, -1, 0, 1, 5, 31, 32,
               33, 40, 2 ** 31 - 1],
    np.uint32: [0, 1, 2, 5, 7, 31, 32, 40, 2 ** 31, 2 ** 32 - 1],
    np.float32: [-np.inf, -200.0, -1.5, -0.0, 0.0, 0.5, 1.0, 200.0, np.inf],
}


def _torch_alu(op, a, b, dt):
    return from_carrier(_alu_op(op, to_carrier(a, dt, "cpu"),
                                to_carrier(b, dt, "cpu"), dt), dt)


def _ulps(got, want):
    """|got - want| in float32 ulps (monotone integer order of the bits);
    NaN against NaN counts 0, NaN against a number a huge distance."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(2 ** 31) - i, i)
    d = np.abs(key(got) - key(want))
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    return np.where(nan_g & nan_w, 0, np.where(nan_g | nan_w, 2 ** 40, d))


def _grid(dt, vals):
    A, B = np.meshgrid(np.asarray(vals, dt), np.asarray(vals, dt))
    return A.ravel(), B.ravel()


# ---------------------------------------------------------------------------
# the torch ALU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", [np.int32, np.uint32, np.float32],
                         ids=["int32", "uint32", "float32"])
@pytest.mark.parametrize("op", VALUE_OPS, ids=[o.name for o in VALUE_OPS])
def test_alu_matches_jax_and_numpy_on_edge_operands(op, dt):
    a, b = _grid(dt, EDGES[dt])
    got = _torch_alu(op, a, b, dt)
    with np.errstate(all="ignore"):
        want = np.asarray(alu_numpy(op, a, b, dt), dt)
    assert got.dtype == np.dtype(dt)
    assert tokens_equal(got, want), (op, dt)
    if dt is np.float32 and op in (Op.SHL, Op.SHR):
        return                  # C8: XLA's exp2 is not the reference's
    jx = np.asarray(j_alu_op(op, jnp.asarray(a), jnp.asarray(b), dt)
                    ).astype(dt, copy=False)
    assert tokens_equal(got, jx), (op, dt)


@pytest.mark.parametrize("op", [Op.SHL, Op.SHR], ids=["SHL", "SHR"])
def test_float_shifts_against_numpy(op):
    """C8: bit for bit at every integral shift in [-149, 126].  At
    fractional shifts the two differ in exp2 alone (the ALU's result is
    alu_numpy's formula on torch's exp2): by at most one ulp for |b| <=
    20, and by at most 3 ulps out to the float32 range (measured on CPU
    torch 2.13 against numpy 2.0)."""
    rng = np.random.default_rng(int(op))
    a = np.concatenate([np.asarray(EDGES[np.float32], np.float32),
                        rng.standard_normal(40).astype(np.float32) * 1e3])
    ints = np.arange(-149, 127, dtype=np.float32)
    A, B = np.meshgrid(a, ints)
    got = _torch_alu(op, A.ravel(), B.ravel(), np.float32)
    with np.errstate(all="ignore"):
        want = alu_numpy(op, A.ravel(), B.ravel(), np.float32)
    assert tokens_equal(got, want)
    frac = (rng.random(4000) * 300 - 160).astype(np.float32)
    two_t = torch.exp2(torch.from_numpy(frac)).numpy()
    with np.errstate(all="ignore"):
        ulps = _ulps(two_t, np.exp2(frac))
    assert ulps[np.abs(frac) <= 20].max() <= 1 and ulps.max() <= 3
    A, B = np.meshgrid(a, frac)
    T = np.broadcast_to(two_t[:, None], A.shape)
    with np.errstate(all="ignore"):
        want = A * T if op == Op.SHL else A / np.where(T == 0, 1, T)
    assert tokens_equal(_torch_alu(op, A.ravel(), B.ravel(), np.float32),
                        want.ravel().astype(np.float32))


def test_signed_zero_max_min_either_order():
    """C1: max(+0., -0.) is +0. and min(+0., -0.) is -0., whatever the
    operand order; a plain torch.maximum keeps the second zero."""
    a = np.asarray([0.0, -0.0, -0.0, 0.0], np.float32)
    b = np.asarray([-0.0, 0.0, -0.0, 0.0], np.float32)
    sign = lambda x: np.signbit(x).tolist()
    assert sign(_torch_alu(Op.MAX, a, b, np.float32)) == [0, 0, 1, 0]
    assert sign(_torch_alu(Op.MIN, a, b, np.float32)) == [1, 1, 1, 0]
    assert sign(torch.maximum(torch.tensor(a), torch.tensor(b)).numpy()) \
        != [0, 0, 1, 0]
    for op in (Op.MAX, Op.MIN):
        jx = np.asarray(j_alu_op(op, jnp.asarray(a), jnp.asarray(b),
                                 np.float32))
        assert sign(_torch_alu(op, a, b, np.float32)) == sign(jx)


def test_uint32_rides_in_int64():
    """C2: uint32 tokens are carried as int64 holding 0 .. 2^32 - 1 (CPU
    torch refuses +, >>, maximum, //, < of torch.uint32), and every op
    stays in range."""
    a, b = _grid(np.uint32, EDGES[np.uint32])
    ta, tb = to_carrier(a, np.uint32, "cpu"), to_carrier(b, np.uint32, "cpu")
    assert ta.dtype == torch.int64
    for op in VALUE_OPS:
        r = _alu_op(op, ta, tb, np.uint32)
        assert r.dtype == torch.int64 and int(r.min()) >= 0 \
            and int(r.max()) < 2 ** 32, op


@pytest.mark.parametrize("op,dt,a,b,want", [
    (Op.DIV, np.int32, -(2 ** 31), -1, -(2 ** 31)),
    (Op.DIV, np.int32, -(2 ** 31), 0, 0),
    (Op.DIV, np.int32, -7, 2, -4),
    (Op.SUB, np.int32, 0, -(2 ** 31), -(2 ** 31)),
    (Op.SHL, np.int32, 1, 40, -(2 ** 31)),
    (Op.SHL, np.int32, 1, 31, -(2 ** 31)),
    (Op.SHR, np.int32, -(2 ** 31), 40, -1),
    (Op.SHR, np.int32, -8, 31, -1),
    (Op.SHL, np.int32, 1, -5, 1),
    (Op.MUL, np.int32, 2 ** 31 - 1, 2, -2),
    (Op.SUB, np.uint32, 0, 1, 2 ** 32 - 1),
    (Op.ADD, np.uint32, 2 ** 32 - 1, 2, 1),
    (Op.SHR, np.uint32, 2 ** 32 - 1, 31, 1),
    (Op.MUL, np.uint32, 2 ** 32 - 1, 2 ** 32 - 1, 1),
    (Op.SHL, np.uint32, 2 ** 32 - 1, 4, 2 ** 32 - 16),
    (Op.DIV, np.uint32, 2 ** 32 - 1, 2, 2 ** 31 - 1),
    (Op.IFLT, np.uint32, 1, 2 ** 31, 1),
    (Op.MAX, np.uint32, 2 ** 31, 1, 2 ** 31),
])
def test_alu_integer_edges_pin_exact_values(op, dt, a, b, want):
    """The JAX package's pinned integer edges and a few more, asserted
    against their two's-complement / unsigned results."""
    got = _torch_alu(op, np.asarray([a], dt), np.asarray([b], dt), dt)
    assert got.dtype == np.dtype(dt) and int(got[0]) == want, (op, got)


def test_alu_on_tensor_tokens():
    """Tokens of shape [*, 4] go element by element."""
    rng = np.random.default_rng(3)
    a = rng.choice(EDGES[np.int32], (6, 4)).astype(np.int32)
    b = rng.choice(EDGES[np.int32], (6, 4)).astype(np.int32)
    for op in VALUE_OPS:
        with np.errstate(all="ignore"):
            want = np.asarray(alu_numpy(op, a, b, np.int32), np.int32)
        assert tokens_equal(_torch_alu(op, a, b, np.int32), want), op


# ---------------------------------------------------------------------------
# the "torch" engine against JAX "xla" (the 7-bench matrix is in
# test_torch_backend_runs.py, uint32 / float32 / tensor tokens in
# test_torch_backend_dtypes.py)
# ---------------------------------------------------------------------------
def test_max_cycles_cut_mid_block():
    """A cap that is not a multiple of K: the loop stops at the last whole
    block under it and max_cycles % K remainder cycles follow, for every
    stream; each field equals "xla"'s, profile included."""
    jb, tb = jlib.fibonacci_graph(), tlib.fibonacci_graph()
    feeds = [tb.make_feeds(n) for n in (20, 2, 30)]
    jeng = JEngine(jb.graph, backend="xla", block_cycles=16, profile=True)
    eng = DataflowEngine(tb.graph, backend="torch", block_cycles=16,
                         device="cpu", profile=True)
    for mc in (41, 7):
        want = jeng.run(feeds[0], max_cycles=mc)
        assert want.cycles == mc                    # it really truncated
        assert_same_result(eng.run(feeds[0], max_cycles=mc), want, mc,
                           profile=True)
        for g, w in zip(eng.run_batch(feeds, max_cycles=mc),
                        jeng.run_batch(feeds, max_cycles=mc)):
            assert_same_result(g, w, ("batch", mc), profile=True)
        for f in feeds:
            assert_same_result(eng.run(f, max_cycles=mc),
                               run_reference(tb.graph, f, max_cycles=mc),
                               mc, dispatches=False)


def test_tensor_tokens():
    """The JAX package's tensor-token fabric at token_shape=(4,), float32:
    every field equals "xla"'s, and the value is (3 + 4) * 2."""
    def build(G):
        g = G()
        g.add(Op.ADD, ["a", "b"], ["s"])
        g.add(Op.MUL, ["s", "c"], ["z"])
        return g
    from repro.core.graph import Graph as JGraph
    ones = np.ones((1, 4), np.float32)
    feeds = {"a": ones * 3, "b": ones * 4, "c": ones * 2}
    want = JEngine(build(JGraph), token_shape=(4,), dtype=np.float32,
                   profile=True).run(feeds)
    got = DataflowEngine(build(Graph), backend="torch", device="cpu",
                         token_shape=(4,), dtype=np.float32,
                         profile=True).run(feeds)
    assert_same_result(got, want, "tensor", profile=True)
    assert got.outputs["z"].shape == (4,)
    np.testing.assert_array_equal(got.outputs["z"], 14.0)


@pytest.mark.parametrize("dtype", [np.uint32, np.float32],
                         ids=["uint32", "float32"])
def test_scheduled_dtypes(dtype):
    """schedule=True on "torch": the rewritten fir fabric in uint32 and
    float32, against the JAX scheduled "xla" run and run_reference in
    every field (profile included), solo and batched."""
    dt = np.dtype(dtype)
    jg, _ = jpasses.optimize_graph(jlib.fir_filter_graph().graph, dtype=dt)
    tg, _ = tpasses.optimize_graph(tlib.fir_filter_graph().graph, dtype=dt)
    bench = tlib.fir_filter_graph()
    feeds = [tlib.random_feeds("fir", bench, 12, np.random.default_rng(s))
             for s in range(3)]
    jeng = JEngine(jg, dtype=dt, backend="xla", block_cycles=4,
                   max_cycles=4096, schedule=True, profile=True)
    eng = DataflowEngine(tg, backend="torch", block_cycles=4,
                         max_cycles=4096, device="cpu", schedule=True,
                         profile=True, dtype=dt)
    assert eng._sched_on
    for g, w, f in zip(eng.run_batch(feeds), jeng.run_batch(feeds), feeds):
        assert_same_result(g, w, dt.name, profile=True)
        assert_same_result(eng.run(f), w, dt.name, profile=True)
        assert_same_result(g, run_reference(tg, f, dtype=dt, profile=True,
                                             max_cycles=4096),
                           dt.name, dispatches=False, profile=True)


def test_scheduled_float_shifts_against_reference():
    """pop_count in float32 shifts by up to 15, where XLA's exp2 is
    inexact (C8): the scheduled and dynamic "torch" runs are held to
    run_reference, bit for bit."""
    bench = tlib.popcount_graph()
    f = tlib.random_feeds("pop_count", bench, 9, np.random.default_rng(2))
    want = run_reference(bench.graph, f, dtype=np.float32, profile=True)
    want_j = j_run_reference(jlib.popcount_graph().graph, f,
                             dtype=np.float32, profile=True)
    assert_same_result(want, want_j, "oracles", dispatches=False,
                       profile=True)
    for sched in (False, True):
        eng = DataflowEngine(bench.graph, backend="torch", block_cycles=1,
                             device="cpu", schedule=sched, profile=True,
                             dtype=np.float32)
        assert_same_result(eng.run(f), want, sched, dispatches=False,
                           profile=True)


# ---------------------------------------------------------------------------
# the constructor, and what the backends refuse
# ---------------------------------------------------------------------------
def test_constructor_keywords_keep_positional_calls():
    """token_shape and dtype come as keywords after the existing
    arguments: every positional call keeps its meaning."""
    g = tlib.dot_product_graph(4).graph
    eng = DataflowEngine(g, 500, "reference", 4, "cpu", True, True, "auto")
    assert (eng.max_cycles, eng.backend, eng.block_cycles, eng.device.type,
            eng.optimize, eng.profile, eng.schedule) == (
        500, "reference", 4, "cpu", True, True, "auto")
    assert eng.token_shape == () and eng.dtype == np.int32
    with pytest.raises(TypeError):
        DataflowEngine(g, 500, "torch", 4, "cpu", False, False, False, (4,))
    eng = DataflowEngine(g, backend="torch", device="cpu", token_shape=[2],
                         dtype="float32")
    assert eng.token_shape == (2,) and eng.dtype == np.float32
    assert DataflowEngine(g, backend="torch", device="cpu",
                          dtype=torch.uint32).dtype == np.uint32
    with pytest.raises(ValueError, match="token dtype"):
        DataflowEngine(g, backend="torch", device="cpu", dtype=np.int16)


def test_reference_backend_takes_dtype_and_shape():
    g = tlib.dot_product_graph(4).graph
    f = tlib.random_feeds("dot_prod", tlib.dot_product_graph(4), 3,
                          np.random.default_rng(0))
    for kw in (dict(dtype=np.float32), dict(dtype=np.uint32),
               dict(token_shape=(3,))):
        eng = DataflowEngine(g, backend="reference", device="cpu", **kw)
        want = run_reference(g, f, kw.get("token_shape", ()),
                             kw.get("dtype", np.int32))
        assert_same_result(eng.run(f), want, kw, dispatches=False)
        torch_eng = DataflowEngine(g, backend="torch", device="cpu", **kw)
        assert_same_result(torch_eng.run(f), want, kw, dispatches=False)


def test_slot_api_refuses_on_torch():
    """The slot API runs the slot kernels on "cuda" only; on "torch" it
    would be a kernel's plain version serving, so every method refuses,
    naming backend="cuda"."""
    eng = DataflowEngine(tlib.fibonacci_graph().graph, backend="torch",
                         device="cpu")
    for call in (lambda: eng.init_state(2),
                 lambda: eng.reset_slots(None, [0], [{}]),
                 lambda: eng.step_block(None),
                 lambda: eng.harvest(None, [0])):
        with pytest.raises(ValueError, match='backend="cuda"'):
            call()


@pytest.mark.parametrize("kw", [dict(dtype=np.float32), dict(dtype=np.uint32),
                                dict(token_shape=(4,))],
                         ids=["float32", "uint32", "shape4"])
def test_cuda_backend_refuses_other_tokens(kw):
    """"cuda" keeps scalar int32 tokens: anything else raises, and is
    never routed to "torch"."""
    g = tlib.fibonacci_graph().graph
    with pytest.raises(ValueError, match='backend="torch"'):
        DataflowEngine(g, device="cpu", **kw)
    with pytest.raises(ValueError, match='backend="torch"'):
        DataflowEngine(g, backend="cuda", device="cpu", schedule="auto",
                       **kw)


def test_torch_backend_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DataflowEngine(tlib.fibonacci_graph().graph, backend="torch")
