"""The ten traced benches of the port's library, written in torch and
lowered by ``repro_torch.front``, held against the JAX package's.

For every bench: the fabric's ``asm.emit`` digest is the one pinned in
``repro_torch.testing.TRACED_ASM_SHA256`` (``chip_smoke.py`` holds the
card's torch to the same digests); per-opcode node counts and the asm
text equal the JAX package's fabric; ``random_feeds`` draws the same
numbers from the same generator state; and both packages' oracles give
equal ``outputs``/``counts``/``cycles``/``fired``.  gcd and relu_chain
cannot be built by the JAX package's own builders under jax 0.9.0
(ROADMAP C3), so their JAX side is the same program written with
``lax.select``/``lax.max``/``lax.min`` and traced by ``repro.front``.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax import lax  # noqa: E402

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core.engine import run_reference as jrun_reference  # noqa: E402
from repro.front import trace as jtrace  # noqa: E402
from repro_torch.core import asm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.compile import compile_fn  # noqa: E402
from repro_torch.core.engine import (DataflowEngine,  # noqa: E402
                                     run_reference)
from repro_torch.testing import (TRACED_ASM_SHA256,  # noqa: E402
                                 asm_sha256, assert_same_result)

TRACED = sorted(tlib.TRACED)


def _jax_gcd() -> jlib.Bench:
    def gcd(a, b):
        def body(c):
            x, y = c
            return (lax.select(x > y, x - y, x),
                    lax.select(x > y, y, y - x))
        return lax.while_loop(lambda c: c[0] != c[1], body, (a, b))[0]

    prog = jtrace(gcd, np.int32, np.int32, name="gcd")
    return jlib.Bench(prog, lambda a, b: prog.make_feeds([int(a)], [int(b)]),
                      None, prog.out_arc, streaming=False)


def _jax_relu_chain() -> jlib.Bench:
    def relu_chain(x, y):
        h = lax.max(x - y, 0)
        h = lax.min(h * 2 + 1, 100)
        return lax.select(h > 50, h - 50, h)

    prog = jtrace(relu_chain, np.int32, np.int32, name="relu_chain")
    return jlib.Bench(prog, lambda x, y: prog.make_feeds(
        np.atleast_1d(np.asarray(x)), np.atleast_1d(np.asarray(y))),
        None, prog.out_arc)


# the JAX package's fabric of each bench (C3: two in their lax form)
JAX_BUILD = {"gcd": _jax_gcd, "relu_chain": _jax_relu_chain}
_CACHE: dict = {}


def _benches(name):
    if name not in _CACHE:
        _CACHE[name] = (tlib.BENCHES[name](),
                        JAX_BUILD.get(name, jlib.BENCHES[name])())
    return _CACHE[name]


def _op_counts(graph) -> dict:
    return dict(collections.Counter(n.op.name for n in graph.nodes))


def test_library_lists_the_jax_benches():
    assert list(tlib.BENCHES) == list(jlib.BENCHES)
    assert set(tlib.HAND_BUILT) | set(tlib.TRACED) == set(tlib.BENCHES)
    assert not set(tlib.HAND_BUILT) & set(tlib.TRACED)
    assert tlib.SINGLE_SHOT == jlib.SINGLE_SHOT
    assert set(TRACED_ASM_SHA256) == set(tlib.TRACED)
    for name in tlib.BENCHES:
        for k in (1, 7):
            assert tlib.tokens_out(name, k) == jlib.tokens_out(name, k)


@pytest.mark.parametrize("name", TRACED)
def test_traced_digest_is_pinned(name):
    """The capture of this torch builds the pinned fabric."""
    tb, _ = _benches(name)
    assert asm_sha256(tb.graph) == TRACED_ASM_SHA256[name]
    fn, avals, kw = tb.program
    run = compile_fn(fn, *avals, backend="reference", device="cpu", **kw)
    assert asm_sha256(run.traced) == TRACED_ASM_SHA256[name]


@pytest.mark.parametrize("name", TRACED)
def test_traced_bench_is_the_jax_fabric(name):
    tb, jb = _benches(name)
    assert _op_counts(tb.graph) == _op_counts(jb.graph)
    assert asm.emit(tb.graph) == jasm.emit(jb.graph)
    assert tb.graph.has_loops == jb.graph.has_loops
    assert tb.out_arc == jb.out_arc
    assert tb.streaming == jb.streaming
    assert np.dtype(tb.dtype) == np.dtype(jb.dtype)


@pytest.mark.parametrize("name", TRACED)
def test_random_feeds_and_runs_match_jax(name):
    """The same generator state draws the same feeds, and both oracles
    agree on every EngineResult field."""
    tb, jb = _benches(name)
    for seed, k in ((0, 1), (1, 5), (2, 12)):
        ft = tlib.random_feeds(name, tb, k, np.random.default_rng(seed))
        fj = jlib.random_feeds(name, jb, k, np.random.default_rng(seed))
        assert ft.keys() == fj.keys()
        for a in fj:
            np.testing.assert_array_equal(ft[a], fj[a])
            assert np.asarray(ft[a]).dtype == np.asarray(fj[a]).dtype
        want = jrun_reference(jb.graph, fj, dtype=jb.dtype)
        got = run_reference(tb.graph, ft, dtype=tb.dtype)
        assert_same_result(got, want, (name, seed), dispatches=False)
        assert got.counts[tb.out_arc] == tlib.tokens_out(name, k)


@pytest.mark.parametrize("name", TRACED)
def test_reference_matches_the_fabric(name):
    """Each bench's numpy reference is the value its fabric drains."""
    tb, _ = _benches(name)
    rng = np.random.default_rng(4)
    if name == "gcd":
        args = [(12, 18), (7, 7), (1024, 3)]
    elif name == "fib":
        args = [(0,), (9,), (40,)]
    elif name.startswith("newton_sqrt"):
        args = [(2.0,), (81.0,), (0.3,)]
    elif name.startswith("horner_loop"):
        args = [(x,) for x in (-4, 0, 3)]
    elif name.startswith("dot_prod"):
        args = [(rng.integers(0, 9, (3, 32)), rng.integers(0, 9, (3, 32)))]
    elif name.startswith("fir"):
        args = [(rng.integers(0, 99, (12,)),)]
    elif name.startswith(("saxpy", "relu_chain")):
        args = [(rng.integers(0, 99, (4,)), rng.integers(0, 99, (4,)))]
    else:
        args = [(rng.integers(0, 2 ** 16, (4,)),)]
    for a in args:
        res = run_reference(tb.graph, tb.make_feeds(*a), dtype=tb.dtype)
        want = np.atleast_1d(tb.reference(*a))
        got = np.asarray(res.outputs[tb.out_arc], tb.dtype)
        assert got.tobytes() == np.asarray(want[-1], tb.dtype).tobytes(), \
            (name, a)


@pytest.mark.parametrize("name", TRACED)
def test_port_engines_run_the_traced_benches(name):
    """The port's engines on the CPU (``"cuda"``: the fire block's plain
    version; ``"torch"`` for float32) equal the JAX oracle in every
    field, optimized and profiled too."""
    tb, jb = _benches(name)
    feeds = tlib.random_feeds(name, tb, 6, np.random.default_rng(9))
    want = jrun_reference(jb.graph, feeds, dtype=jb.dtype, profile=True)
    backend = "cuda" if np.dtype(tb.dtype) == np.int32 else "torch"
    for K, opt in ((1, False), (16, True)):
        eng = DataflowEngine(tb.graph, backend=backend, block_cycles=K,
                             device="cpu", optimize=opt, profile=True,
                             dtype=tb.dtype)
        got = eng.run(feeds)
        assert_same_result(got, want, (name, K, opt), dispatches=False)
        np.testing.assert_array_equal(got.node_fires, want.node_fires)


def test_traced_dot_prod_serves_as_the_hand_built_one():
    """dot_prod_traced behind DataflowServer.for_fn answers each request
    with the hand-built dot_prod's values and token counts."""
    from repro_torch.serve.dataflow_server import DataflowServer
    from repro_torch.serve.types import Request
    tb, hb = tlib.BENCHES["dot_prod_traced"](), tlib.BENCHES["dot_prod"]()
    fn, avals, kw = tb.program
    srv = DataflowServer.for_fn(fn, *avals, slots=3, block_cycles=8,
                                device="cpu", **kw)
    hsrv = DataflowServer(hb.graph, slots=3, block_cycles=8, device="cpu")
    rng_t, rng_h = np.random.default_rng(0), np.random.default_rng(0)
    for uid, k in enumerate((1, 9, 4, 17, 2), 1):
        srv.submit(Request(uid=uid, feeds=tlib.random_feeds(
            "dot_prod_traced", tb, k, rng_t)))
        hsrv.submit(Request(uid=uid, feeds=tlib.random_feeds(
            "dot_prod", hb, k, rng_h)))
    got = {r.uid: r for r in srv.drain()}
    want = {r.uid: r for r in hsrv.drain()}
    assert got.keys() == want.keys()
    for uid in got:
        g, w = got[uid].engine, want[uid].engine
        assert g.counts[srv.traced.out_arc] == w.counts["dot"]
        assert int(g.outputs[srv.traced.out_arc]) == int(w.outputs["dot"])
