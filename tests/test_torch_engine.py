"""Port vs JAX package: ``DataflowEngine.run`` and ``run_batch``.

The port's engine runs its ``"cuda"`` backend with ``device="cpu"`` —
the same host block loop, over the kernel's plain PyTorch version.  It
is held against the JAX package's Pallas engine (interpret mode) in
every EngineResult field, dispatches included, and against the JAX
package's numpy oracle ``run_reference``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import library as jlib  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro.core.engine import run_reference as j_run_reference  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.engine import run_reference  # noqa: E402
from repro_torch.testing import assert_same_result  # noqa: E402

KS = [1, 4, 16]
NAMES = sorted(tlib.HAND_BUILT)


def _bench(lib, name):
    # bubble_sort at 6 keeps the JAX interpret-mode wall time sane
    return lib.bubble_sort_graph(6) if name == "bubble_sort" \
        else lib.BENCHES[name]()


def _feeds(name, B):
    """B streams of unequal length 1..4 (fibonacci: trip counts)."""
    bench = _bench(tlib, name)
    return [tlib.random_feeds(name, bench, 1 + b % 4,
                              np.random.default_rng(10 + b))
            for b in range(B)]


@functools.lru_cache(maxsize=None)
def _jax_runs(name, K):
    """The JAX Pallas engine's solo run of stream 0 and its batched run of
    all 8 streams (one engine per bench and K, shared by the
    parametrizations; each distinct stream length would retrace)."""
    eng = JEngine(_bench(jlib, name).graph, backend="pallas", block_cycles=K)
    feeds = _feeds(name, 8)
    return eng.run(feeds[0]), eng.run_batch(feeds)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("K", KS)
def test_run_matches_jax(name, K):
    bench = _bench(tlib, name)
    f = _feeds(name, 1)[0]
    got = DataflowEngine(bench.graph, block_cycles=K, device="cpu").run(f)
    assert_same_result(got, _jax_runs(name, K)[0], (name, K))
    assert_same_result(got, run_reference(bench.graph, f), (name, K),
                       dispatches=False)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("B", [1, 8])
def test_run_batch_matches_jax(name, K, B):
    """Streams of unequal length in one batch; B = 1 rides exactly the
    blocks of the solo run."""
    bench = _bench(tlib, name)
    feeds = _feeds(name, B)
    solo, batch = _jax_runs(name, K)
    got = DataflowEngine(bench.graph, block_cycles=K,
                         device="cpu").run_batch(feeds)
    assert len(got) == B
    for b, (g, w) in enumerate(zip(got, [solo] if B == 1 else batch)):
        assert_same_result(g, w, (name, K, B, b))
        assert_same_result(g, j_run_reference(_bench(jlib, name).graph,
                                              feeds[b]),
                           (name, K, B, b), dispatches=False)


@pytest.mark.parametrize("max_cycles", [41])
def test_max_cycles_truncation_mid_block(max_cycles):
    """A cap that is not a multiple of K shortens the last block; the
    truncated run still matches the JAX engine in every field."""
    jb, tb = jlib.fibonacci_graph(), tlib.fibonacci_graph()
    feeds = [tb.make_feeds(n) for n in (20, 2, 30)]
    jeng = JEngine(jb.graph, backend="pallas", block_cycles=16)
    eng = DataflowEngine(tb.graph, block_cycles=16, device="cpu")
    want = jeng.run(feeds[0], max_cycles=max_cycles)
    got = eng.run(feeds[0], max_cycles=max_cycles)
    assert want.cycles == max_cycles            # it really truncated
    assert_same_result(got, want, max_cycles)
    for f in feeds:
        assert_same_result(eng.run(f, max_cycles=max_cycles),
                           run_reference(tb.graph, f, max_cycles=max_cycles),
                           max_cycles, dispatches=False)
    for g, w in zip(eng.run_batch(feeds, max_cycles=max_cycles),
                    jeng.run_batch(feeds, max_cycles=max_cycles)):
        assert_same_result(g, w, ("batch", max_cycles))


def test_reference_backend_matches_jax_reference():
    tb, jb = tlib.popcount_graph(), jlib.popcount_graph()
    f = tlib.random_feeds("pop_count", tb, 6, np.random.default_rng(3))
    eng = DataflowEngine(tb.graph, backend="reference", device="cpu")
    assert_same_result(eng.run(f), j_run_reference(jb.graph, f), "ref",
                       dispatches=False)
    with pytest.raises(ValueError, match="slot API"):
        eng.init_state(2)
