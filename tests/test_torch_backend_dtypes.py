"""Port vs JAX package: the ``"torch"`` backend in uint32 and float32 and
on tensor tokens.

The 7 benches run in uint32 and float32 (K = 4, ``optimize`` on and off,
profiled, ``run`` and ``run_batch``), and on tokens of shape (4,) with a
different value in each lane, against the JAX package's ``"xla"`` engine
in every EngineResult field and against ``run_reference``.  pop_count in
float32 shifts by up to 15, where XLA's exp2 is not numpy's (ROADMAP
C8): there the port is held to ``run_reference`` alone, bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import library as jlib  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.engine import run_reference  # noqa: E402
from repro_torch.testing import assert_same_result  # noqa: E402

NAMES = sorted(tlib.HAND_BUILT)
K = 4
LANES = 4
# (dtype, bench) pairs with a float shift count of 13 or more (C8)
C8 = {("float32", "pop_count")}


def _bench(lib, name):
    return lib.bubble_sort_graph(6) if name == "bubble_sort" \
        else lib.BENCHES[name]()


def _feeds(name, B, lanes=0):
    """B streams of unequal length; with ``lanes``, tokens of shape
    (lanes,): lane j adds j to the scalar stream (so lane 0, the one
    control operators read, keeps the scalar stream's control flow)."""
    bench = _bench(tlib, name)
    feeds = [tlib.random_feeds(name, bench, 1 + b % 4,
                               np.random.default_rng(20 + b))
             for b in range(B)]
    if lanes:
        feeds = [{a: np.asarray(v)[:, None] + np.arange(lanes)
                  for a, v in f.items()} for f in feeds]
    return feeds


@functools.lru_cache(maxsize=None)
def _xla_runs(name, dtype, lanes):
    ts = (lanes,) if lanes else ()
    eng = JEngine(_bench(jlib, name).graph, token_shape=ts, dtype=dtype,
                  backend="xla", block_cycles=K, profile=True)
    feeds = _feeds(name, 4, lanes)
    return eng.run(feeds[0]), eng.run_batch(feeds)


def _check(name, dtype, lanes, optimize):
    dt = np.dtype(dtype)
    ts = (lanes,) if lanes else ()
    bench = _bench(tlib, name)
    feeds = _feeds(name, 4, lanes)
    eng = DataflowEngine(bench.graph, backend="torch", block_cycles=K,
                         device="cpu", optimize=optimize, profile=True,
                         token_shape=ts, dtype=dt)
    got = [eng.run(feeds[0])] + eng.run_batch(feeds)
    refs = [run_reference(bench.graph, f, ts, dt, profile=True)
            for f in feeds]
    for g, r in zip(got, refs[:1] + refs):
        assert_same_result(g, r, (name, dt.name, ts, "ref"),
                           dispatches=False)
        np.testing.assert_array_equal(g.node_fires, r.node_fires)
        assert g.outputs[next(iter(g.outputs))].dtype == dt
    if (dt.name, name) in C8:
        return
    solo, batch = _xla_runs(name, dt.name, lanes)
    for g, w in zip(got, [solo] + batch):
        assert_same_result(g, w, (name, dt.name, ts), profile=True)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["uint32", "float32"])
@pytest.mark.parametrize("optimize", [False, True], ids=["dense", "opt"])
def test_benches_in_dtype_match_xla(name, dtype, optimize):
    _check(name, dtype, 0, optimize)


@pytest.mark.parametrize("name,dtype", [
    ("fibonacci", "int32"), ("bubble_sort", "int32"), ("pop_count", "int32"),
    ("dot_prod", "float32"), ("max_vector", "float32"),
    ("pop_count", "float32")])
@pytest.mark.parametrize("optimize", [False, True], ids=["dense", "opt"])
def test_tensor_token_benches_match_xla(name, dtype, optimize):
    _check(name, dtype, LANES, optimize)
