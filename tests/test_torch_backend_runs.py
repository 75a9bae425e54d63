"""Port vs JAX package: ``DataflowEngine(backend="torch")`` on the 7
benches.

Every bench at K in {1, 4, 16}, with ``optimize`` and ``profile`` on and
off, ``run`` and ``run_batch`` of B = 1 and 8 streams of unequal length,
against the JAX package's ``"xla"`` engine in every EngineResult field
(the profile included: at K > 1 its counters cover the idle tail of the
last block, as on ``"xla"``) and against ``run_reference``.  A batched
stream is frozen from the block its own loop condition fails, as under
``vmap``, so each batched result equals that stream's solo run.
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
KS = [1, 4, 16]


def _bench(lib, name):
    # bubble_sort at 6 keeps the JAX compile times sane
    return lib.bubble_sort_graph(6) if name == "bubble_sort" \
        else lib.BENCHES[name]()


def _feeds(name, B):
    """B streams of unequal length 1..4 (fibonacci: trip counts)."""
    bench = _bench(tlib, name)
    return [tlib.random_feeds(name, bench, 1 + b % 4,
                              np.random.default_rng(10 + b))
            for b in range(B)]


@functools.lru_cache(maxsize=None)
def _xla_runs(name, K):
    """The JAX "xla" engine's (profiled) solo run of stream 0 and batched
    run of 8 streams.  Neither optimize nor profile changes a field of an
    "xla" result, so one engine per bench and K serves every flag."""
    eng = JEngine(_bench(jlib, name).graph, backend="xla", block_cycles=K,
                  profile=True)
    feeds = _feeds(name, 8)
    return eng.run(feeds[0]), eng.run_batch(feeds)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("optimize", [False, True], ids=["dense", "opt"])
@pytest.mark.parametrize("profile", [False, True], ids=["noprof", "prof"])
def test_run_and_batch_match_xla(name, K, optimize, profile):
    bench = _bench(tlib, name)
    feeds = _feeds(name, 8)
    solo, batch = _xla_runs(name, K)
    eng = DataflowEngine(bench.graph, backend="torch", block_cycles=K,
                         device="cpu", optimize=optimize, profile=profile)
    got = eng.run(feeds[0])
    assert_same_result(got, solo, (name, K), profile=profile)
    assert_same_result(got, run_reference(bench.graph, feeds[0],
                                          profile=True),
                       (name, K, "ref"), dispatches=False)
    if not profile:
        assert got.profile is None and got.node_fires is None
    for B, wants in ((1, [solo]), (8, batch)):
        res = eng.run_batch(feeds[:B])
        assert len(res) == B
        for b, (g, w) in enumerate(zip(res, wants)):
            assert_same_result(g, w, (name, K, B, b), profile=profile)
