"""The partitioned engine over the whole matrix: 7 benches x P in {2, 4}
x K in {1, 4, 16} x ``optimize`` x ``profile``, single and batched runs,
on ``"cuda"`` (``device="cpu"``: the kernel's plain version) and
``"torch"``, against the port's solo ``"cuda"`` engine in every
``EngineResult`` field but the channel counters (which the solo engine
has not: they are held to their bounds and to their producers' firings);
the solo engine equals the JAX package's (``tests/test_torch_engine.py``),
and ``tests/test_torch_multifabric.py`` holds one case of each (bench, P)
against the JAX partitioned engine itself.  The ``"torch"`` backend also
runs uint32 and float32 random fabrics, against ``run_reference`` and,
where XLA's exp2 is numpy's (fabrics without float shifts, ROADMAP C8),
against the JAX partitioned engine in the same dtype.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import (DataflowEngine,  # noqa: E402
                                     run_reference)
from repro_torch.core.graph import Op  # noqa: E402
from repro_torch.testing import (assert_same_result,  # noqa: E402
                                 check_channels,
                                 edge_feeds, random_graph)

NAMES = sorted(tlib.HAND_BUILT)
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _bench(name):
    return tlib.bubble_sort_graph(6) if name == "bubble_sort" \
        else tlib.BENCHES[name]()


def _jax_graph(tg):
    return jasm.parse(tasm.emit(tg), name=tg.name)


def _feeds(name, bench, seed, lens=(3, 1, 5)):
    rng = np.random.default_rng(seed)
    return [tlib.random_feeds(name, bench, k, rng) for k in lens]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_partitioned_matrix_equals_solo(name, P):
    bench = _bench(name)
    feeds = _feeds(name, bench, 40 + P)
    for K in (1, 4, 16):
        for opt, prof in FLAGS:
            solo = DataflowEngine(bench.graph, block_cycles=K, device="cpu",
                                  optimize=opt, profile=prof)
            want = [solo.run(feeds[0])] + solo.run_batch(feeds)
            for backend in ("cuda", "torch"):
                eng = DataflowEngine(bench.graph, backend=backend,
                                     block_cycles=K, device="cpu",
                                     partition=P, optimize=opt,
                                     profile=prof)
                got = [eng.run(feeds[0])] + eng.run_batch(feeds)
                for k, (g, w) in enumerate(zip(got, want)):
                    tag = (name, P, K, opt, prof, backend, k)
                    assert_same_result(g, w, tag, profile=prof,
                                       channels=False)
                    if prof:
                        check_channels(g, bench.graph)


@functools.lru_cache(maxsize=None)
def _dtype_case(seed, dtype):
    g = random_graph(seed, dtype=dtype)
    rng = np.random.default_rng(300 + seed)
    return g, [edge_feeds(g, dtype, 1 + (s + seed) % 4, rng)
               for s in range(3)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dtype", ["uint32", "float32"])
def test_torch_backend_dtypes(dtype, seed):
    dt = np.dtype(dtype)
    g, feeds = _dtype_case(seed, dtype)
    shifts = any(n.op in (Op.SHL, Op.SHR) for n in g.nodes)
    for P in (2, 3):
        try:
            eng = DataflowEngine(g, backend="torch", block_cycles=3,
                                 max_cycles=96, device="cpu", partition=P,
                                 profile=True, dtype=dt)
        except ValueError as e:        # fewer SCC supernodes than P
            assert "loop cycles" in str(e)
            continue
        got = eng.run_batch(feeds)
        for g_, f in zip(got, feeds):
            ref = run_reference(g, f, dtype=dt, max_cycles=96, profile=True)
            assert_same_result(g_, ref, (g.name, dtype, P), dispatches=False)
            np.testing.assert_array_equal(g_.node_fires, ref.node_fires)
            g_.profile.check()
        if seed < 3 and P == 2 and not (dtype == "float32" and shifts):
            jeng = JEngine(_jax_graph(g), dtype=dt, backend="xla",
                           block_cycles=3, max_cycles=96, partition=P,
                           profile=True)
            for k, (g_, w) in enumerate(zip(got, jeng.run_batch(feeds))):
                assert_same_result(g_, w, (g.name, dtype, P, k),
                                   profile=True)


