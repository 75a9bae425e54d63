"""Port vs JAX package: the ``"torch"`` backend on random fabrics in
uint32 and float32.

16 random fabrics a dtype (control operators included; the port's
``testing.random_graph``, crossing as asm text), fed edge operands of the
dtype, run dense and optimized, profiled, solo and batched, with a cycle
cap: bit for bit against ``run_reference`` in every field, and against
the JAX package's ``"xla"`` engine in every field on the first 6 seeds.
Float shift counts are integral const buses in [-149, 126]
(``testing.FLOAT_SHIFTS``), where the port's exp2 and numpy's agree; XLA's
does not at |b| >= 13 (ROADMAP C8), so a float fabric with a shift is held
to ``run_reference`` alone.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.engine import run_reference  # noqa: E402
from repro_torch.core.graph import Op  # noqa: E402
from repro_torch.testing import (assert_same_result,  # noqa: E402
                                 edge_feeds, random_graph)

SEEDS = range(16)
XLA_SEEDS = range(6)
CAP = 96
K = 3


def _feeds(g, dt, seed):
    rng = np.random.default_rng(100 + seed)
    return [edge_feeds(g, dt, 1 + (s + seed) % 5, rng) for s in range(4)]


@functools.lru_cache(maxsize=None)
def _xla_runs(seed, dtype):
    g = random_graph(seed, dtype=dtype)
    jg = jasm.parse(tasm.emit(g), name=g.name)
    eng = JEngine(jg, dtype=dtype, backend="xla", block_cycles=K,
                  max_cycles=CAP, profile=True)
    feeds = _feeds(g, dtype, seed)
    return eng.run(feeds[0]), eng.run_batch(feeds)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["uint32", "float32"])
def test_random_fabrics_in_dtype(seed, dtype):
    dt = np.dtype(dtype)
    g = random_graph(seed, dtype=dt)
    feeds = _feeds(g, dt, seed)
    refs = [run_reference(g, f, dtype=dt, max_cycles=CAP, profile=True)
            for f in feeds]
    shifts = any(n.op in (Op.SHL, Op.SHR) for n in g.nodes)
    xla = seed in XLA_SEEDS and not (dtype == "float32" and shifts)
    for opt in (False, True):
        eng = DataflowEngine(g, backend="torch", block_cycles=K,
                             max_cycles=CAP, device="cpu", optimize=opt,
                             profile=True, dtype=dt)
        got = [eng.run(feeds[0])] + eng.run_batch(feeds)
        for g_, r in zip(got, refs[:1] + refs):
            assert_same_result(g_, r, (g.name, dtype, opt), dispatches=False)
            np.testing.assert_array_equal(g_.node_fires, r.node_fires)
            g_.profile.check()
        if xla:
            solo, batch = _xla_runs(seed, dtype)
            for g_, w in zip(got, [solo] + batch):
                assert_same_result(g_, w, (g.name, dtype, opt, "xla"),
                                   profile=True)
