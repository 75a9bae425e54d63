"""Port vs JAX package: the one-cycle fire step and ``run_fabric``.

``fire_step`` is one fire of every ready node with no environment (the
per-cycle baseline ``fire_step_pallas``); ``run_fabric`` drives a fabric
to completion with one fire step per cycle and the feed and drain on the
host.  The same inputs, made with numpy from a seed, go through the JAX
function (the Pallas kernel in interpret mode) and the port's plain
PyTorch version; every result must match bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core.engine import run_reference as j_run_reference  # noqa: E402
from repro.kernels import dataflow_fire as jdf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import run_reference  # noqa: E402
from repro_torch.kernels import dataflow_fire as tdf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.testing import (assert_same_result,  # noqa: E402
                                 random_block_inputs, random_graph)

NAMES = sorted(tlib.HAND_BUILT)


def _jax_tables(jg):
    """The JAX package's fire-step tables as jnp arrays."""
    return {k: jnp.asarray(v) for k, v in jdf.plan_arrays(jg).items()
            if k not in ("plan", "class_slices")}


def _step_both(jt, tt, full, val):
    want = jdf.fire_step_pallas(jt, jnp.asarray(full), jnp.asarray(val),
                                interpret=True)
    got = tdf.fire_step_cuda(tdf.device_tables(tt, "cpu"),
                             torch.tensor(full), torch.tensor(val))
    plain = tdf.fire_step(tt, torch.tensor(full), torch.tensor(val))
    for k, g, p, w in zip(("full", "val", "fired"), got, plain, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
        assert torch.equal(g, p), k


@pytest.mark.parametrize("name", NAMES)
def test_fire_step_matches_pallas_interpret(name):
    """Random register states (edge operands among them) over a bench's
    tables."""
    jg, tg = jlib.BENCHES[name]().graph, tlib.BENCHES[name]().graph
    jt = _jax_tables(jg)
    tt = tdf.block_plan_arrays(tg)
    x = random_block_inputs(tt, 3, 1, np.random.default_rng(len(name)))
    for b in range(3):
        _step_both(jt, tt, x["full"][b], x["val"][b])


@pytest.mark.parametrize("seed", range(6))
def test_fire_step_random_graphs(seed):
    tg = random_graph(seed)
    jg = jasm.parse(tasm.emit(tg), name=tg.name)
    jt = _jax_tables(jg)
    tt = tdf.block_plan_arrays(tg)
    x = random_block_inputs(tt, 2, 1, np.random.default_rng(seed))
    for b in range(2):
        _step_both(jt, tt, x["full"][b], x["val"][b])


def test_fire_step_counts_no_launch_on_cpu():
    tables, step = tops.make_fire_step(tlib.fibonacci_graph().graph,
                                       device="cpu")
    n0 = tdf.fire_step_cuda.launches
    A2 = tables["plan"]["A"] + 2
    full = torch.zeros(A2, dtype=torch.int32)
    out = step(full, torch.zeros_like(full))
    assert [tuple(o.shape) for o in out] == [(A2,), (A2,), (1,)]
    assert tdf.fire_step_cuda.launches == n0


def _stream_feeds(name, k, seed):
    return tlib.random_feeds(name, tlib.BENCHES[name](), k,
                             np.random.default_rng(seed))


@pytest.mark.parametrize("name", NAMES)
def test_run_fabric_matches_jax(name):
    """The seven hand benches carry no initial tokens, so the JAX
    package's ``run_fabric`` (which seeds none) is their reference."""
    jg, tg = jlib.BENCHES[name]().graph, tlib.BENCHES[name]().graph
    assert not tg.inits
    jc = jops.make_fire_step(jg)
    for seed, k in enumerate((1, 3)):
        feeds = _stream_feeds(name, k, seed)
        want = jops.run_fabric(jg, feeds, compiled=jc)
        got = tops.run_fabric(tg, feeds, device="cpu")
        assert_same_result(got, want, (name, k))
        assert got.dispatches == got.cycles
        assert_same_result(got, run_reference(tg, feeds), (name, k),
                           dispatches=False)


@pytest.mark.parametrize("name,arg", [("fib", 9), ("horner_loop", 3)])
def test_run_fabric_seeds_initial_tokens(name, arg):
    """Loop fabrics start from initial tokens (``graph.inits``).  The JAX
    package's ``run_fabric`` seeds none and stalls at once on these two
    (ROADMAP C4), so the port's is held against the JAX package's
    ``run_reference`` instead, on the same fabric sent across as asm."""
    jb = jlib.BENCHES[name]()
    tg = convert.graph_from_asm(jasm.emit(jb.graph), name=name)
    assert tg.inits
    feeds = jb.make_feeds(arg)
    want = j_run_reference(jb.graph, feeds)
    got = tops.run_fabric(tg, feeds, device="cpu")
    assert_same_result(got, want, name, dispatches=False)
    assert got.dispatches == got.cycles
    out = jb.out_arc
    assert got.counts[out] == 1
    assert int(got.outputs[out]) == int(jb.reference(arg))
    # the fault this guards against: JAX's run_fabric drains nothing
    assert jops.run_fabric(jb.graph, feeds).counts[out] == 0


def test_run_fabric_cap():
    """max_cycles stops the loop at exactly that many cycles."""
    tg = tlib.fibonacci_graph()
    got = tops.run_fabric(tg.graph, tg.make_feeds(40), max_cycles=17,
                          device="cpu")
    want = run_reference(tg.graph, tg.make_feeds(40), max_cycles=17)
    assert got.cycles == 17
    assert_same_result(got, want, "cap", dispatches=False)
