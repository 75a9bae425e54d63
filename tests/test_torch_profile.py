"""Port vs JAX package: profiled blocks, the optimizing and profiling
engine, its slot API and server.

The profiled fire block carries five counters (node fires, stalls on
input and on output, arc busy cycles and high water).  Its plain
PyTorch version is held against the JAX package's profiled Pallas
kernel in interpret mode for a few cases and against its jnp mirror
(``repro.kernels.ref.fire_block_masked_prof_ref``) for the rest; the
port's ``DataflowEngine(optimize=, profile=, device="cpu")`` against the
JAX package's Pallas engine in every EngineResult and FabricProfile
field; the port's numpy oracle against the JAX package's.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro.core.engine import run_reference as j_run_reference  # noqa: E402
from repro.kernels import dataflow_fire as jdf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.engine import run_reference  # noqa: E402
from repro_torch.kernels import dataflow_fire as tdf  # noqa: E402
from repro_torch.obs import FabricProfile  # noqa: E402
from repro_torch.serve import dataflow_server  # noqa: E402
from repro_torch.serve.dataflow_server import DataflowServer  # noqa: E402
from repro_torch.serve.types import Request  # noqa: E402
from repro_torch.testing import (STATE_KEYS, assert_same_result,  # noqa: E402
                                 random_block_inputs, random_prof)

NAMES = sorted(tlib.HAND_BUILT)
BLOCK_OUT = (*STATE_KEYS, "fired", "last_prog", "nf", "si", "so", "ab",
             "ahw")


def _bench(lib, name):
    # bubble_sort at 6 keeps the JAX interpret-mode wall time sane
    return lib.bubble_sort_graph(6) if name == "bubble_sort" \
        else lib.BENCHES[name]()


# ---------------------------------------------------------------------------
# the profiled fire block
# ---------------------------------------------------------------------------
def _prof_inputs(name, K, optimize, B=3, L=6):
    jg, tg = _bench(jlib, name).graph, _bench(tlib, name).graph
    jt = jdf.block_plan_arrays(jg, optimize=optimize)
    tt = tdf.block_plan_arrays(tg, optimize=optimize)
    rng = np.random.default_rng(K + 10 * optimize)
    x = random_block_inputs(tt, B, L, rng)
    x["active"][:] = 1
    x["active"][1] = 0                          # one parked slot
    return jt, tt, x, random_prof(tt, B, rng)


def _block_args(x, b=None):
    keys = ("feed_vals", "feed_len", *STATE_KEYS)
    return [x[k] if b is None else x[k][b] for k in keys]


def _assert_block_equal(got, want):
    assert len(got) == len(want) == 12
    for k, g, w in zip(BLOCK_OUT, got, want):
        # fired/last_prog: [1] / [B, 1] here, () / [B] in the jnp mirror
        np.testing.assert_array_equal(g.numpy().reshape(np.shape(w)),
                                      np.asarray(w), err_msg=k)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("name,K", [("fibonacci", 1), ("fibonacci", 4),
                                    ("pop_count", 4)])
def test_prof_block_matches_pallas_interpret(name, K, optimize):
    jt, tt, x, prof = _prof_inputs(name, K, optimize)
    t = {k: torch.tensor(v) for k, v in x.items()}
    tprof = tuple(torch.tensor(p) for p in prof)
    want = jdf.fire_block_batched_pallas(
        jt, *(jnp.asarray(v) for v in _block_args(x)), n_cycles=K,
        active=jnp.asarray(x["active"]),
        prof=tuple(jnp.asarray(p) for p in prof), interpret=True)
    got = tdf.fire_block_batched_cuda(tt, *_block_args(t), n_cycles=K,
                                      active=t["active"], prof=tprof)
    _assert_block_equal(got, want)
    # the parked slot's counters passed through untouched
    for g, p in zip(got[7:], prof):
        np.testing.assert_array_equal(g[1].numpy(), p[1])
    want = jdf.fire_block_pallas(
        jt, *(jnp.asarray(v) for v in _block_args(x, 0)), n_cycles=K,
        prof=tuple(jnp.asarray(p[0]) for p in prof), interpret=True)
    got = tdf.fire_block_cuda(tt, *_block_args(t, 0), n_cycles=K,
                              prof=tuple(p[0] for p in tprof))
    _assert_block_equal(got, want)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", NAMES)
def test_prof_block_matches_jnp_ref(name, K, optimize):
    jt, tt, x, prof = _prof_inputs(name, K, optimize, B=4)
    t = {k: torch.tensor(v) for k, v in x.items()}
    step = jax.jit(jax.vmap(lambda *a: jref.fire_block_masked_prof_ref(
        jt, *a, n_cycles=K)))
    want = step(*(jnp.asarray(v) for v in _block_args(x)),
                jnp.asarray(x["active"]), *(jnp.asarray(p) for p in prof))
    got = tdf.fire_block_batched(tt, *_block_args(t), n_cycles=K,
                                 active=t["active"],
                                 prof=tuple(torch.tensor(p) for p in prof))
    _assert_block_equal(got, want)


# ---------------------------------------------------------------------------
# the oracle and the engine
# ---------------------------------------------------------------------------
def _feeds(name, B):
    """B streams of unequal length 1..4 (fibonacci: trip counts)."""
    bench = _bench(tlib, name)
    return [tlib.random_feeds(name, bench, 1 + b % 4,
                              np.random.default_rng(20 + b))
            for b in range(B)]


@pytest.mark.parametrize("name", NAMES)
def test_run_reference_profile_matches_jax(name):
    tg, jg = _bench(tlib, name).graph, _bench(jlib, name).graph
    for f in _feeds(name, 3):
        got = run_reference(tg, f, profile=True)
        got.profile.check()
        assert_same_result(got, j_run_reference(jg, f, profile=True), name,
                           dispatches=False, profile=True)


# (optimize, profile, K) per bench: both flags everywhere, each flag alone
# on three benches (each JAX engine compiles its interpret-mode kernels)
ENGINE_CASES = [(n, True, True, 4) for n in NAMES] + [
    (n, opt, prof, K) for n in ("fibonacci", "pop_count", "dot_prod")
    for opt, prof, K in ((True, False, 16), (False, True, 1))]


@functools.lru_cache(maxsize=None)
def _jax_runs(name, optimize, profile, K):
    """The JAX Pallas engine's solo run of stream 0 and batched run of
    four streams."""
    eng = JEngine(_bench(jlib, name).graph, backend="pallas",
                  block_cycles=K, optimize=optimize, profile=profile)
    feeds = _feeds(name, 4)
    return eng.run(feeds[0]), eng.run_batch(feeds)


@pytest.mark.parametrize("name,optimize,profile,K", ENGINE_CASES)
def test_engine_matches_jax(name, optimize, profile, K):
    bench = _bench(tlib, name)
    feeds = _feeds(name, 4)
    eng = DataflowEngine(bench.graph, block_cycles=K, device="cpu",
                         optimize=optimize, profile=profile)
    solo, batch = _jax_runs(name, optimize, profile, K)
    got = eng.run(feeds[0])
    assert_same_result(got, solo, (name, "run"), profile=profile)
    for b, (g, w) in enumerate(zip(eng.run_batch(feeds), batch)):
        assert_same_result(g, w, (name, "batch", b), profile=profile)
        if profile:
            g.profile.check()
            assert isinstance(g.profile, FabricProfile)
    if profile and K == 1:
        # one-cycle blocks simulate exactly the oracle's cycles
        assert_same_result(got, run_reference(bench.graph, feeds[0],
                                              profile=True),
                           name, dispatches=False, profile=True)


def test_reference_backend_profiles():
    bench = tlib.fibonacci_graph()
    f = bench.make_feeds(6)
    got = DataflowEngine(bench.graph, backend="reference", device="cpu",
                         profile=True).run(f)
    assert_same_result(got, run_reference(bench.graph, f, profile=True),
                       "ref", profile=True)


# ---------------------------------------------------------------------------
# the slot API with counters, and the server
# ---------------------------------------------------------------------------
SLOT_FIELDS = convert.DEVICE_FIELDS + convert.HOST_FIELDS + ("prof_cycles",)


def _slot_arrays(st):
    out = {k: np.asarray(getattr(st, k)) for k in SLOT_FIELDS}
    out["prof"] = tuple(np.asarray(x) for x in st.prof)
    return out


def _assert_same_state(got, want, tag):
    for k in SLOT_FIELDS:
        g = getattr(got, k)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(getattr(want, k))
        assert g.shape == w.shape, (tag, k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} {k}")
    for i, (g, w) in enumerate(zip(got.prof, want.prof, strict=True)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{tag} prof[{i}]")


def test_slot_api_with_counters_matches_jax():
    """Admit, step, harvest and re-admit on both packages' optimized,
    profiled engines; a mid-flight JAX state carried into the port steps
    the same."""
    jb, tb = jlib.fibonacci_graph(), tlib.fibonacci_graph()
    jeng = JEngine(jb.graph, backend="pallas", block_cycles=4,
                   optimize=True, profile=True)
    eng = DataflowEngine(tb.graph, block_cycles=4, device="cpu",
                         optimize=True, profile=True)
    jst, tst = jeng.init_state(4), eng.init_state(4)
    _assert_same_state(tst, jst, "init")
    feeds = [jb.make_feeds(n) for n in (3, 9, 5)]
    jst = jeng.reset_slots(jst, [0, 1, 3], feeds, caps=[None, 30, None])
    tst = eng.reset_slots(tst, [0, 1, 3], feeds, caps=[None, 30, None])
    _assert_same_state(tst, jst, "admitted")
    for step in range(8):
        jst, tst = jeng.step_block(jst), eng.step_block(tst)
        _assert_same_state(tst, jst, ("step", step))
    carried = convert.slot_state_from_numpy(_slot_arrays(jst), device="cpu")
    _assert_same_state(carried, jst, "carried")
    done = jst.quiesced_slots()
    assert done == tst.quiesced_slots() and done
    jst, jres = jeng.harvest(jst, done)
    tst, tres = eng.harvest(tst, done)
    for g, w in zip(tres, jres, strict=True):
        assert_same_result(g, w, "harvest", profile=True)
        g.profile.check()
    jst = jeng.reset_slots(jst, done[:1], [jb.make_feeds(12)])
    tst = eng.reset_slots(tst, done[:1], [jb.make_feeds(12)])
    _assert_same_state(tst, jst, "re-admitted")
    jst, tst = jeng.step_block(jst), eng.step_block(tst)
    _assert_same_state(tst, jst, "stepped")


@pytest.mark.parametrize("name", ["fibonacci", "dot_prod"])
def test_profiled_optimized_server_matches_solo_runs(name):
    bench = tlib.BENCHES[name]()
    reqs = [Request(uid=i + 1, feeds=tlib.random_feeds(
        name, bench, 2 + (5 * i) % 9, np.random.default_rng(i)),
        max_cycles=6 if i == 4 else None) for i in range(10)]
    srv = DataflowServer(bench.graph, slots=3, block_cycles=4, device="cpu",
                         optimize=True, profile=True)
    assert srv.engine.optimize and srv.engine.profile
    got = srv.run(reqs)
    assert [r.uid for r in got] == list(range(1, 11))
    assert {r.status for r in got} == {"ok", "truncated"}
    solo = DataflowEngine(bench.graph, block_cycles=4, device="cpu",
                          optimize=True, profile=True)
    same_window = 0
    for r, req in zip(got, reqs):
        want = solo.run(req.feeds, max_cycles=req.max_cycles)
        assert isinstance(r.engine.profile, FabricProfile)
        r.engine.profile.check()
        # a served request rides more, shorter blocks when a neighbour's
        # budget shortens a heartbeat, so its profiled window (idle tail
        # cycles) may differ; every other field agrees
        assert_same_result(r.engine, want, r.uid, dispatches=False)
        np.testing.assert_array_equal(r.engine.node_fires, want.node_fires)
        if r.engine.profile.cycles == want.profile.cycles:
            assert_same_result(r.engine, want, r.uid, dispatches=False,
                               profile=True)
            same_window += 1
    assert same_window >= len(reqs) // 2, same_window


def test_engine_cache_keys_on_optimize_and_profile():
    """A profiled and an unprofiled server (or an optimized and a dense
    one) for the same fabric never share an engine."""
    dataflow_server.clear_engine_cache()
    g = tlib.fibonacci_graph().graph
    engines = {(o, p): DataflowServer(g, slots=2, device="cpu", optimize=o,
                                      profile=p).engine
               for o in (False, True) for p in (False, True)}
    assert len({id(e) for e in engines.values()}) == 4
    for (o, p), e in engines.items():
        assert (e.optimize, e.profile) == (o, p)
        assert e is dataflow_server.cached_engine(
            g, block_cycles=16, device="cpu", optimize=o, profile=p)
    srv = DataflowServer(g, slots=2, device="cpu", profile=True)
    srv.submit(tlib.fibonacci_graph().make_feeds(4))
    r, = srv.drain()
    assert r.engine.profile is not None
    srv = DataflowServer(g, slots=2, device="cpu")
    srv.submit(tlib.fibonacci_graph().make_feeds(4))
    r, = srv.drain()
    assert r.engine.profile is None and r.engine.node_fires is None


def test_asm_carries_optimized_tables():
    """A fabric sent across as asm text gets the JAX package's
    optimized, profiled tables in the port (node_inv included)."""
    jg = jlib.fibonacci_graph().graph
    tg = convert.graph_from_asm(jasm.emit(jg))
    jp = JEngine(jg, backend="pallas", optimize=True).p
    tp = DataflowEngine(tg, device="cpu", optimize=True).p
    for k in ("node_perm", "node_inv", "arc_perm", "arc_inv", "opcode"):
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert dataclasses.is_dataclass(FabricProfile)
