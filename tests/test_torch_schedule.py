"""Port vs JAX package: static firing schedules.

Both packages run literally the same fabric (the JAX package's optimized
graph, crossing as asm text) through the same sequence of schedule
calls.  Every comparison here is exact: the pattern registries field by
field, the concrete plans' segments, the per-pattern tables array by
array, the kernels' plain PyTorch versions against the JAX package's
scheduled programs (Pallas in interpret mode for a few cases, the xla
lowering for the rest), the port's scheduled engine against the JAX
package's scheduled engine and ``run_reference`` in every EngineResult
field (profile included), the scheduled slot API against the dynamic one
at every block boundary, a JAX scheduled slot state resumed in the port,
and the scheduled server against solo runs.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core import passes as jpasses  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro.core.engine import run_reference as j_run_reference  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.engine import run_reference  # noqa: E402
from repro_torch.core.graph import Graph, Op  # noqa: E402
from repro_torch.kernels import schedule_fire as ksf  # noqa: E402
from repro_torch.serve import dataflow_server  # noqa: E402
from repro_torch.serve.dataflow_server import DataflowServer  # noqa: E402
from repro_torch.testing import (STATE_KEYS,  # noqa: E402
                                 assert_same_result, edge_ints)

CAP = 4096
RUN_BENCHES = ("fir", "dot_prod", "bubble_sort", "horner")
PATTERN_FIELDS = ("pid", "fed", "fed_arcs", "fire", "drain", "drain_arcs",
                  "busy", "full_after", "n_fires", "n_drains", "nf_inc",
                  "si_inc", "so_inc", "ab_inc", "ahw_inc")
SLOT_FIELDS = (*convert.DEVICE_FIELDS, *convert.HOST_FIELDS)


@functools.lru_cache(maxsize=None)
def _fabric(name):
    """(JAX bench, JAX optimized graph, the port's copy of that graph).
    bubble_sort at 6 keeps the JAX compile times sane; horner comes from
    the JAX package's frontend."""
    if name == "horner":
        try:
            jb = jlib.horner_graph()
        except Exception as e:          # ROADMAP C3: the reference's own
            pytest.skip(f"the JAX frontend cannot build horner ({e!r}; "
                        "ROADMAP C3)")
    else:
        jb = jlib.bubble_sort_graph(6) if name == "bubble_sort" \
            else jlib.BENCHES[name]()
    jg, _ = jpasses.optimize_graph(jb.graph)
    return jb, jg, convert.graph_from_asm(jasm.emit(jg), name=jg.name)


def _feeds(name, k, seed):
    return jlib.random_feeds(name, _fabric(name)[0], k,
                             np.random.default_rng(seed))


def _engines(name, optimize=False, backend="xla", **kw):
    """The JAX package's scheduled engine on ``backend`` and the port's
    (its ``"cuda"`` backend on the CPU, or its numpy ``"reference"``)."""
    _, jg, tg = _fabric(name)
    return (JEngine(jg, backend=backend, optimize=optimize, schedule=True,
                    **kw),
            DataflowEngine(tg, device="cpu", optimize=optimize,
                           schedule=True,
                           backend="reference" if backend == "reference"
                           else "cuda", **kw))


def _same_pattern(a, b, tag):
    for f in PATTERN_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{tag} {f}")
    assert len(a.bundles) == len(b.bundles), tag
    for x, y in zip(a.bundles, b.bundles):
        assert int(x[0]) == int(y[0]), tag
        for u, v in zip(x[1:], y[1:]):
            np.testing.assert_array_equal(u, v, err_msg=str(tag))


def _same_contexts(jctx, tctx, tag):
    assert len(jctx.registry) == len(tctx.registry), tag
    for a, b in zip(jctx.registry, tctx.registry):
        _same_pattern(a, b, (tag, a.pid))
    for x, y in zip(jctx.slot_tables(), tctx.slot_tables()):
        np.testing.assert_array_equal(np.asarray(x), y, err_msg=str(tag))
    np.testing.assert_array_equal(np.asarray(jctx.state0_val()),
                                  tctx.state0_val())


# ---------------------------------------------------------------------------
# the schedulability gate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(tlib.HAND_BUILT))
def test_schedule_blockers_match_jax(name):
    jg = jlib.BENCHES[name]().graph
    tg = tlib.BENCHES[name]().graph
    assert tsched.schedule_blockers(tg) == jsched.schedule_blockers(jg)
    if not tsched.schedulable(tg):
        with pytest.raises(ValueError) as want:
            JEngine(jg, schedule=True)
        with pytest.raises(ValueError) as got:
            DataflowEngine(tg, schedule=True, device="cpu")
        assert str(got.value) == str(want.value)
        assert not DataflowEngine(tg, schedule="auto",
                                  device="cpu")._sched_on
    with pytest.raises(ValueError, match="schedule must be"):
        DataflowEngine(tg, schedule="yes", device="cpu")


# ---------------------------------------------------------------------------
# plans and tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", RUN_BENCHES)
@pytest.mark.parametrize("optimize", [False, True])
def test_plans_and_tables_match_jax(name, optimize):
    """One call sequence — plans for several feed-length tuples, some
    clipped by a cap, some extended to quiescence — builds the same
    registry, segments and tables in both packages."""
    jeng, teng = _engines(name, optimize, backend="reference")
    jctx, tctx = jeng._sched_ctx(), teng._sched_ctx()
    n_in = len(teng.p["input_arcs"])
    flens = [(5,) * n_in, (17,) * n_in, (2,) * n_in,
             tuple(3 + (i % 4) for i in range(n_in)), (17,) * n_in]
    for i, flen in enumerate(flens):
        for upto in (7, 40 + 11 * i, CAP):
            jp, tp = jctx.plan_for(flen), tctx.plan_for(flen)
            jp.ensure(upto)
            tp.ensure(upto)
            assert (tp.segments, tp.total, tp.quiesced, tp.idle_pid) == \
                (jp.segments, jp.total, jp.quiesced, jp.idle_pid), \
                (name, flen, upto)
            hi = min(upto, tp.total)
            for lo in (0, hi // 3):
                np.testing.assert_array_equal(tp.pids_window(lo, hi),
                                              jp.pids_window(lo, hi))
                assert tp.counts_between(lo, hi) == jp.counts_between(lo, hi)
            js, jr = jp.trace_struct(min(upto, jp.total))
            ts, tr = tp.trace_struct(min(upto, tp.total))
            assert ts == js
            np.testing.assert_array_equal(tr, jr)
    _same_contexts(jctx, tctx, (name, optimize))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX package's scheduled programs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,backend",
                         [("fir", "pallas"), ("dot_prod", "xla"),
                          ("bubble_sort", "xla")])
def test_sched_run_matches_jax_program(name, backend):
    """sched_run on the port's tables and program equals the JAX
    package's straight-line scheduled program (batched, B = 3) on int32
    edge operands, at the full run and at a clip."""
    jeng, teng = _engines(name, optimize=True, backend="reference")
    jctx, tctx = jeng._sched_ctx(), teng._sched_ctx()
    n_in = len(teng.p["input_arcs"])
    flen = (9,) * n_in
    jp, tp = jctx.plan_for(flen), tctx.plan_for(flen)
    jp.ensure(CAP)
    tp.ensure(CAP)
    fv = edge_ints(np.random.default_rng(len(name)), (3, n_in, 9))
    for upto in (tp.total, tp.total // 2 + 1):
        struct, reps = tp.trace_struct(upto)
        jol, joc = jctx.runner(struct, 9, backend, batched=True)(fv, reps)
        tabs = ksf.device_sched_tables(tctx, "cpu")
        program = ksf.flat_program(struct, reps)
        assert int(np.dot(program["seg_len"], program["seg_reps"])) == upto
        ol, oc = ksf.sched_run_cuda(tabs, program, torch.tensor(fv))
        np.testing.assert_array_equal(ol.numpy(), np.asarray(jol))
        np.testing.assert_array_equal(oc.numpy(), np.asarray(joc))


@pytest.mark.parametrize("name,backend",
                         [("fir", "pallas"), ("dot_prod", "xla"),
                          ("bubble_sort", "xla")])
def test_sched_slot_step_matches_jax_step(name, backend):
    """sched_slot_step equals the JAX package's scheduled slot step on
    random registers (edge operands), random mid-plan positions of mixed
    feed-length plans, and parked slots (pid 0, fsel -1)."""
    jeng, teng = _engines(name, optimize=True, backend="reference")
    jctx, tctx = jeng._sched_ctx(), teng._sched_ctx()
    n_in = len(teng.p["input_arcs"])
    rng = np.random.default_rng(3)
    B, K, L = 6, 8, 12
    pids = np.zeros((B, K), np.int32)
    fsel = np.full((B,), -1, np.int32)
    for b in range(B - 2):                  # the last two slots are parked
        flen = tuple(int(x) for x in rng.integers(1, L + 1, n_in))
        jp, tp = jctx.plan_for(flen), tctx.plan_for(flen)
        jp.ensure(CAP)
        tp.ensure(CAP)
        pos = int(rng.integers(0, tp.total))
        pids[b] = tp.pids_window(pos, pos + K)
        np.testing.assert_array_equal(pids[b], jp.pids_window(pos, pos + K))
        fsel[b] = pids[b, -1]
    A2 = tctx.A2
    n_out = tctx.oa_pad.size
    state = [rng.integers(0, 2, (B, A2)).astype(np.int32),
             edge_ints(rng, (B, A2)),
             rng.integers(0, L + 2, (B, n_in)).astype(np.int32),
             edge_ints(rng, (B, n_out)),
             rng.integers(0, 50, (B, n_out)).astype(np.int32)]
    fv = edge_ints(rng, (B, n_in, L))
    jtabs = jctx.slot_tables()
    want = jctx.slot_step_fn(K, backend)(fv, pids, fsel, *state, *jtabs)
    tabs = ksf.device_sched_tables(tctx, "cpu")
    got = ksf.sched_slot_step_cuda(tabs, torch.tensor(fv), pids, fsel,
                                   *(torch.tensor(x) for x in state))
    for k, g, w in zip(STATE_KEYS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)


def test_stale_tables_raise():
    """Tables uploaded before new feed lengths registered new patterns
    refuse the new pids; device_sched_tables uploads again."""
    _, teng = _engines("fir", backend="reference")
    ctx = teng._sched_ctx()
    n_in = len(teng.p["input_arcs"])
    ctx.plan_for((3,) * n_in).ensure(CAP)
    old = ksf.device_sched_tables(ctx, "cpu")
    plan = ctx.plan_for(tuple(range(1, n_in + 1)))
    plan.ensure(CAP)
    assert len(ctx.registry) > old.n_patterns
    program = ksf.flat_program(*plan.trace_struct(plan.total))
    fv = torch.zeros((1, n_in, n_in), dtype=torch.int32)
    with pytest.raises(ValueError, match="stale"):
        ksf.sched_run_cuda(old, program, fv)
    new = ksf.device_sched_tables(ctx, "cpu")
    assert new is not old and new.n_patterns == len(ctx.registry)
    assert ksf.device_sched_tables(ctx, "cpu") is new
    ksf.sched_run_cuda(new, program, fv)


# ---------------------------------------------------------------------------
# the scheduled engine: run, run_batch, truncation, free-running fabrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,jbackend",
                         [("fir", "xla"), ("dot_prod", "xla"),
                          ("bubble_sort", "reference"),
                          ("horner", "reference")])
def test_scheduled_run_matches_jax(name, jbackend):
    """run and run_batch (equal and mixed feed lengths) at K in {1, 4,
    16}, profiled: every EngineResult field equals the JAX package's
    scheduled engine's (its xla lowering, or its numpy schedule
    interpreter, which launches nothing), and the numpy oracle's."""
    _, jg, tg = _fabric(name)
    feeds = _feeds(name, 12, 0)
    ref = run_reference(tg, feeds, max_cycles=CAP, profile=True)
    assert_same_result(ref, j_run_reference(jg, feeds, max_cycles=CAP,
                                            profile=True), name,
                       dispatches=False, profile=True)
    same = [_feeds(name, 8, s) for s in range(3)]
    mixed = [_feeds(name, k, k) for k in (4, 8, 2)]
    jeng = JEngine(jg, backend=jbackend, block_cycles=4, max_cycles=CAP,
                   profile=True, schedule=True)
    jrun, jsame, jmixed = (jeng.run(feeds), jeng.run_batch(same),
                           jeng.run_batch(mixed))
    launched = jbackend != "reference"
    for K in (1, 4, 16):
        teng = DataflowEngine(tg, block_cycles=K, max_cycles=CAP,
                              profile=True, schedule=True, device="cpu")
        got = teng.run(feeds)
        assert got.dispatches == 1
        assert_same_result(got, jrun, (name, K), dispatches=launched,
                           profile=True)
        assert_same_result(got, ref, (name, K), dispatches=False,
                           profile=True)
        for g, w, f in zip(teng.run_batch(same), jsame, same):
            assert_same_result(g, w, (name, K, "batch"), dispatches=launched,
                               profile=True)
            assert_same_result(g, run_reference(tg, f, max_cycles=CAP),
                               (name, K), dispatches=False)
        # mixed feed lengths share no plan: both packages run the dynamic
        # path, which counts launches by backend
        for g, w, f in zip(teng.run_batch(mixed), jmixed, mixed):
            assert_same_result(g, w, (name, K, "mixed"), dispatches=False)
            assert_same_result(g, run_reference(tg, f, max_cycles=CAP),
                               (name, K), dispatches=False)


def test_scheduled_reference_backend_matches_jax():
    _, jg, tg = _fabric("dot_prod")
    feeds = _feeds("dot_prod", 6, 4)
    jeng, teng = _engines("dot_prod", backend="reference", profile=True,
                          max_cycles=CAP)
    got = teng.run(feeds)
    assert got.dispatches is None
    assert_same_result(got, jeng.run(feeds), "reference", profile=True)


def test_scheduled_max_cycles_truncation():
    _, jg, tg = _fabric("fir")
    feeds = _feeds("fir", 32, 5)
    jeng, teng = _engines("fir", block_cycles=4, profile=True)
    for mc in (3, 17, 40):
        want = run_reference(tg, feeds, max_cycles=mc, profile=True)
        assert want.cycles == mc                    # it really truncated
        got = teng.run(feeds, max_cycles=mc)
        assert_same_result(got, want, mc, dispatches=False, profile=True)
        assert_same_result(got, jeng.run(feeds, max_cycles=mc), mc,
                           profile=True)


def test_free_running_fabric_schedules():
    """A const-fed fabric never quiesces: the plan locks onto a
    free-running period and the scheduled run stops at max_cycles exactly
    like the oracle."""
    g = Graph(name="free_run")
    g.add(Op.ADD, ["c1", "c2"], ["z"])
    g.const("c1", 3)
    g.const("c2", 4)
    assert tsched.schedulable(g)
    want = run_reference(g, {}, max_cycles=41)
    assert want.cycles == 41                        # never quiesces
    jeng = JEngine(jasm.parse(jasm.emit(g)), backend="xla", block_cycles=4,
                   max_cycles=41, schedule=True)
    eng = DataflowEngine(g, block_cycles=4, max_cycles=41, schedule=True,
                         device="cpu")
    got = eng.run({})
    assert_same_result(got, want, "free", dispatches=False)
    assert_same_result(got, jeng.run({}), "free")
    assert eng._sched_ctx().plan_for(())._free is not None


# ---------------------------------------------------------------------------
# the slot API
# ---------------------------------------------------------------------------
def _state_arrays(st):
    return {k: (getattr(st, k).cpu().numpy()
                if isinstance(getattr(st, k), torch.Tensor)
                else np.asarray(getattr(st, k))) for k in SLOT_FIELDS}


def _assert_same_slots(got, want, tag):
    g, w = _state_arrays(got), _state_arrays(want)
    for k in SLOT_FIELDS:
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{tag} {k}")


def test_slot_parity_with_dynamic():
    """Scheduled and dynamic slot engines agree on every slot-state field
    (registers, pointers, accumulators and host clocks) at every block
    boundary, on every harvested result (profile included), and after a
    re-admission on a harvested slot."""
    _, _, tg = _fabric("fir")
    feeds = [_feeds("fir", k, k) for k in (8, 16, 4)]
    for K in (1, 4, 16):
        dyn = DataflowEngine(tg, block_cycles=K, max_cycles=CAP,
                             profile=True, device="cpu")
        sch = DataflowEngine(tg, block_cycles=K, max_cycles=CAP,
                             profile=True, schedule=True, device="cpu")
        sd = dyn.reset_slots(dyn.init_state(4), [0, 1, 2], feeds)
        ss = sch.reset_slots(sch.init_state(4), [0, 1, 2], feeds)
        assert ss.prof is None and ss.sched is not None
        for blk in range(64):
            sd, ss = dyn.step_block(sd), sch.step_block(ss)
            _assert_same_slots(ss, sd, (K, blk))
            if sd.quiesced[:3].all():
                break
        sd, rd = dyn.harvest(sd, [0, 1, 2])
        ss, rs = sch.harvest(ss, [0, 1, 2])
        for i, (r, s) in enumerate(zip(rd, rs)):
            assert_same_result(s, r, (K, i), profile=True)
        # re-admission on a harvested slot rebinds its plan
        f2 = [_feeds("fir", 6, 99)]
        sd = dyn.reset_slots(sd, [1], f2)
        ss = sch.reset_slots(ss, [1], f2)
        while not sd.quiesced[1]:
            sd, ss = dyn.step_block(sd), sch.step_block(ss)
            _assert_same_slots(ss, sd, (K, "readmit"))
        (sd, (r,)), (ss, (s,)) = dyn.harvest(sd, [1]), sch.harvest(ss, [1])
        assert_same_result(s, r, (K, "readmit"), profile=True)


def test_jax_scheduled_state_resumes_in_port():
    """A JAX scheduled slot state captured mid-run crosses into the port
    (schedule positions and host counters included) and steps, harvests
    and admits identically in both packages."""
    jb, jg, tg = _fabric("dot_prod")
    jeng = JEngine(jg, backend="xla", block_cycles=4, max_cycles=CAP,
                   profile=True, schedule=True)
    feeds = [_feeds("dot_prod", k, k) for k in (3, 9, 6)]
    jst = jeng.reset_slots(jeng.init_state(4), [0, 1, 3], feeds,
                           caps=[None, 30, None])
    for _ in range(3):
        jst = jeng.step_block(jst)
    assert jst.active.sum() == 3 and not jst.quiesced.all()
    eng = DataflowEngine(tg, block_cycles=4, max_cycles=CAP, profile=True,
                         schedule=True, device="cpu")
    sc = jst.sched
    arrays = {k: np.asarray(getattr(jst, k)) for k in SLOT_FIELDS}
    arrays.update(prof_cycles=jst.prof_cycles, sched_pos=sc.pos,
                  sched_flen=[None if p is None else p.flen
                              for p in sc.plans],
                  sched_prof=[sc.nf, sc.si, sc.so, sc.ab, sc.ahw])
    tst = convert.slot_state_from_numpy(arrays, device="cpu", engine=eng)
    _assert_same_slots(tst, jst, "carried")
    with pytest.raises(ValueError, match="scheduled engine"):
        convert.slot_state_from_numpy(arrays, device="cpu")
    for step in range(8):
        jst, tst = jeng.step_block(jst), eng.step_block(tst)
        _assert_same_slots(tst, jst, ("step", step))
        done = jst.quiesced_slots()
        assert done == tst.quiesced_slots()
        if done:
            jst, jres = jeng.harvest(jst, done)
            tst, tres = eng.harvest(tst, done)
            for g, w in zip(tres, jres):
                assert_same_result(g, w, ("harvest", step), profile=True)
            f = _feeds("dot_prod", 5, step)
            jst = jeng.reset_slots(jst, done[:1], [f])
            tst = eng.reset_slots(tst, done[:1], [f])
            _assert_same_slots(tst, jst, ("admitted", step))


# ---------------------------------------------------------------------------
# the serve layer
# ---------------------------------------------------------------------------
def test_cached_engine_schedule_no_alias():
    _, _, tg = _fabric("fir")
    dataflow_server.clear_engine_cache()
    kw = dict(device="cpu", optimize=True)
    dyn = dataflow_server.cached_engine(tg, **kw)
    sch = dataflow_server.cached_engine(tg, schedule="auto", **kw)
    req = dataflow_server.cached_engine(tg, schedule=True, **kw)
    assert len({id(dyn), id(sch), id(req)}) == 3
    assert sch._sched_on and req._sched_on and not dyn._sched_on
    assert dataflow_server.cached_engine(tg, **kw) is dyn
    assert dataflow_server.cached_engine(tg, schedule="auto", **kw) is sch
    dataflow_server.clear_engine_cache()


def test_scheduled_server_matches_solo_and_dynamic():
    """A scheduled server answers every request as a solo run does, and
    as the dynamic server does in every field (metrics included)."""
    _, _, tg = _fabric("dot_prod")
    reqs = [_feeds("dot_prod", 2 + (5 * s) % 9, s) for s in range(7)]
    out = []
    for schedule in (False, True):
        srv = DataflowServer(tg, slots=3, block_cycles=4, max_cycles=CAP,
                             optimize=True, profile=True, schedule=schedule,
                             device="cpu")
        assert srv.engine._sched_on == schedule
        out.append(srv.run(reqs))
    solo = DataflowEngine(tg, block_cycles=4, max_cycles=CAP, profile=True,
                          schedule=True, device="cpu")
    for d, s, f in zip(*out, reqs):
        assert d.status == s.status == "ok"
        assert_same_result(s.engine, d.engine, s.uid, profile=True)
        assert dataclasses.asdict(s.metrics) == dataclasses.asdict(d.metrics)
        assert_same_result(s.engine, solo.run(f), s.uid, dispatches=False)
