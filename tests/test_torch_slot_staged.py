"""The scheduled slot step's and the fire step's warp variants, replayed
on the CPU.

``schedule_fire.sched_slot_step_staged`` runs a slot step the way the
warp variant of ``csrc/schedule_fire.cu`` does: each slot walks its pid
window once, runs only the cycles that feed, fire or drain (pid 0 and the
quiet patterns are skipped; a slot with none copies its state through),
and reads each feed token from a window staged once — tokens clamp(ptr) ..
clamp(ptr + n - 1) in 16-byte pieces aligned on the device address.
Here that replay is held bit for bit against the JAX package's
``make_sched_slot_step`` (Pallas in interpret mode) and the plain
``sched_slot_step`` on the 6 schedulable benches, at K = 1, 16, 64 and 65,
with pid windows taken from ``ConcretePlan.pids_window`` at random
points of mixed feed-length plans, pointers at and past the stream's end
(the clamp), every misalignment of the tokens and a parked slot.

``dataflow_fire.fire_step_warp_order`` runs the fire step in the order of
its one-warp kernel (lane l owns node and arc rows l + 32 j, the
registers read once at entry, a (z, cp) pair per node); it is held
against ``fire_step_pallas`` in interpret mode on the 7 benches and on
random graphs.  The variant rules and the wrappers' CPU paths (which
count no launch) are checked on their own; the shared-memory half of the
slot rule is the kernel launcher's, held by the gpu tests.  Inputs come
from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro.kernels import dataflow_fire as jdf  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.schedule import schedulable  # noqa: E402
from repro_torch.kernels import dataflow_fire as tdf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import schedule_fire as ksf  # noqa: E402
from repro_torch.testing import (STATE_KEYS, edge_ints,  # noqa: E402
                                 random_block_inputs, random_graph,
                                 random_slot_window_inputs, slot_plans)

SCHED_BENCHES = sorted(n for n, b in tlib.HAND_BUILT.items()
                       if schedulable(b().graph))
CAP = 4096


def _contexts(name):
    """The JAX package's schedule context and the port's, for one bench
    (the JAX fabric parsed from the port's asm)."""
    tg = tlib.BENCHES[name]().graph
    jg = jasm.parse(tasm.emit(tg), name=tg.name)
    return (JEngine(jg, backend="reference", schedule=True)._sched_ctx(),
            DataflowEngine(tg, device="cpu", schedule=True)._sched_ctx())


def _slot_inputs(jctx, tctx, K, L, rng, B=3):
    """B slots, the last parked: each active slot's pid window at a random
    point (past the end too) of a plan for random, mixed feed lengths, the
    same in both packages; pointers at L - 1, at L, past L or below it."""
    n_in = tctx.in_arc.size
    pids = np.zeros((B, K), np.int32)
    fsel = np.full((B,), -1, np.int32)
    for b in range(B - 1):
        flen = tuple(int(x) for x in rng.integers(1, L + 1, n_in))
        jp, tp = jctx.plan_for(flen), tctx.plan_for(flen)
        jp.ensure(CAP)
        tp.ensure(CAP)
        pos = int(rng.integers(0, tp.total + K))
        jp.ensure(pos + K)
        tp.ensure(pos + K)
        pids[b] = tp.pids_window(pos, pos + K)
        np.testing.assert_array_equal(pids[b], jp.pids_window(pos, pos + K))
        fsel[b] = pids[b, -1]
    n_in, n_out = tctx.ia_pad.size, tctx.oa_pad.size
    ptr = rng.choice([L - 1, L, L + 2, 0, L // 2, L - 3], (B, n_in))
    return dict(fv=edge_ints(rng, (B, n_in, L)), pids=pids, fsel=fsel,
                full=rng.integers(0, 2, (B, tctx.A2)).astype(np.int32),
                val=edge_ints(rng, (B, tctx.A2)),
                ptr=np.maximum(ptr, 0).astype(np.int32),
                out_last=edge_ints(rng, (B, n_out)),
                out_count=rng.integers(0, 90, (B, n_out)).astype(np.int32))


def _torch_args(x):
    return (torch.tensor(x["fv"]), x["pids"], x["fsel"],
            *(torch.tensor(x[k]) for k in STATE_KEYS))


@pytest.mark.parametrize("K", (1, 16, 64, 65))
@pytest.mark.parametrize("name", SCHED_BENCHES)
def test_staged_slot_step_matches_pallas(name, K):
    """sched_slot_step_staged == make_sched_slot_step (interpret) ==
    sched_slot_step, B = 3 (one parked), every misalignment."""
    jctx, tctx = _contexts(name)
    rng = np.random.default_rng(len(name) + K)
    L = 12
    x = _slot_inputs(jctx, tctx, K, L, rng)
    state = [x[k] for k in STATE_KEYS]
    want = jctx.slot_step_fn(K, "pallas")(x["fv"], x["pids"], x["fsel"],
                                          *state, *jctx.slot_tables())
    want = [np.asarray(w) for w in want]
    tabs = ksf.device_sched_tables(tctx, "cpu")
    args = _torch_args(x)
    for k, g, w in zip(STATE_KEYS, ksf.sched_slot_step(tabs, *args), want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    for mis in range(4):
        got = ksf.sched_slot_step_staged(tabs, *args, misalign=mis)
        for k, g, w in zip(STATE_KEYS, got, want):
            np.testing.assert_array_equal(
                g.numpy(), w, err_msg=f"{name} K={K} misalign={mis}: {k}")
    # the parked slot's state passes through (full too: fsel == -1)
    for k, g in zip(STATE_KEYS, got):
        np.testing.assert_array_equal(g[-1].numpy(), x[k][-1], err_msg=k)


@pytest.mark.parametrize("name", SCHED_BENCHES)
def test_staged_slot_step_over_many_slots(name):
    """24 slots riding 4 plans (a quarter parked, pointers clamped),
    K = 16 and 65, against sched_slot_step, every misalignment."""
    _, tctx = _contexts(name)
    rng = np.random.default_rng(3)
    plans = slot_plans(tctx, 40, rng, n=4)
    for K in (16, 65):
        x = random_slot_window_inputs(tctx, plans, 24, K, 40, rng)
        tabs = ksf.device_sched_tables(tctx, "cpu")
        args = _torch_args(x)
        want = ksf.sched_slot_step(tabs, *args)
        for mis in range(4):
            got = ksf.sched_slot_step_staged(tabs, *args, misalign=mis)
            for k, g, w in zip(STATE_KEYS, got, want):
                assert torch.equal(g, w), (name, K, mis, k)


def test_slot_windows_hold_any_start():
    """A feed row's window of n <= K tokens fits slot_window_ints(K) ints
    of 16-byte pieces wherever it starts."""
    for K in range(1, 70):
        for start in range(4):
            for n in (1, K):
                pieces = (start + n - 1) // 4 + 1
                assert 4 * pieces <= ksf.slot_window_ints(K), (K, start, n)


def test_slot_variant_by_width():
    """The warp variant takes tables up to WARP_ROWS rows wide: a wider
    fabric has no packed tables and runs the CTA variant at any K,
    without asking the card; a narrow one carries the packed tables the
    warp variant reads (its K rule is the launcher's shared memory, held
    by the gpu tests)."""
    wide = tlib.dot_product_graph(80)           # 160 feed rows
    ctx = DataflowEngine(wide.graph, device="cpu",
                         schedule=True)._sched_ctx()
    ctx.plan_for((6,) * ctx.in_arc.size).ensure(CAP)
    tabs = ksf.device_sched_tables(ctx, "cpu")
    assert tabs.warp is None
    for K in (1, 16, 64, 65, 4096):
        assert ksf.slot_plan(tabs, K, 1024, 0) is None
        assert ksf.slot_variant(tabs, K, 1024, 0) == "cta"
    _, tctx = _contexts("dot_prod")
    tabs = ksf.device_sched_tables(tctx, "cpu")
    assert tabs.warp is not None and tabs.warp["Fp"] == 64
    assert sorted(tabs.warp["bits"]) == [1, 2]


def test_slot_step_on_the_cpu_counts_no_launch():
    _, tctx = _contexts("fir")
    rng = np.random.default_rng(0)
    x = random_slot_window_inputs(tctx, slot_plans(tctx, 10, rng, n=2), 4,
                                  8, 10, rng)
    tabs = ksf.device_sched_tables(tctx, "cpu")
    args = _torch_args(x)
    n0 = ksf.sched_slot_step_cuda.launches
    by0 = dict(ksf.sched_slot_step_cuda.launches_by)
    got = ksf.sched_slot_step_cuda(tabs, *args)
    for g, w in zip(got, ksf.sched_slot_step(tabs, *args)):
        assert torch.equal(g, w)
    assert ksf.sched_slot_step_cuda.launches == n0
    assert ksf.sched_slot_step_cuda.launches_by == by0


# ---------------------------------------------------------------------------
# the fire step's warp order
# ---------------------------------------------------------------------------
def _jax_step_tables(jg):
    return {k: jnp.asarray(v) for k, v in jdf.plan_arrays(jg).items()
            if k not in ("plan", "class_slices")}


def _hold_warp_order(jg, tg, B, seed):
    jt = _jax_step_tables(jg)
    tt = tdf.block_plan_arrays(tg)
    x = random_block_inputs(tt, B, 1, np.random.default_rng(seed))
    fired = 0
    for b in range(B):
        full, val = x["full"][b], x["val"][b]
        want = jdf.fire_step_pallas(jt, jnp.asarray(full), jnp.asarray(val),
                                    interpret=True)
        got = tdf.fire_step_warp_order(tt, torch.tensor(full),
                                       torch.tensor(val))
        for k, g, w in zip(("full", "val", "fired"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{tg.name} {b}: {k}")
        fired += int(got[2][0])
    return fired


@pytest.mark.parametrize("name", sorted(tlib.HAND_BUILT))
def test_fire_step_warp_order_matches_pallas(name):
    jg, tg = jlib.BENCHES[name]().graph, tlib.BENCHES[name]().graph
    assert tdf.step_variant(tdf.block_plan_arrays(tg)) == "warp"
    _hold_warp_order(jg, tg, 3, len(name))


@pytest.mark.parametrize("seed", range(8))
def test_fire_step_warp_order_on_random_graphs(seed):
    """Random graphs (control operators among them), and one past the
    warp variant's 256 rows (lanes owning 10 rows: the order is the same
    rule)."""
    tg = random_graph(seed, nodes=150 if seed == 7 else None)
    jg = jasm.parse(tasm.emit(tg), name=tg.name)
    _hold_warp_order(jg, tg, 2, seed)


def test_step_variant_at_256_and_257_rows():
    """The warp variant up to WARP_ROWS = 256 rows in the node and the arc
    tables, the CTA variant past them (block_variant's size rule)."""
    assert tdf.WARP_ROWS == 256
    for n_rows, a_rows, want in ((256, 256, "warp"), (257, 10, "cta"),
                                 (10, 257, "cta"), (1, 1, "warp")):
        t = dict(opcode=np.zeros(n_rows, np.int32),
                 prod_node=np.zeros(a_rows, np.int32))
        assert tdf.step_variant(t) == want, (n_rows, a_rows)
    big = tdf.block_plan_arrays(random_graph(0, nodes=150))
    assert tdf.step_variant(big) == "cta"
    assert tdf.device_tables(big, "cpu").step_variant == "cta"
    small = tdf.device_tables(
        tdf.block_plan_arrays(tlib.dot_product_graph(32).graph), "cpu")
    assert small.step_variant == "warp"


@pytest.mark.parametrize("name", sorted(tlib.HAND_BUILT))
def test_step_words_pack_the_step_tables(name):
    """Each packed node word unpacks to the row's operand offsets and
    opcode, each arc word to its producer, consumer and const flag; a
    fabric too large for the warp variant gets none."""
    tt = tdf.block_plan_arrays(tlib.BENCHES[name]().graph)
    w = tdf.step_words(tt)
    node, arc = w["node"], w["arc"]
    np.testing.assert_array_equal(node[:, 0] & 0xffff, tt["in_idx"][:, 0])
    np.testing.assert_array_equal(node[:, 0] >> 16, tt["in_idx"][:, 1])
    np.testing.assert_array_equal(node[:, 1] & 0xffff, tt["in_idx"][:, 2])
    np.testing.assert_array_equal(node[:, 1] >> 16, tt["out_idx"][:, 0])
    np.testing.assert_array_equal(node[:, 2] & 0xffff, tt["out_idx"][:, 1])
    np.testing.assert_array_equal(node[:, 2] >> 16, tt["opcode"])
    np.testing.assert_array_equal(arc[:, 0] & 0xffff, tt["prod_node"])
    np.testing.assert_array_equal(arc[:, 0] >> 16, tt["prod_slot"])
    np.testing.assert_array_equal(arc[:, 1] & 0xffff, tt["cons_node"])
    np.testing.assert_array_equal((arc[:, 1] >> 16) & 0xff, tt["cons_slot"])
    np.testing.assert_array_equal(arc[:, 1] >> 24, tt["const_mask"] > 0)
    dt = tdf.device_tables(tt, "cpu")
    assert dt.step_words is not None
    big = tdf.device_tables(
        tdf.block_plan_arrays(random_graph(1, nodes=150)), "cpu")
    assert big.step_variant == "cta" and big.step_words is None


def test_fire_step_on_the_cpu_counts_no_launch():
    tables, step = tops.make_fire_step(tlib.dot_product_graph(32).graph,
                                       device="cpu")
    x = random_block_inputs(tables, 1, 1, np.random.default_rng(2))
    full, val = torch.tensor(x["full"][0]), torch.tensor(x["val"][0])
    n0 = tdf.fire_step_cuda.launches
    by0 = dict(tdf.fire_step_cuda.launches_by)
    got = step(full, val)
    for g, w in zip(got, tdf.fire_step(tables, full, val)):
        assert torch.equal(g, w)
    assert tdf.fire_step_cuda.launches == n0
    assert tdf.fire_step_cuda.launches_by == by0
