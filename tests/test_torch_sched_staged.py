"""The scheduled-run kernel's warp variant, replayed on the CPU.

``schedule_fire.sched_run_staged`` runs a scheduled program the way the
warp variant of ``csrc/schedule_fire.cu`` reads its feed tokens: windows
of W tokens by position, double-buffered, restaged at the start of every
chunk of W / 2 cycles, a copy landing only at the next chunk's start,
16-byte pieces aligned on the device address, the clamp to the row's last
token.  Here that replay is held bit for bit against the JAX package's
``make_sched_run`` (Pallas in interpret mode) and against the plain
``sched_run`` on the 6 schedulable benches, at W = 4 (restaging every two
cycles) and W = 8, at stream lengths around the window and feeds shorter
than the plan (the clamp is read), at every misalignment of the tokens'
start.  The variant rule's width test and the packed tables are checked
on their own (the launch plan is the kernel launcher's, held on the
card).  Inputs come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.core.schedule import schedulable  # noqa: E402
from repro_torch.kernels import schedule_fire as ksf  # noqa: E402
from repro_torch.testing import edge_ints, every_cycle_sched  # noqa: E402

SCHED_BENCHES = sorted(n for n, b in tlib.HAND_BUILT.items()
                       if schedulable(b().graph))
W = 4
# stream lengths: 1, around the window, and odd past two windows
LENGTHS = (1, W - 1, W, W + 1, 2 * W + 3)


def _contexts(name):
    """The JAX package's schedule context and the port's, for one bench
    (the JAX fabric parsed from the port's asm)."""
    tg = tlib.BENCHES[name]().graph
    jg = jasm.parse(tasm.emit(tg), name=tg.name)
    return (JEngine(jg, backend="reference", schedule=True)._sched_ctx(),
            DataflowEngine(tg, device="cpu", schedule=True)._sched_ctx())


def _plan(jctx, tctx, L, rng):
    """One feed-length tuple's plan in both packages: half the rows (at
    least one) feed two tokens past L, so their clamp is read."""
    n_in = tctx.in_arc.size
    flen = tuple(L + 2 if r % 2 == 0 else L for r in range(n_in))
    jp, tp = jctx.plan_for(flen), tctx.plan_for(flen)
    jp.ensure(4096)
    tp.ensure(4096)
    assert tp.total == jp.total
    return tp


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("name", SCHED_BENCHES)
def test_staged_run_matches_pallas(name, L):
    """sched_run_staged == make_sched_run (interpret) == sched_run, B = 3,
    whole and clipped, W = 4 and 8, every misalignment."""
    jctx, tctx = _contexts(name)
    rng = np.random.default_rng(len(name) + L)
    tp = _plan(jctx, tctx, L, rng)
    fv = edge_ints(rng, (3, tctx.ia_pad.size, L))
    tabs = ksf.device_sched_tables(tctx, "cpu")
    for upto in (tp.total, tp.total // 2 + 1):
        struct, reps = tp.trace_struct(upto)
        jol, joc = jctx.runner(struct, L, "pallas", batched=True)(fv, reps)
        want = (np.asarray(jol), np.asarray(joc))
        program = ksf.flat_program(struct, reps)
        plain = ksf.sched_run(tabs, program, torch.tensor(fv))
        for g, w in zip(plain, want):
            np.testing.assert_array_equal(g.numpy(), w)
        for window in (W, 2 * W):
            for mis in range(4):
                got = ksf.sched_run_staged(tabs, program, torch.tensor(fv),
                                           window=window, misalign=mis)
                for k, g, w in zip(("out_last", "out_count"), got, want):
                    np.testing.assert_array_equal(
                        g.numpy(), w,
                        err_msg=f"{name} L={L} upto={upto} W={window} "
                                f"misalign={mis}: {k}")


@pytest.mark.parametrize("name", SCHED_BENCHES)
def test_staged_run_over_many_windows(name):
    """Streams of 4 windows and a half at W = 4 and 8 (many restaging
    chunks), B = 2, against sched_run."""
    _, tctx = _contexts(name)
    rng = np.random.default_rng(7)
    L = 9 * W // 2 + 1
    flen = tuple(int(x) for x in rng.integers(L - 3, L + 3,
                                              tctx.in_arc.size))
    plan = tctx.plan_for(flen)
    plan.ensure(1 << 16)
    program = ksf.flat_program(*plan.trace_struct(plan.total))
    tabs = ksf.device_sched_tables(tctx, "cpu")
    fv = torch.tensor(edge_ints(rng, (2, tctx.ia_pad.size, L)))
    want = ksf.sched_run(tabs, program, fv)
    for window in (W, 2 * W):
        for mis in (0, 3):
            got = ksf.sched_run_staged(tabs, program, fv, window=window,
                                       misalign=mis)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, window, mis)


@pytest.mark.parametrize("L", (*LENGTHS, 4 * W + 1))
def test_staged_run_feeding_every_cycle(L):
    """Rows that take a token every cycle (a fabric's handshake allows one
    every two), some every other cycle later on, past the end of the
    stream: the windows must land exactly in time.  Against sched_run and
    against the tokens themselves, W = 4 and 8, every misalignment."""
    n_in, cycles = 5, L + 5
    host, program = every_cycle_sched(n_in, L, cycles)
    tabs = ksf.upload_sched_tables(host, "cpu", 4)
    fv = torch.tensor(edge_ints(np.random.default_rng(L), (2, n_in, L)))
    ol, oc = ksf.sched_run(tabs, program, fv)
    fed = oc[0].long()
    assert (fed[::2] == ksf.program_cycles(program)).all()
    for r in range(n_in):
        pos = torch.arange(int(fed[r])).clamp(max=L - 1)
        total = fv[:, r, pos].long().sum(1)
        want = ((total + 2 ** 31) % 2 ** 32 - 2 ** 31).int()
        assert torch.equal(ol[:, r], want)
    for window in (W, 2 * W):
        for mis in range(4):
            got = ksf.sched_run_staged(tabs, program, fv, window=window,
                                       misalign=mis)
            assert torch.equal(got[0], ol) and torch.equal(got[1], oc), \
                (L, window, mis)


def test_staged_window_must_be_a_power_of_two():
    _, tctx = _contexts("fir")
    tabs = ksf.device_sched_tables(tctx, "cpu")
    plan = tctx.plan_for((3,) * tctx.in_arc.size)
    plan.ensure(4096)
    program = ksf.flat_program(*plan.trace_struct(plan.total))
    fv = torch.zeros((1, tctx.ia_pad.size, 3), dtype=torch.int32)
    for bad in (2, 6, 12):
        with pytest.raises(ValueError, match="power of two"):
            ksf.sched_run_staged(tabs, program, fv, window=bad)


@pytest.mark.parametrize("name", SCHED_BENCHES)
def test_warp_tables_pack_the_host_tables(name):
    """Each fire word unpacks to the row's (op, i0, i1, o0, o1), rows past
    F to a COPY into the sentinel; each lane's bits are its rows' feed and
    drain flags (for streams of one warp and of two), with the flags of
    the groups of rows that feed, drain or fire."""
    _, tctx = _contexts(name)
    tctx.plan_for((5,) * tctx.in_arc.size).ensure(4096)
    host = ksf.host_sched_tables(tctx)
    wt = ksf.warp_tables(host)
    P, F = host["op"].shape
    A2 = host["val0"].shape[0]
    g = wt["Fp"] // 32
    assert wt["Fp"] >= F and g == ksf.warp_groups(
        host["ia"].size, F, host["oa"].size)
    x, y = wt["fire"][..., 0], wt["fire"][..., 1]
    unpacked = dict(i0=x & 0x1fff, i1=(x >> 13) & 0x1fff, op=x >> 26,
                    o0=y & 0xffff, o1=y >> 16)
    for k, v in unpacked.items():
        np.testing.assert_array_equal(v[:, :F], host[k], err_msg=k)
    assert (unpacked["op"][:, F:] == 0).all()
    assert (unpacked["o0"][:, F:] == A2).all()
    assert (unpacked["o1"][:, F:] == A2).all()
    real = np.arange(F)[None, :] < host["nfire"][:, None]
    assert sorted(wt["bits"]) == ([1, 2] if wt["Fp"] >= 64 else [1])
    for G, word in wt["bits"].items():
        TS = 32 * G
        assert word.shape == (P, TS)
        for tab, shift, fshift in ((host["feed"], 0, 16),
                                   (host["drain"], 8, 20), (real, None, 24)):
            for r in range(tab.shape[1]):
                t, k = r % TS, r // TS
                if shift is not None:
                    np.testing.assert_array_equal(
                        (word[:, t] >> (shift + k)) & 1, tab[:, r])
            for k in range(wt["Fp"] // TS):
                want = tab[:, TS * k:TS * (k + 1)].any(1)
                for t in (0, TS - 1):
                    np.testing.assert_array_equal(
                        (word[:, t] >> (fshift + k)) & 1, want,
                        err_msg=(G, fshift, k))


def test_warp_variant_by_width_and_shared_memory():
    """The warp variant takes tables up to WARP_ROWS rows wide; a wider
    fabric has no packed tables and runs the CTA variant, whatever the
    card (the shared-memory half of the rule is the launcher's plan, held
    by the gpu tests)."""
    assert ksf.warp_groups(64, 64, 1) == 2
    assert ksf.warp_groups(1, 16, 1) == 1
    assert ksf.warp_groups(65, 8, 8) == 4
    assert ksf.warp_groups(ksf.WARP_ROWS + 1, 8, 8) is None
    wide = tlib.dot_product_graph(80)           # 160 feed rows
    ctx = DataflowEngine(wide.graph, device="cpu",
                         schedule=True)._sched_ctx()
    plan = ctx.plan_for((6,) * ctx.in_arc.size)
    plan.ensure(4096)
    tabs = ksf.device_sched_tables(ctx, "cpu")
    program = ksf.flat_program(*plan.trace_struct(plan.total))
    assert tabs.warp is None
    assert ksf.warp_plan(tabs, program, 8, 0) is None
    assert ksf.sched_variant(tabs, program, 8, 0) == "cta"
    _, tctx = _contexts("dot_prod")
    tabs = ksf.device_sched_tables(tctx, "cpu")
    assert tabs.warp is not None and tabs.warp["Fp"] == 64
    assert sorted(tabs.warp["bits"]) == [1, 2]


def test_warp_program_renumbers_the_used_patterns():
    prog = dict(seg_off=np.array([0, 2], np.int32),
                seg_len=np.array([2, 1], np.int32),
                seg_reps=np.array([3, 1], np.int32),
                pids=np.array([9, 4, 9], np.int32))
    wp = ksf.warp_program(prog)
    np.testing.assert_array_equal(wp["used"], [4, 9])
    np.testing.assert_array_equal(wp["used"][wp["pids"]], prog["pids"])
    assert wp["cycles"] == ksf.program_cycles(prog) == 7
    empty = {k: np.zeros(0, np.int32) for k in ksf.PROGRAM_KEYS}
    assert ksf.warp_program(empty)["used"].size == 1


def test_sched_run_on_the_cpu_counts_no_launch():
    _, tctx = _contexts("fir")
    plan = tctx.plan_for((5,) * tctx.in_arc.size)
    plan.ensure(4096)
    tabs = ksf.device_sched_tables(tctx, "cpu")
    program = ksf.flat_program(*plan.trace_struct(plan.total))
    fv = torch.tensor(edge_ints(np.random.default_rng(0),
                                (2, tctx.ia_pad.size, 5)))
    n0, by0 = ksf.sched_run_cuda.launches, dict(ksf.sched_run_cuda.launches_by)
    got = ksf.sched_run_cuda(tabs, program, fv)
    for g, w in zip(got, ksf.sched_run(tabs, program, fv)):
        assert torch.equal(g, w)
    assert ksf.sched_run_cuda.launches == n0
    assert ksf.sched_run_cuda.launches_by == by0
