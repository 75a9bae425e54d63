"""Port vs JAX package: the partitioned engine (``partition=``,
``repro_torch.core.multifabric``) and the sharded block.

The JAX side is ``DataflowEngine(..., partition=P)`` on ``"xla"``, its
``MultiFabric`` under ``vmap`` on the one CPU device, on the same fabric
(asm text) and feeds made from a seed with numpy.  Every
``EngineResult`` field must be equal, the merged profile and its channel
counters included, on both port backends: ``"cuda"`` with
``device="cpu"`` (the kernel's plain version) and ``"torch"``; one case of
each (bench, P in {2, 4}), K, ``optimize`` and ``profile`` taking turns
(``tests/test_torch_multifabric_matrix.py`` holds the whole matrix
against the port's solo engine).  The kernel's packed tables decode back
to the plain version's, and a numpy replay of the kernel's own cycle
order (lanes, phases, one barrier, the merge on both endpoints) equals
the plain version on captured serving states.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import asm as jasm  # noqa: E402
from repro.core.engine import DataflowEngine as JEngine  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import DataflowEngine, alu_numpy  # noqa: E402
from repro_torch.core.graph import Op  # noqa: E402
from repro_torch.core.multifabric import MultiFabric  # noqa: E402
from repro_torch.core.partition import (Partition,  # noqa: E402
                                        partition_graph)
from repro_torch.kernels import multifabric as kmf  # noqa: E402
from repro_torch.testing import (assert_same_result,  # noqa: E402
                                 check_channels,
                                 random_graph)

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


# ---------------------------------------------------------------------------
# the JAX partitioned engine, one case of each (bench, P)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_partitioned_engine_equals_jax(name, P):
    i = NAMES.index(name)
    K = (1, 4, 16)[(i + P) % 3]
    opt, prof = FLAGS[(i + P // 2) % 4]
    bench = _bench(name)
    feeds = _feeds(name, bench, i)
    jeng = JEngine(_jax_graph(bench.graph), backend="xla", block_cycles=K,
                   partition=P, optimize=opt, profile=prof)
    want = jeng.run_batch(feeds)
    for backend in ("cuda", "torch"):
        eng = DataflowEngine(bench.graph, backend=backend, block_cycles=K,
                             device="cpu", partition=P, optimize=opt,
                             profile=prof)
        assert eng.partition.assign == jeng.partition.assign
        assert eng._mf.channels == jeng._mf_ctx().channels
        for k, (got, w) in enumerate(zip(eng.run_batch(feeds), want)):
            tag = (name, P, K, opt, prof, backend, k)
            assert_same_result(got, w, tag, profile=prof)
            if prof:
                assert got.profile.to_json() == w.profile.to_json(), tag
                check_channels(got, bench.graph)


@pytest.mark.parametrize("name", ["dot_prod"])
def test_single_run_equals_jax(name):
    bench = _bench(name)
    feeds = _feeds(name, bench, 9)[2]
    jeng = JEngine(_jax_graph(bench.graph), backend="xla", block_cycles=4,
                   partition=2, optimize=True, profile=True)
    want = jeng.run(feeds)
    for backend in ("cuda", "torch"):
        got = DataflowEngine(bench.graph, backend=backend, block_cycles=4,
                             device="cpu", partition=2, optimize=True,
                             profile=True).run(feeds)
        assert_same_result(got, want, (name, backend), profile=True)


def test_float_channel_keeps_signed_zero_and_nan():
    """A float token crosses a channel bit for bit: the merge is a gather
    from the producer's copy, not an arithmetic sum."""
    from repro_torch.core.graph import Graph
    g = Graph(name="float_chain")
    for k, (a, o) in enumerate((("x", "a1"), ("a1", "a2"), ("a2", "o"))):
        g.add(Op.COPY, [a], [o, f"d{k}"])
        g.add(Op.SINK, [f"d{k}"], [])
    x = np.asarray([-0.0, 0x7FC12345, 1.5], np.float32)
    x[1] = np.uint32(0x7FC12345).view(np.float32)     # a NaN payload
    eng = DataflowEngine(g, backend="torch", block_cycles=2, device="cpu",
                         partition=Partition(3, (0, 0, 1, 1, 2, 2)),
                         dtype=np.float32)
    assert eng._mf.C == 2
    for k in range(3):
        r = eng.run({"x": x[:k + 1]})
        assert r.outputs["o"].view(np.uint32) == x[k].view(np.uint32)


# ---------------------------------------------------------------------------
# the kernel's tables and cycle order, replayed on the CPU
# ---------------------------------------------------------------------------
def test_kernel_words_decode_to_the_tables():
    for name in NAMES:
        for P in (2, 4):
            g = _bench(name).graph
            mf = MultiFabric(g, partition_graph(g, P), device="cpu")
            t = mf.tables
            w = kmf.kernel_words(t)
            node = w["node"].view(np.uint32).astype(np.int64)
            arc = w["arc"].view(np.uint32).astype(np.int64)
            lo, hi = node & 0xFFFF, node >> 16
            np.testing.assert_array_equal(
                np.stack([lo[:, 0], hi[:, 0], lo[:, 1]], 1), t["in_idx"])
            np.testing.assert_array_equal(
                np.stack([hi[:, 1], lo[:, 2]], 1), t["out_idx"])
            np.testing.assert_array_equal(hi[:, 2], t["opcode"])
            # both copies of a channel name its producer (the out-copy's)
            # and its consumer (the in-copy's): the merge as an uncut arc
            prod, pslot = t["prod_node"].copy(), t["prod_slot"].copy()
            cons, cslot = t["cons_node"].copy(), t["cons_slot"].copy()
            for copies in (t["ch_in"], t["ch_out"]):
                prod[copies] = t["prod_node"][t["ch_out"]]
                pslot[copies] = t["prod_slot"][t["ch_out"]]
                cons[copies] = t["cons_node"][t["ch_in"]]
                cslot[copies] = t["cons_slot"][t["ch_in"]]
            np.testing.assert_array_equal(arc[:, 0] & 0xFFFF, prod)
            np.testing.assert_array_equal(arc[:, 0] >> 16, cons)
            flag = arc[:, 1]
            np.testing.assert_array_equal(flag & 0x18, 8 << pslot)
            np.testing.assert_array_equal(flag & 7, 1 << cslot)
            for key, bit in (("const_mask", kmf.K_CONST),
                             ("occ_mask", kmf.K_OCC)):
                np.testing.assert_array_equal((flag & bit) > 0, t[key] > 0)
            for key, bit, n in (("in_slot", kmf.K_FED, t["feed_rows"]),
                                ("out_slot", kmf.K_DRAINED,
                                 t["drain_rows"]),
                                ("ch_in", kmf.K_CH_IN, len(t["ch_in"])),
                                ("ch_out", kmf.K_CH_OUT, len(t["ch_out"]))):
                slots = np.nonzero(flag & bit)[0]
                assert sorted(slots) == sorted(t[key][:n]), (name, key)
                np.testing.assert_array_equal(flag[t[key][:n]] >> 16,
                                              np.arange(n))


def _rule(op, x0, x1, x2, o0, o1):
    """csrc multifabric.cu's fire_rule for one node: (cp, z, ir)."""
    in0, in1, in2 = x0[0] > 0, x1[0] > 0, x2[0] > 0
    oe0, oe1 = o0 == 0, o1 == 0
    a, b = np.int32(x0[1]), np.int32(x1[1])
    z = a if Op(op) in (Op.COPY, Op.BRANCH, Op.SINK, Op.NDMERGE,
                        Op.DMERGE) else alu_numpy(Op(op), a, b, np.int32)
    nd, dm, br = op == Op.NDMERGE, op == Op.DMERGE, op == Op.BRANCH
    c3, c2 = x2[1] != 0, x1[1] != 0
    all_in = in0 and in1 and in2
    r_in = (in0 or in1) if nd else (in2 and (in0 if c3 else in1)) if dm \
        else all_in
    ready = (in0 and in1 and (oe0 if c2 else oe1)) if br \
        else (r_in and oe0 and oe1)
    cons = (1 if in0 else 2) if nd else (5 if c3 else 6) if dm else 7
    prod = (1 if c2 else 2) if br else 3
    z = (a if in0 else b) if nd else (a if c3 else b) if dm else z
    z = np.asarray(z).astype(np.int64).astype(np.int32)   # int32 wrap
    return (cons | prod << 3) if ready else 0, int(z), r_in


_STALE = -1234567     # a window slot the kernel staged nothing into


def _kernel_replay(t, words, fv, fl, s, active, n_cycles, prof, chunk=None,
                   misalign=0):
    """The kernel's cycle order in numpy, one stream at a time, the same
    for both variants (they differ in which lane owns a row, not in what
    a lane computes): every chunk stages its feed windows from the
    pointers (16-byte pieces of the tokens placed ``misalign`` ints past a
    16-byte boundary; a token outside them reads as stale) and feeds its
    first cycle; a cycle is the node phase and the arc phase, in which
    every slot takes its next state from its producer's and consumer's
    (z, cp) pairs (a channel's copies too: their words name the channel's
    real ends, the merge in the warp), samples the counters (a channel's
    in its out-copy; a node's output stalls as the cycles less its
    firings and input stalls), drains, and is fed for the next cycle (not
    on a chunk's last).  ``s`` holds the state's numpy arrays and is updated
    in place; returns (fired, last_prog) per stream."""
    P, N2m, A2m = t["P"], t["N2m"], t["A2m"]
    PA, PN = P * A2m, P * N2m
    B, n_in, L = fv.shape
    chunk = chunk or max(1, min(64, n_cycles))
    W = kmf.window_ints(chunk)
    node = words["node"].view(np.uint32).astype(np.int64)
    arc = words["arc"].view(np.uint32).astype(np.int64)
    flag = arc[:, 1]
    ch = (flag & (kmf.K_CH_IN | kmf.K_CH_OUT)) > 0
    cho = (flag & kmf.K_CH_OUT) > 0
    occ = ((flag & kmf.K_OCC) > 0) & ~ch
    aux = flag >> 16
    fed = np.nonzero(flag & kmf.K_FED)[0]
    fv_flat = np.concatenate([np.full(misalign, _STALE, np.int64),
                              fv.reshape(-1).astype(np.int64),
                              np.full(W + 8, _STALE, np.int64)])
    fired_all, lp_all = [], []
    for b in range(B):
        if active[b] == 0:
            fired_all.append(0)
            lp_all.append(0)
            continue
        full = s["full"][b].astype(np.int64)
        val = s["val"][b].astype(np.int64)
        full[ch] = s["chf"][b][aux[ch]]
        val[ch] = s["chv"][b][aux[ch]]
        ptr = s["ptr"][b]
        got = np.zeros_like(s["out_count"][b])
        cnt = dict(ab=s["ab"][b].copy(), ahw=s["ahw"][b].copy()) if prof \
            else None
        if prof:
            cnt["ab"][cho] = s["cb"][b][aux[cho]]
            cnt["ahw"][cho] = s["chw"][b][aux[cho]]
        pushes = s["cpu"][b].copy() if prof else None
        win = np.full(n_in * W, _STALE, np.int64)
        wofs = np.zeros(n_in, np.int64)

        def token(k):
            slot = wofs[k] + min(max(int(ptr[k]), 0), L - 1)
            return win[min(max(slot, 0), n_in * W - 1)]

        def feed(i, f, v, lp, at):
            k = aux[i]
            if f == 0 and ptr[k] < fl[b, k]:
                v, f = token(k), 1
                ptr[k] += 1
                lp = at
            return f, v, lp

        fired = lp = 0
        if prof:        # output stalls: the cycles less firings and input
            nf0, si0 = s["nf"][b].copy(), s["si"][b].copy()     # stalls
        for c0 in range(0, n_cycles, chunk):
            c1 = min(c0 + chunk, n_cycles)
            for k in aux[fed]:                 # stage the chunk's windows
                p = int(ptr[k])
                hi = min(p + chunk, int(fl[b, k]))
                wofs[k] = k * W
                if hi <= p:
                    continue
                a, e = min(max(p, 0), L - 1), min(max(hi - 1, 0), L - 1)
                row = misalign + (b * n_in + k) * L
                start = (row + a) & ~3
                n = 4 * (((row + e - start) >> 2) + 1)
                win[k * W:k * W + n] = fv_flat[start:start + n]
                wofs[k] = k * W + (row + a - start) - a
            for i in fed:
                full[i], val[i], lp = feed(i, full[i], val[i], lp, c0 + 1)
            for cyc in range(c0, c1):
                regs = np.stack([full, val], 1)
                zc = np.zeros((PN, 2), np.int64)
                for n in range(PN):
                    w = node[n]
                    cp, z, ir = _rule(w[2] >> 16, regs[w[0] & 0xFFFF],
                                      regs[w[0] >> 16], regs[w[1] & 0xFFFF],
                                      regs[w[1] >> 16][0],
                                      regs[w[2] & 0xFFFF][0])
                    zc[n] = (z, cp)
                    fired += cp != 0
                    lp = cyc + 1 if cp != 0 else lp
                    if prof:
                        s["nf"][b, n] += cp != 0
                        s["si"][b, n] += not ir
                for i in range(PA):
                    fw = flag[i]
                    pz = zc[arc[i, 0] & 0xFFFF]
                    produced = (pz[1] & fw & 0x18) != 0
                    consumed = (zc[arc[i, 0] >> 16][1] & fw & 7) != 0
                    f = int((full[i] > 0 and not consumed) or produced
                            or (fw & kmf.K_CONST) > 0)
                    v = pz[0] if produced else val[i]
                    if prof and (cho[i] or occ[i]):
                        cnt["ab"][i] += f
                        cnt["ahw"][i] = max(cnt["ahw"][i], f)
                        if cho[i]:
                            pushes[aux[i]] += full[i] == 0 and f
                    if fw & kmf.K_DRAINED:
                        if f:
                            got[aux[i]] += 1
                            s["out_last"][b, aux[i]] = v
                            lp = max(lp, cyc + 1)
                        f = 0
                    if fw & kmf.K_FED and cyc + 1 < c1:
                        f, v, lp = feed(i, f, v, lp, cyc + 2)
                    full[i], val[i] = f, v
        s["full"][b] = full
        s["val"][b] = val.astype(np.int32)
        for i in np.nonzero(cho)[0]:
            s["chf"][b, aux[i]] = full[i]
            s["chv"][b, aux[i]] = s["val"][b, i]
        if prof:
            s["so"][b] += n_cycles - (s["nf"][b] - nf0) - (s["si"][b] - si0)
            s["ab"][b][occ] = cnt["ab"][occ]
            s["ahw"][b][occ] = cnt["ahw"][occ]
            s["cb"][b][aux[cho]] = cnt["ab"][cho]
            s["chw"][b][aux[cho]] = cnt["ahw"][cho]
            s["cpu"][b] = pushes
        s["out_count"][b] += got
        fired_all.append(fired)
        lp_all.append(lp)
    return np.asarray(fired_all), np.asarray(lp_all)


STATE = ("full", "val", "ptr", "out_last", "out_count", "chf", "chv")
PROF = ("nf", "si", "so", "ab", "ahw", "cb", "chw", "cpu")


def _captured_state(name, P, opt, seed=0, slots=3, K=4, blocks=2):
    """A partitioned engine's slot state after a few served blocks: the
    last slot parked, counters on."""
    bench = _bench(name)
    eng = DataflowEngine(bench.graph, block_cycles=K, device="cpu",
                         partition=P, optimize=opt, profile=True)
    rng = np.random.default_rng(seed)
    st = eng.init_state(slots)
    st = eng.reset_slots(st, list(range(slots - 1)),
                         [tlib.random_feeds(name, bench, 3 + k, rng)
                          for k in range(slots - 1)])
    for _ in range(blocks):
        st = eng.step_block(st)
    return eng, st


REPLAY_CASES = [("dot_prod", 2, True), ("fibonacci", 2, False),
                ("bubble_sort", 4, False), ("pop_count", 4, True)]


def _replay_against_plain(name, P, opt, chunk=None, misalign=0):
    eng, st = _captured_state(name, P, opt)
    mf = eng._mf
    tensors = dict(zip(STATE, (st.full, st.val, st.ptr, st.out_last,
                               st.out_count, st.mf["chf"], st.mf["chv"])))
    tensors.update(zip(PROF, (*st.prof, *st.mf["chprof"])))
    for K in (1, 5):
        for prof in (False, True):
            plain = {k: v.clone() for k, v in tensors.items()}
            f, lp = kmf.mf_block(
                mf.tabs, st.fv, st.fl, *(plain[k] for k in STATE),
                n_cycles=K, active=st.active_dev,
                prof=[plain[k] for k in PROF[:5]] if prof else None,
                chprof=[plain[k] for k in PROF[5:]] if prof else None)
            rep = {k: v.numpy().copy() for k, v in tensors.items()}
            words = {k: v.numpy() for k, v in mf.tabs.words.items()}
            rf, rlp = _kernel_replay(mf.tables, words,
                st.fv.numpy(), st.fl.numpy(), rep, st.active_dev.numpy(),
                K, prof, chunk=chunk, misalign=misalign)
            np.testing.assert_array_equal(f.numpy(), rf)
            np.testing.assert_array_equal(lp.numpy(), rlp)
            for k in STATE + (PROF if prof else ()):
                np.testing.assert_array_equal(plain[k].numpy(), rep[k],
                                              err_msg=f"{name} K={K} {k}")


@pytest.mark.parametrize("name,P,opt", REPLAY_CASES)
def test_kernel_cycle_order_replay_equals_plain(name, P, opt):
    """The kernel's cycle order (the merge folded into the arc phase, the
    feed strobed a cycle early from windows staged once a block) equals
    the plain block bit for bit."""
    _replay_against_plain(name, P, opt)


@pytest.mark.parametrize("name,P,opt", REPLAY_CASES)
def test_kernel_replay_with_restaged_windows_equals_plain(name, P, opt):
    """The same with the feed windows staged again every 2 cycles, from
    tokens 3 ints past a 16-byte boundary: a token read outside its
    window would come back stale."""
    _replay_against_plain(name, P, opt, chunk=2, misalign=3)


def test_tables_past_the_kernel_limits_are_named():
    """A region past one warp's rows, or more regions than a CTA's warps:
    the kernel refuses, naming the limit (the plain version runs them)."""
    big = random_graph(3, nodes=300)
    chain = tlib.vector_sum_graph(64).graph
    z = torch.zeros((1, 1), dtype=torch.int32)
    for g, part, limit in (
            (big, Partition(2, tuple(int(i >= 150) for i in
                                     range(len(big.nodes)))), "256"),
            (chain, Partition(33, tuple(i % 33 for i in
                                        range(len(chain.nodes)))), "32")):
        mf = MultiFabric(g, part, device="cpu")
        assert mf.tabs.words is None and limit in mf.tabs.too_large
        with pytest.raises(ValueError, match="cannot run"):
            kmf.launch_mf(mf.tabs, z[None], *[z] * 8, n_cycles=1)


@pytest.mark.parametrize("P,N2m,A2m,want", [
    (2, 33, 67, "warp"), (4, 18, 37, "warp"), (8, 32, 32, "warp"),
    (256, 1, 1, "warp"), (2, 129, 100, "cta"), (4, 20, 65, "cta"),
    (32, 256, 256, "cta"), (33, 8, 8, None), (2, 100, 257, None)])
def test_mf_variant_rule(P, N2m, A2m, want):
    """The variant is decided from the table sizes before any launch: the
    warp variant while the flat tables fit one warp's rows, the CTA
    variant up to 32 regions of 256 rows, else no kernel."""
    assert kmf.mf_variant(P, N2m, A2m) == want


@pytest.mark.parametrize("name,P,want", [("dot_prod", 2, "warp"),
                                         ("dot_prod", 4, "warp"),
                                         ("random150", 2, "cta")])
def test_tables_carry_their_variant(name, P, want):
    g = random_graph(5, nodes=150) if name == "random150" \
        else tlib.dot_product_graph(32).graph
    mf = MultiFabric(g, partition_graph(g, P), device="cpu")
    assert mf.tabs.variant == want == kmf.mf_variant(P, mf.N2m, mf.A2m)
    assert mf.tabs.words is not None and mf.tabs.too_large is None


def test_mf_plan_fits_the_card():
    """The launch plan: the chunk halves until a stream's shared memory
    fits, and the warp variant packs up to 4 streams while two CTAs fit
    an SM (bytes from the kernel's own layout, here the formula)."""
    def nbytes(P, N2m, A2m, n_in, variant, window):
        pad = lambda x: -(-x // 16) * 16        # noqa: E731
        return pad(8 * P * A2m) + (1 + variant) * pad(8 * P * N2m) \
            + 4 * n_in * window
    assert kmf.mf_plan("warp", 2, 33, 67, 64, 1024, 64, nbytes,
                       232448) == (64, kmf.window_ints(64), 4)
    chunk, window, streams = kmf.mf_plan("warp", 2, 33, 67, 64, 1024, 64,
                                         nbytes, 16000)
    assert chunk < 64 and nbytes(2, 33, 67, 64, 0, window) <= 16000
    assert streams == 1
    assert kmf.mf_plan("cta", 4, 20, 65, 8, 3, 5, nbytes, 232448) == (
        5, kmf.window_ints(5), 1)
    with pytest.raises(ValueError, match="shared memory"):
        kmf.mf_plan("warp", 2, 33, 67, 64, 1, 64, nbytes, 1000)
