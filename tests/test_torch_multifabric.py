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
            np.testing.assert_array_equal(arc[:, 0] & 0xFFFF, t["prod_node"])
            np.testing.assert_array_equal(arc[:, 0] >> 16, t["cons_node"])
            flag = arc[:, 1]
            np.testing.assert_array_equal(flag & 0x18, 8 << t["prod_slot"])
            np.testing.assert_array_equal(flag & 7, 1 << t["cons_slot"])
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


def _kernel_replay(t, words, fv, fl, s, active, n_cycles, prof):
    """The kernel's cycle order in numpy, one stream (CTA) at a time:
    feed and publish, the node phase, the arc phase (deltas, counters,
    drain; channel slots keep their register), the barrier, the merge on
    both endpoint lanes.  ``s`` holds the state's numpy arrays and is
    updated in place; returns (fired, last_prog) per stream."""
    P, N2m, A2m = t["P"], t["N2m"], t["A2m"]
    PA, PN = P * A2m, P * N2m
    node = words["node"].view(np.uint32).astype(np.int64)
    arc = words["arc"].view(np.uint32).astype(np.int64)
    flag = arc[:, 1]
    ch = (flag & (kmf.K_CH_IN | kmf.K_CH_OUT)) > 0
    aux = flag >> 16
    fired_all, lp_all = [], []
    for b in range(fv.shape[0]):
        if active[b] == 0:
            fired_all.append(0)
            lp_all.append(0)
            continue
        full = s["full"][b].astype(np.int64)
        val = s["val"][b].astype(np.int64)
        full[ch] = s["chf"][b][aux[ch]]
        val[ch] = s["chv"][b][aux[ch]]
        ptr, got = s["ptr"][b], np.zeros_like(s["out_count"][b])
        fired = lp = 0
        for cyc in range(n_cycles):
            prog = False
            push, pushv, consd = {}, {}, {}
            for i in range(PA):
                if flag[i] & kmf.K_FED:
                    k = aux[i]
                    if full[i] == 0 and ptr[k] < fl[b, k]:
                        val[i] = fv[b, k, ptr[k]]
                        full[i] = 1
                        ptr[k] += 1
                        prog = True
            regs = np.stack([full, val], 1)
            zc = np.zeros((PN, 2), np.int64)
            for n in range(PN):
                w = node[n]
                cp, z, ir = _rule(w[2] >> 16, regs[w[0] & 0xFFFF],
                                  regs[w[0] >> 16], regs[w[1] & 0xFFFF],
                                  regs[w[1] >> 16][0], regs[w[2] & 0xFFFF][0])
                zc[n] = (z, cp)
                fired += cp != 0
                prog |= cp != 0
                if prof:
                    s["nf"][b, n] += cp != 0
                    s["si"][b, n] += not ir
                    s["so"][b, n] += ir and cp == 0
            for i in range(PA):
                fw = flag[i]
                pz = zc[arc[i, 0] & 0xFFFF]
                produced = (pz[1] & fw & 0x18) != 0
                consumed = (zc[arc[i, 0] >> 16][1] & fw & 7) != 0
                f = int((full[i] > 0 and not consumed) or produced
                        or (fw & kmf.K_CONST) > 0)
                v = pz[0] if produced else val[i]
                c = aux[i]
                if fw & kmf.K_CH_OUT:
                    push[c], pushv[c] = int(full[i] == 0 and f), v
                elif fw & kmf.K_CH_IN:
                    consd[c] = int(full[i] != 0 and not f)
                else:
                    if prof and fw & kmf.K_OCC:
                        s["ab"][b, i] += f
                        s["ahw"][b, i] = max(s["ahw"][b, i], f)
                    if fw & kmf.K_DRAINED:
                        if f:
                            got[c] += 1
                            s["out_last"][b, c] = v
                            prog = True
                        f = 0
                    full[i], val[i] = f, v
            if prog:
                lp = cyc + 1
            for i in np.nonzero(ch)[0]:
                c = aux[i]
                f2 = int((full[i] != 0 and not consd[c]) or push[c])
                if push[c]:
                    val[i] = pushv[c]
                full[i] = f2
                if prof and flag[i] & kmf.K_CH_OUT:
                    s["cb"][b, c] += f2
                    s["chw"][b, c] = max(s["chw"][b, c], f2)
                    s["cpu"][b, c] += push[c]
        s["full"][b] = full
        s["val"][b] = val.astype(np.int32)
        for i in np.nonzero(flag & kmf.K_CH_OUT)[0]:
            s["chf"][b, aux[i]] = full[i]
            s["chv"][b, aux[i]] = s["val"][b, i]
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


@pytest.mark.parametrize("name,P,opt", [("dot_prod", 2, True),
                                        ("fibonacci", 2, False),
                                        ("bubble_sort", 4, False),
                                        ("pop_count", 4, True)])
def test_kernel_cycle_order_replay_equals_plain(name, P, opt):
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
                K, prof)
            np.testing.assert_array_equal(f.numpy(), rf)
            np.testing.assert_array_equal(lp.numpy(), rlp)
            for k in STATE + (PROF if prof else ()):
                np.testing.assert_array_equal(plain[k].numpy(), rep[k],
                                              err_msg=f"{name} K={K} {k}")


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
