"""The CUDA fire-block kernel's cycle order, replayed on the CPU.

``dataflow_fire.fire_block_two_phase`` computes a block the way
``csrc/dataflow_fire.cu`` does: cycle 0's feed as a prologue, two
phases per cycle with the drain and the next cycle's feed on the arc's
lane (reached through the reverse maps ``device_tables`` builds),
firings and the last progress kept per lane and reduced at the end,
feed tokens read from windows staged every chunk of cycles as the
kernel stages them.  Here that order is held bit for bit against the
JAX package's ``fire_block_batched_pallas`` and ``fire_block_pallas``
in interpret mode, on the 7 benches (dense and specialized, with and
without counters), random graphs with control operators, a fabric
with no input (a pad feed row) and one above the warp variant's size;
and the reverse maps, the variant choice and the launch plan are checked
on their own.
Inputs come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.kernels import dataflow_fire as jdf  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.graph import Graph, Op  # noqa: E402
from repro_torch.kernels import dataflow_fire as tdf  # noqa: E402
from repro_torch.testing import (STATE_KEYS, random_block_inputs,  # noqa: E402
                                 random_graph, random_prof)

BENCHES = sorted(tlib.HAND_BUILT)
CHUNK = tdf.STAGE_CYCLES
# K of a block: 1, 2, 16, 64 cycles and one past the staging chunk
KS = (1, 2, 16, 64, CHUNK + 1)
# (chunk, misalign) pairs the replay also runs at every K: restaging
# every cycle or every few, the tokens off a 16-byte boundary
STAGINGS = ((CHUNK, 0), (1, 3), (4, 1), (7, 2))
FEED_KEYS = ("feed_vals", "feed_len", *STATE_KEYS)


def _pair(tg):
    """The port's fabric and the same one in the JAX package (as asm)."""
    return jasm.parse(tasm.emit(tg), name=tg.name), tg


def _inputs(tables, B, L, K, seed):
    """Random mid-run inputs with stream 1 parked, stream 0 active, and
    stream 2's rows near their end: feed_len below L, ptr within K of
    it."""
    rng = np.random.default_rng(seed)
    x = random_block_inputs(tables, B, L, rng)
    x["active"][0], x["active"][1] = 1, 0
    real = len(tables["plan"]["input_arcs"])
    if real:
        fl = L - rng.integers(1, 4, real)
        x["feed_len"][2, :real] = fl
        x["ptr"][2, :real] = np.maximum(fl - rng.integers(0, K + 1, real), 0)
    return x, random_prof(tables, B, rng)


def _jax_block(jt, x, prof, K, b=None):
    """The JAX Pallas kernel in interpret mode: batched over every
    stream, or single on stream ``b``."""
    if b is None:
        return jdf.fire_block_batched_pallas(
            jt, *(jnp.asarray(x[k]) for k in FEED_KEYS), n_cycles=K,
            active=jnp.asarray(x["active"]),
            prof=None if prof is None else tuple(map(jnp.asarray, prof)),
            interpret=True)
    return jdf.fire_block_pallas(
        jt, *(jnp.asarray(x[k][b]) for k in FEED_KEYS), n_cycles=K,
        prof=None if prof is None else tuple(jnp.asarray(p[b]) for p in prof),
        interpret=True)


def _replay(dt, x, prof, K, chunk, misalign, b=None):
    t = {k: torch.tensor(v) for k, v in x.items()}
    pr = None if prof is None else tuple(torch.tensor(p) for p in prof)
    if b is not None:     # one stream, as the single entry launches it
        return tdf.fire_block_two_phase(
            dt, *(t[k][b:b + 1] for k in FEED_KEYS), n_cycles=K,
            prof=None if pr is None else tuple(p[b:b + 1] for p in pr),
            chunk=chunk, misalign=misalign)
    return tdf.fire_block_two_phase(
        dt, *(t[k] for k in FEED_KEYS), n_cycles=K, active=t["active"],
        prof=pr, chunk=chunk, misalign=misalign)


def _assert_equal(got, want, tag):
    names = (*STATE_KEYS, "fired", "last_prog", "nf", "si", "so", "ab",
             "ahw")
    assert len(got) == len(want), tag
    for k, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy().reshape(np.shape(w)),
                                      np.asarray(w), err_msg=f"{tag} {k}")


def _hold(jg, tg, optimize, profiled, Ks, B=5, L=80, stagings=STAGINGS,
          single=True):
    jt = jdf.block_plan_arrays(jg, optimize=optimize)
    tt = tdf.block_plan_arrays(tg, optimize=optimize)
    dt = tdf.device_tables(tt, "cpu")
    for K in Ks:
        x, prof = _inputs(tt, B, L, K, seed=K + 7 * optimize)
        prof = prof if profiled else None
        want = _jax_block(jt, x, prof, K)
        for chunk, mis in stagings:
            _assert_equal(_replay(dt, x, prof, K, chunk, mis), want,
                          (tg.name, K, chunk, mis))
        if single:
            _assert_equal(_replay(dt, x, prof, K, CHUNK, 1, b=0),
                          _jax_block(jt, x, prof, K, b=0),
                          (tg.name, K, "single"))


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("name", BENCHES)
def test_two_phase_order_matches_pallas(name, optimize, profiled):
    builder = {"dot_prod": "dot_product_graph",
               "bubble_sort": "bubble_sort_graph"}.get(name)
    if builder is None:
        jg, tg = jlib.BENCHES[name]().graph, tlib.BENCHES[name]().graph
    else:
        jg, tg = getattr(jlib, builder)().graph, getattr(tlib, builder)().graph
    _hold(jg, tg, optimize, profiled, KS, single=name in (
        "dot_prod", "bubble_sort", "fibonacci"))


@pytest.mark.parametrize("seed", range(8))
def test_two_phase_order_on_random_graphs(seed):
    """Random fabrics with NDMERGE, DMERGE and BRANCH among their nodes,
    dense and specialized, profiled."""
    jg, tg = _pair(random_graph(seed))
    for optimize in (False, True):
        _hold(jg, tg, optimize, True, (9,), B=4, L=24,
              stagings=((CHUNK, 0), (4, 3)), single=False)


def _const_fabric():
    g = Graph(name="no_input")
    g.const("c1", 5)
    g.const("c2", -7)
    g.add(Op.ADD, ["c1", "c2"], ["s"])
    g.add(Op.MUL, ["s", "c1"], ["out"])
    g.validate()
    return g


@pytest.mark.parametrize("K", [1, 16])
def test_pad_feed_row_advances_like_pallas(K):
    """A fabric with no input has one pad feed row on the empty pad arc:
    its pointer advances (and counts as progress) while its length
    allows, and it writes no arc."""
    jg, tg = _pair(_const_fabric())
    jt, tt = jdf.block_plan_arrays(jg), tdf.block_plan_arrays(tg)
    assert tt["in_arc_idx"].tolist() == [tt["plan"]["EMPTY_PAD"]]
    dt = tdf.device_tables(tt, "cpu")
    x, prof = _inputs(tt, 4, 12, K, seed=K)
    x["feed_len"][:, 0] = [0, 5, 12, 3]
    x["ptr"][:, 0] = [0, 1, 11, 0]
    want = _jax_block(jt, x, prof, K)
    for chunk, mis in STAGINGS:
        got = _replay(dt, x, prof, K, chunk, mis)
        _assert_equal(got, want, ("no_input", K, chunk, mis))
    assert int(np.asarray(want[2])[3, 0]) > 0         # the pad row moved


def test_two_phase_order_above_the_warp_size():
    """A random fabric too large for the warp variant (the CTA-wide
    kernel runs it), against Pallas."""
    jg, tg = _pair(random_graph(3, nodes=150))
    assert tdf.block_variant(tdf.block_plan_arrays(tg)) == "cta"
    _hold(jg, tg, False, True, (1, 20), B=3, L=40,
          stagings=((CHUNK, 2), (8, 0)), single=False)


def _reverse_fabrics():
    out = [(n, tlib.BENCHES[n]().graph) for n in BENCHES]
    out += [(f"random{s}", random_graph(s)) for s in range(8)]
    return out + [("no_input", _const_fabric()),
                  ("large", random_graph(3, nodes=150))]


@pytest.mark.parametrize("optimize", [False, True])
def test_reverse_maps_cover_every_arc_and_row_once(optimize):
    for name, g in _reverse_fabrics():
        dt = tdf.device_tables(tdf.block_plan_arrays(g, optimize=optimize),
                               "cpu")
        A2 = dt["prod_node"].shape[0]
        for tag, idx in (("feed", dt["in_arc_idx"]),
                         ("out", dt["out_arc_idx"])):
            ptr = dt[f"{tag}_ptr"].numpy()
            rows = dt[f"{tag}_rows"].numpy()
            assert ptr.shape == (A2 + 1,) and ptr[0] == 0, (name, tag)
            assert (np.diff(ptr) >= 0).all(), (name, tag)
            assert ptr[-1] == rows.size == idx.numel(), (name, tag)
            assert sorted(rows.tolist()) == list(range(rows.size)), (name,
                                                                     tag)
            arc_of = np.repeat(np.arange(A2), np.diff(ptr))
            np.testing.assert_array_equal(idx.numpy()[rows], arc_of,
                                          err_msg=f"{name} {tag}")
            assert dt[f"{tag}_rows"].dtype == torch.int32


def test_block_variant_by_size():
    for name in BENCHES:
        tables = tdf.block_plan_arrays(tlib.BENCHES[name]().graph)
        assert tdf.block_variant(tables) == "warp", name
        assert tdf.device_tables(tables, "cpu").variant == "warp"
    big = tdf.block_plan_arrays(random_graph(0, nodes=150))
    assert max(len(big["prod_node"]), len(big["opcode"])) > tdf.WARP_ROWS
    assert tdf.device_tables(big, "cpu").variant == "cta"
    # an input arc strobed by two feed rows cannot sit on one lane slot
    dup = dict(tdf.block_plan_arrays(tlib.BENCHES["fir"]().graph))
    dup["in_arc_idx"] = dup["in_arc_idx"].copy()
    dup["in_arc_idx"][1] = dup["in_arc_idx"][0]
    assert tdf.block_variant(dup) == "cta"


@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 5, 63, 64, 65])
def test_window_holds_a_chunk_at_any_alignment(chunk):
    """A staged row holds the chunk's tokens whatever the start's offset
    from a 16-byte boundary, in whole 16-byte pieces."""
    w = tdf.window_ints(chunk)
    assert w % 4 == 0
    for first in range(4):                  # ints past the boundary
        assert first + chunk <= w


def test_launch_plan_fits_the_card():
    """The chunk is the block's K up to STAGE_CYCLES, halved until a CTA
    fits the card's shared memory; the warp variant packs up to
    MAX_STREAMS streams while two CTAs fit an SM."""
    def smem(N2, A2, n_in, prof, code, window):     # bytes per CTA
        return 8 * (A2 + N2) + 4 * n_in * window

    chunk, window, streams = tdf.launch_plan("warp", 64, 129, 64, 1024, 64,
                                             False, smem, 227 * 1024)
    assert (chunk, window) == (64, tdf.window_ints(64))
    assert streams == tdf.MAX_STREAMS
    assert tdf.launch_plan("warp", 64, 129, 64, 3, 9, False, smem,
                           227 * 1024)[::2] == (9, 3)
    limit = smem(64, 129, 64, False, 0, tdf.window_ints(16))
    chunk, window, streams = tdf.launch_plan("cta", 64, 129, 64, 8, 64,
                                             False, smem, limit)
    assert chunk == 16 and smem(64, 129, 64, False, 1, window) <= limit
    assert streams == 1
    with pytest.raises(ValueError, match="shared memory"):
        tdf.launch_plan("cta", 64, 129, 64, 8, 64, False, smem, 100)
