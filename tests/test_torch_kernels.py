"""Port vs JAX package: fabric plans, the fire rule and the fire block,
dense and opcode-class-specialized (``optimize=True``).

The same inputs, made with numpy from a seed, go through the JAX
function and the port's counterpart; every result must match bit for
bit.  The JAX Pallas kernels run in interpret mode (as
tests/test_engine_blocks.py runs them on the CPU) or through their jnp
mirror in ``repro.kernels.ref``; the port runs its plain PyTorch
versions, which its kernel wrappers take for CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import asm as jasm  # noqa: E402
from repro.core import library as jlib  # noqa: E402
from repro.core.engine import _plan_build as j_plan_build  # noqa: E402
from repro.core.graph import ARITY, Graph, Op  # noqa: E402
from repro.kernels import dataflow_fire as jdf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import asm as tasm  # noqa: E402
from repro_torch.core import library as tlib  # noqa: E402
from repro_torch.core.engine import _plan  # noqa: E402
from repro_torch.core.engine import _plan_build as t_plan_build  # noqa: E402
from repro_torch.kernels import dataflow_fire as tdf  # noqa: E402
from repro_torch.testing import (EDGE_VALS, STATE_KEYS,  # noqa: E402
                                 random_block_inputs)
from repro_torch.testing import random_graph as port_random_graph  # noqa: E402

# the seven hand-assembled benches, bubble_sort at two sizes
BENCH_CASES = [("fibonacci", ()), ("vector_sum", ()), ("max_vector", ()),
               ("dot_prod", ()), ("bubble_sort", (6,)), ("bubble_sort", (8,)),
               ("pop_count", ()), ("fir", ())]


def _graphs(name, args=()):
    builder = {"dot_prod": "dot_product_graph",
               "bubble_sort": "bubble_sort_graph"}.get(name)
    if builder is None:
        return jlib.BENCHES[name]().graph, tlib.BENCHES[name]().graph
    return (getattr(jlib, builder)(*args).graph,
            getattr(tlib, builder)(*args).graph)


# ---------------------------------------------------------------------------
# random well-formed graphs: a copy of the generator of
# tests/test_fuzz_differential.py (builds JAX-package graphs)
# ---------------------------------------------------------------------------
FUZZ_EDGE_VALS = np.asarray(
    [-(2 ** 31), -(2 ** 31) + 1, -40, -2, -1, 0, 1, 2, 3, 5,
     31, 32, 40, 2 ** 31 - 1], np.int64)
ALL_OPS = list(Op)


def random_graph(seed: int) -> Graph:
    """Acyclic by construction: node inputs only consume arcs that
    already exist (open producer outputs, fresh environment streams,
    or const buses)."""
    rng = np.random.default_rng(1000 + seed)
    g = Graph(name=f"fuzz{seed}")
    open_arcs: list[str] = []
    counters = {"a": 0, "x": 0, "c": 0}

    def fresh(tag):
        counters[tag] += 1
        return f"{tag}{counters[tag]}"

    def const_arc():
        arc = fresh("c")
        g.const(arc, int(rng.choice(FUZZ_EDGE_VALS)))
        return arc

    def src(force_env=False):
        r = rng.random()
        if force_env:
            return fresh("x")
        if open_arcs and r < 0.55:
            return open_arcs.pop(int(rng.integers(len(open_arcs))))
        if r < 0.75:
            return const_arc()
        return fresh("x")

    n_nodes = int(rng.integers(4, 11))
    for i in range(n_nodes):
        op = ALL_OPS[seed % len(ALL_OPS)] if i == 0 \
            else ALL_OPS[int(rng.integers(len(ALL_OPS)))]
        n_in, n_out = ARITY[op]
        ins = [src(force_env=(i == 0 and k == 0)) for k in range(n_in)]
        outs = [fresh("a") for _ in range(n_out)]
        g.add(op, ins, outs)
        open_arcs.extend(outs)
    if not open_arcs:        # keep at least one drained output bus
        g.add(Op.ADD, [fresh("x"), const_arc()], ["z_out"])
    g.validate()
    return g


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,args", BENCH_CASES)
def test_plans_and_asm_match(name, args):
    jg, tg = _graphs(name, args)
    text = jasm.emit(jg)
    assert tasm.emit(tg) == text
    assert tasm.emit(convert.graph_from_asm(text)) == text
    jp, tp = j_plan_build(jg), t_plan_build(tg)
    for k, v in tp.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, jp[k]), k
        else:
            assert v == jp[k], k
    jt, tt = jdf.block_plan_arrays(jg), tdf.block_plan_arrays(tg)
    for k in tdf.TABLE_KEYS:
        assert tt[k].dtype == np.int32
        assert np.array_equal(tt[k], jt[k]), k


# ---------------------------------------------------------------------------
# the fire rule
# ---------------------------------------------------------------------------
_j_rule = jax.jit(jdf._ready_and_z)


def _rule_both(opcode, in_idx, out_idx, full, val):
    want = _j_rule(jnp.asarray(opcode), jnp.asarray(in_idx),
                   jnp.asarray(out_idx), jnp.asarray(full), jnp.asarray(val))
    got = tdf._ready_and_z(torch.tensor(opcode), torch.tensor(in_idx).long(),
                           torch.tensor(out_idx).long(), torch.tensor(full),
                           torch.tensor(val))
    for part, g, w in zip(("ready", "z", "consume", "produce"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=part)


@pytest.mark.parametrize("operands", ["random", "edge"])
def test_fire_rule_every_opcode(operands):
    """Random register states over a synthetic node table in which every
    opcode appears many times, reading random arcs."""
    rng = np.random.default_rng(0 if operands == "random" else 1)
    N, A2 = 23 * 16, 96
    opcode = np.tile(np.arange(len(Op), dtype=np.int32), 16)
    in_idx = rng.integers(0, A2, (N, 3)).astype(np.int32)
    out_idx = rng.integers(0, A2, (N, 2)).astype(np.int32)
    for _ in range(4):
        full = rng.integers(0, 2, A2).astype(np.int32)
        if operands == "edge":
            val = rng.choice(EDGE_VALS, A2).astype(np.int32)
        else:
            val = rng.integers(-2 ** 31, 2 ** 31, A2).astype(np.int32)
        _rule_both(opcode, in_idx, out_idx, full, val)


def test_fire_rule_edge_operand_pairs():
    """Every ALU opcode on every (a, b) pair of edge operands."""
    a, b = np.meshgrid(EDGE_VALS, EDGE_VALS)
    pairs = a.size
    A2 = 2 * pairs + 2
    val = np.concatenate([a.ravel(), b.ravel(), [0, 0]]).astype(np.int32)
    full = np.ones(A2, np.int32)
    full[-1] = 0                                 # an empty output slot
    rows = np.arange(pairs)
    in_idx = np.stack([rows, pairs + rows, np.full(pairs, A2 - 2)], 1)
    out_idx = np.full((pairs, 2), A2 - 1)
    for op in Op:
        _rule_both(np.full(pairs, int(op), np.int32),
                   in_idx.astype(np.int32), out_idx.astype(np.int32),
                   full, val)


@pytest.mark.parametrize("seed", range(4))
def test_fire_rule_random_graphs(seed):
    """The rule over random well-formed graphs' tables (the fuzz
    generator), on random states with edge operands."""
    jg = random_graph(seed)
    tg = convert.graph_from_asm(jasm.emit(jg))
    tables = tdf.block_plan_arrays(tg)
    rng = np.random.default_rng(seed)
    x = random_block_inputs(tables, 4, 2, rng)
    for b in range(4):
        _rule_both(tables["opcode"], tables["in_idx"], tables["out_idx"],
                   x["full"][b], x["val"][b])


# ---------------------------------------------------------------------------
# the fire block
# ---------------------------------------------------------------------------
def _block_inputs(name, K, B=3, L=6):
    jg, tg = _graphs(name, (6,) if name == "bubble_sort" else ())
    jt, tt = jdf.block_plan_arrays(jg), tdf.block_plan_arrays(tg)
    x = random_block_inputs(tt, B, L, np.random.default_rng(K))
    x["active"][:] = 1
    x["active"][1] = 0                          # one parked slot
    return jt, tt, x


def _assert_block_equal(got, want):
    names = (*STATE_KEYS, "fired", "last_prog")
    assert len(got) == len(want) == 7
    for k, g, w in zip(names, got, want):
        # fired/last_prog: [1] / [B, 1] here, () / [B] in the jnp mirror
        np.testing.assert_array_equal(g.numpy().reshape(np.shape(w)),
                                      np.asarray(w), err_msg=k)


def _args(x, b=None):
    keys = ("feed_vals", "feed_len", *STATE_KEYS)
    if b is None:
        return [x[k] for k in keys]
    return [x[k][b] for k in keys]


@pytest.mark.parametrize("name", ["fibonacci", "pop_count", "bubble_sort"])
@pytest.mark.parametrize("K", [1, 4, 16])
def test_block_matches_pallas_interpret(name, K):
    jt, tt, x = _block_inputs(name, K)
    t = {k: torch.tensor(v) for k, v in x.items()}
    want = jdf.fire_block_batched_pallas(
        jt, *(jnp.asarray(v) for v in _args(x)), n_cycles=K,
        active=jnp.asarray(x["active"]), interpret=True)
    got = tdf.fire_block_batched_cuda(tt, *_args(t), n_cycles=K,
                                      active=t["active"])
    _assert_block_equal(got, want)
    want = jdf.fire_block_pallas(
        jt, *(jnp.asarray(v) for v in _args(x, 0)), n_cycles=K,
        interpret=True)
    got = tdf.fire_block_cuda(tt, *_args(t, 0), n_cycles=K)
    _assert_block_equal(got, want)


@pytest.mark.parametrize("name",
                         ["vector_sum", "max_vector", "dot_prod", "fir"])
@pytest.mark.parametrize("K", [1, 16])
def test_block_matches_jnp_ref(name, K):
    jt, tt, x = _block_inputs(name, K)
    t = {k: torch.tensor(v) for k, v in x.items()}
    step = jax.jit(jax.vmap(lambda *a: jref.fire_block_masked_ref(
        jt, *a, n_cycles=K)))
    want = step(*(jnp.asarray(v) for v in _args(x)),
                jnp.asarray(x["active"]))
    got = tdf.fire_block_batched(tt, *_args(t), n_cycles=K,
                                 active=t["active"])
    _assert_block_equal(got, want)
    want = jref.fire_block_ref(jt, *(jnp.asarray(v) for v in _args(x, 0)),
                               n_cycles=K)
    _assert_block_equal(tdf.fire_block(tt, *_args(t, 0), n_cycles=K), want)


# ---------------------------------------------------------------------------
# optimized plans: arcs in role order, nodes bucketed by opcode
# ---------------------------------------------------------------------------
def _random_pair(seed):
    """A random fabric in the JAX package and the same one in the port
    (sent across as asm text)."""
    tg = port_random_graph(seed)
    return jasm.parse(tasm.emit(tg), name=tg.name), tg


def _assert_plans_equal(jg, tg):
    jp, tp = j_plan_build(jg, optimize=True), t_plan_build(tg, optimize=True)
    assert set(tp) == set(jp)
    for k, v in tp.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == jp[k].dtype, k
            assert np.array_equal(v, jp[k]), k
        else:
            assert v == jp[k], k
    jt = jdf.block_plan_arrays(jg, optimize=True)
    tt = tdf.block_plan_arrays(tg, optimize=True)
    for k in tdf.TABLE_KEYS:
        assert tt[k].dtype == np.int32
        assert np.array_equal(tt[k], jt[k]), k
    assert tt["class_slices"] == jt["class_slices"]
    return tt


@pytest.mark.parametrize("name,args", BENCH_CASES)
def test_optimized_plans_match(name, args):
    jg, tg = _graphs(name, args)
    tt = _assert_plans_equal(jg, tg)
    # the trailing one-row bucket of the dummy node, as in the JAX tables
    assert tt["class_slices"][-1] == (int(Op.SINK), len(tg.nodes),
                                      len(tg.nodes) + 1)
    assert tdf.device_tables(tt, "cpu").class_slices == tt["class_slices"]


@pytest.mark.parametrize("seed", range(8))
def test_optimized_plans_match_random_graphs(seed):
    _assert_plans_equal(*_random_pair(seed))


def test_plan_memo_keys_on_optimize():
    g = tlib.fibonacci_graph().graph
    dense, spec = _plan(g), _plan(g, optimize=True)
    assert dense is _plan(g) and spec is _plan(g, optimize=True)
    assert dense["class_slices"] is None and spec["class_slices"]
    assert not np.array_equal(dense["opcode"], spec["opcode"])


def test_device_tables_check_the_class_table():
    tt = tdf.block_plan_arrays(tlib.fibonacci_graph().graph, optimize=True)
    cs = tt["class_slices"]
    bad = [cs[1:],                                  # rows 0.. uncovered
           cs[:-1],                                 # dummy row uncovered
           ((cs[0][0], 0, cs[0][2] + 1), *cs[1:]),  # overlaps the next
           ((cs[1][0], *cs[0][1:]), *cs[1:])]       # wrong opcode
    for c in bad:
        with pytest.raises(ValueError):
            tdf.device_tables(dict(tt, class_slices=c), "cpu")
    dt = tdf.device_tables(tt, "cpu")
    assert not dt.control_free                      # fibonacci has control
    assert tdf.device_tables(tdf.block_plan_arrays(
        tlib.dot_product_graph(4).graph, optimize=True), "cpu").control_free


# ---------------------------------------------------------------------------
# the specialized fire rule
# ---------------------------------------------------------------------------
_j_spec = jax.jit(jdf._ready_and_z_spec, static_argnums=0)


def _spec_both(class_slices, in_idx, out_idx, full, val, opcode):
    want = _j_spec(class_slices, jnp.asarray(in_idx), jnp.asarray(out_idx),
                   jnp.asarray(full), jnp.asarray(val))
    t = [torch.tensor(x) for x in (in_idx, out_idx, full, val)]
    got = tdf._ready_and_z_spec(class_slices, t[0].long(), t[1].long(),
                                t[2], t[3])
    dense = tdf._ready_and_z(torch.tensor(opcode), t[0].long(), t[1].long(),
                             t[2], t[3])
    for part, g, w, d in zip(("ready", "z", "consume", "produce"), got, want,
                             dense):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=part)
        np.testing.assert_array_equal(g.numpy(), d.numpy(), err_msg=part)


def _bucketed(ops, per_op):
    opcode = np.repeat(np.asarray([int(o) for o in ops], np.int32), per_op)
    cs = tuple((int(o), k * per_op, (k + 1) * per_op)
               for k, o in enumerate(ops))
    return opcode, cs


@pytest.mark.parametrize("control", [True, False])
def test_spec_rule_edge_operands(control):
    """A bucketed table of every opcode (or every control-free one),
    random registers holding edge operands."""
    ops = [o for o in Op if control or int(o) not in tdf._CTRL_OPS]
    opcode, cs = _bucketed(ops, 12)
    rng = np.random.default_rng(int(control))
    N, A2 = opcode.shape[0], 80
    in_idx = rng.integers(0, A2, (N, 3)).astype(np.int32)
    out_idx = rng.integers(0, A2, (N, 2)).astype(np.int32)
    for _ in range(4):
        full = rng.integers(0, 2, A2).astype(np.int32)
        val = rng.choice(EDGE_VALS, A2).astype(np.int32)
        _spec_both(cs, in_idx, out_idx, full, val, opcode)


def test_spec_rule_every_edge_operand_pair():
    """Every ALU opcode, as its own bucket, on every (a, b) pair of edge
    operands."""
    a, b = np.meshgrid(EDGE_VALS, EDGE_VALS)
    pairs = a.size
    ops = [o for o in Op if int(o) not in tdf._CTRL_OPS]
    opcode, cs = _bucketed(ops, pairs)
    A2 = 2 * pairs + 2
    val = np.concatenate([a.ravel(), b.ravel(), [0, 0]]).astype(np.int32)
    full = np.ones(A2, np.int32)
    full[-1] = 0                                 # an empty output slot
    rows = np.tile(np.arange(pairs), len(ops))
    in_idx = np.stack([rows, pairs + rows, np.full(rows.size, A2 - 2)], 1)
    out_idx = np.full((rows.size, 2), A2 - 1)
    _spec_both(cs, in_idx.astype(np.int32), out_idx.astype(np.int32), full,
               val, opcode)


@pytest.mark.parametrize("seed", range(4))
def test_spec_rule_random_graphs(seed):
    """The rule over random fabrics' optimized tables (control operators
    included), on random states with edge operands."""
    tt = tdf.block_plan_arrays(port_random_graph(seed), optimize=True)
    x = random_block_inputs(tt, 4, 2, np.random.default_rng(seed))
    for b in range(4):
        _spec_both(tt["class_slices"], tt["in_idx"], tt["out_idx"],
                   x["full"][b], x["val"][b], tt["opcode"])


# ---------------------------------------------------------------------------
# the fire block over optimized tables (the spec instantiation)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,K", [("fibonacci", 4), ("fir", 16)])
def test_spec_block_matches_pallas_interpret(name, K):
    jg, tg = _graphs(name)
    jt = jdf.block_plan_arrays(jg, optimize=True)
    tt = tdf.device_tables(tdf.block_plan_arrays(tg, optimize=True), "cpu")
    x = random_block_inputs(tdf.block_plan_arrays(tg, optimize=True), 3, 6,
                            np.random.default_rng(K))
    x["active"][:] = 1
    x["active"][1] = 0                          # one parked slot
    t = {k: torch.tensor(v) for k, v in x.items()}
    want = jdf.fire_block_batched_pallas(
        jt, *(jnp.asarray(v) for v in _args(x)), n_cycles=K,
        active=jnp.asarray(x["active"]), interpret=True)
    got = tdf.fire_block_batched_cuda(tt, *_args(t), n_cycles=K,
                                      active=t["active"])
    dense = tdf.fire_block_batched(
        tdf.block_plan_arrays(tg, optimize=True) | {"class_slices": None},
        *_args(t), n_cycles=K, active=t["active"])
    for g, w, d in zip(got, want, dense):
        np.testing.assert_array_equal(g.numpy().reshape(np.shape(w)),
                                      np.asarray(w))
        assert torch.equal(g, d)
