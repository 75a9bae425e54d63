"""The paper's benchmark suite as static dataflow graphs.

Fibonacci, Max (vector), Dot product, Vector sum, Bubble sort, Pop count
(paper §4) and a constant-coefficient FIR filter, hand-assembled node by
node.  Fibonacci uses the paper's cyclic loop schema (Listing 1 /
Fig. 7): ndmerge initializes loop registers, a `gtdecider` (IFGT)
produces the loop condition, `branch` nodes gate the feedback arcs.  The
vector benches are *unrolled spatial fabrics* — trees of primitive
operators — which is how a dataflow FPGA extracts the parallelism the
paper's conclusion calls for.

Every builder returns ``Bench(graph, make_feeds, reference, out_arc)``.
The graphs are node-for-node the JAX package's, so both packages emit
the same assembler text for each bench.

The ``*_traced`` / ``horner`` / ``saxpy`` / ``relu_chain`` entries and
the loop benches (``gcd``, ``fib``, ``newton_sqrt``, ``horner_loop``)
are *synthesized* fabrics: ordinary torch programs lowered through the
:mod:`repro_torch.front` tracing frontend (the paper's algorithm-to-graph
toolchain step) instead of hand-assembled node tables.  Each keeps the
JAX package's name, program and numpy reference, and its ``program``
field holds what ``compile_fn`` / ``DataflowServer.for_fn`` take to
trace it again.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.graph import Graph, Op


@dataclasses.dataclass
class Bench:
    graph: Graph
    make_feeds: Callable[..., dict]
    reference: Callable[..., np.ndarray]
    out_arc: str
    out_arcs: list | None = None  # multi-output fabrics (bubble sort)
    streaming: bool = True  # DAG fabrics accept token streams
    dtype: object = np.int32  # execution dtype (newton_sqrt is float32;
    #                           "cuda" and the slot API are int32-only)
    program: tuple | None = None  # traced benches: (fn, avals, trace kw)


def _fanout(g: Graph, src: str, k: int, prefix: str) -> list[str]:
    """Copy tree: one arc -> k arcs (COPY duplicates to exactly two)."""
    if k == 1:
        return [src]
    outs = [f"{prefix}_l", f"{prefix}_r"]
    g.add(Op.COPY, [src], outs)
    left = _fanout(g, outs[0], (k + 1) // 2, prefix + "l")
    right = _fanout(g, outs[1], k // 2, prefix + "r")
    return left + right


def _reduce_tree(g: Graph, arcs: list[str], op: Op, prefix: str,
                 final: str | None = None) -> str:
    """Binary tree of 2-in primitives over the given arcs."""
    level = 0
    while len(arcs) > 1:
        nxt = []
        for i in range(0, len(arcs) - 1, 2):
            last = len(arcs) <= 2 and final is not None
            out = final if last else f"{prefix}_{level}_{i // 2}"
            g.add(op, [arcs[i], arcs[i + 1]], [out])
            nxt.append(out)
        if len(arcs) % 2:
            nxt.append(arcs[-1])
        arcs = nxt
        level += 1
    return arcs[0]


# ---------------------------------------------------------------------------
# Fibonacci (cyclic — the paper's flagship example)
# ---------------------------------------------------------------------------
def fibonacci_graph() -> Bench:
    """Paper Algorithm 1: n iterations of (first, second) <- (second,
    first+second) from (0, 1); `fibo` is the exit value of the running sum
    and `pf` the final loop index (as in Listing 1's two outputs)."""
    g = Graph(name="fibonacci")
    g.const("one", 1)            # the paper's sticky increment bus (dadoe)
    # --- loop counter (left half of Fig. 7) ---
    g.add(Op.NDMERGE, ["i_fb", "i_init"], ["i"])
    g.add(Op.COPY, ["i"], ["i_c", "i_d"])
    g.add(Op.IFGT, ["n_in", "i_c"], ["cond"])      # gtdecider: n > i
    g.add(Op.COPY, ["cond"], ["cond_i", "cond_fib"])
    g.add(Op.COPY, ["cond_fib"], ["cond_f", "cond_s"])
    g.add(Op.BRANCH, ["i_d", "cond_i"], ["i_live", "pf"])
    g.add(Op.ADD, ["i_live", "one"], ["i_fb"])
    # --- fibonacci registers (right half of Fig. 7) ---
    g.add(Op.NDMERGE, ["f_fb", "f_init"], ["first"])
    g.add(Op.NDMERGE, ["s_fb", "s_init"], ["second"])
    g.add(Op.COPY, ["second"], ["sec_a", "sec_b"])
    g.add(Op.ADD, ["first", "sec_a"], ["tmp"])
    g.add(Op.BRANCH, ["sec_b", "cond_f"], ["f_fb", "sec_exit"])
    g.add(Op.BRANCH, ["tmp", "cond_s"], ["s_fb", "fibo"])
    g.add(Op.SINK, ["sec_exit"], [])
    g.validate()
    # `n_in` needs a token every iteration: the environment feeds a
    # stream of n+1 copies (one per decider firing)

    def make_feeds(n: int) -> dict:
        return {
            "n_in": np.full((n + 1,), n, np.int32),
            "i_init": np.array([0]),
            "f_init": np.array([0]),
            "s_init": np.array([1]),
        }

    def reference(n: int):
        first, second = 0, 1
        for _ in range(n):
            first, second = second, first + second
        return np.asarray(first + second)   # tmp routed out on exit

    return Bench(g, make_feeds, reference, "fibo")


FIBONACCI_ASM = """\
# Fibonacci dataflow fabric (Listing-1 syntax; clean reconstruction)
const one = 1;
1.  ndmerge i_fb, i_init, i;
2.  copy i, i_c, i_d;
3.  gtdecider n_in, i_c, cond;
4.  copy cond, cond_i, cond_fib;
5.  copy cond_fib, cond_f, cond_s;
6.  branch i_d, cond_i, i_live, pf;
7.  add i_live, one, i_fb;
8.  ndmerge f_fb, f_init, first;
9.  ndmerge s_fb, s_init, second;
10. copy second, sec_a, sec_b;
11. add first, sec_a, tmp;
12. branch sec_b, cond_f, f_fb, sec_exit;
13. branch tmp, cond_s, s_fb, fibo;
14. sink sec_exit;
"""


# ---------------------------------------------------------------------------
# Vector fabrics (DAGs)
# ---------------------------------------------------------------------------
def vector_sum_graph(n: int = 32) -> Bench:
    g = Graph(name=f"vector_sum_{n}")
    ins = [f"v{i}" for i in range(n)]
    _reduce_tree(g, list(ins), Op.ADD, "s", final="vsum")
    g.validate()

    def make_feeds(v):  # v: [k, n] stream of k vectors
        v = np.atleast_2d(np.asarray(v))
        return {f"v{i}": v[:, i] for i in range(n)}

    return Bench(g, make_feeds,
                 lambda v: np.atleast_2d(np.asarray(v)).sum(axis=1),
                 "vsum")


def max_vector_graph(n: int = 32) -> Bench:
    g = Graph(name=f"max_{n}")
    ins = [f"v{i}" for i in range(n)]
    _reduce_tree(g, list(ins), Op.MAX, "m", final="vmax")
    g.validate()

    def make_feeds(v):
        v = np.atleast_2d(np.asarray(v))
        return {f"v{i}": v[:, i] for i in range(n)}

    return Bench(g, make_feeds,
                 lambda v: np.atleast_2d(np.asarray(v)).max(axis=1),
                 "vmax")


def dot_product_graph(n: int = 32) -> Bench:
    g = Graph(name=f"dot_prod_{n}")
    prods = []
    for i in range(n):
        g.add(Op.MUL, [f"a{i}", f"b{i}"], [f"p{i}"])
        prods.append(f"p{i}")
    _reduce_tree(g, prods, Op.ADD, "d", final="dot")
    g.validate()

    def make_feeds(a, b):
        a, b = np.atleast_2d(np.asarray(a)), np.atleast_2d(np.asarray(b))
        f = {f"a{i}": a[:, i] for i in range(n)}
        f.update({f"b{i}": b[:, i] for i in range(n)})
        return f

    return Bench(g, make_feeds,
                 lambda a, b: (np.atleast_2d(a) * np.atleast_2d(b))
                 .sum(axis=1), "dot")


def bubble_sort_graph(n: int = 8) -> Bench:
    """Bubble-sort compare-exchange network (the spatially-unrolled form
    of the paper's bubble sort: each CE = copy×2 + min + max)."""
    g = Graph(name=f"bubble_sort_{n}")
    cur = [f"x{i}" for i in range(n)]
    step = 0
    for i in range(n):
        for j in range(n - 1 - i):
            x, y = cur[j], cur[j + 1]
            xa, xb = f"ce{step}_xa", f"ce{step}_xb"
            ya, yb = f"ce{step}_ya", f"ce{step}_yb"
            g.add(Op.COPY, [x], [xa, xb])
            g.add(Op.COPY, [y], [ya, yb])
            lo, hi = f"ce{step}_lo", f"ce{step}_hi"
            g.add(Op.MIN, [xa, ya], [lo])
            g.add(Op.MAX, [xb, yb], [hi])
            cur[j], cur[j + 1] = lo, hi
            step += 1
    g.validate()

    def make_feeds(v):
        v = np.atleast_2d(np.asarray(v))
        return {f"x{i}": v[:, i] for i in range(n)}

    def reference(v):
        return np.sort(np.atleast_2d(np.asarray(v)), axis=1)

    return Bench(g, make_feeds, reference, cur[0], out_arcs=list(cur))


def popcount_graph(bits: int = 16) -> Bench:
    """Population count of a `bits`-wide word: shift/mask/add fabric."""
    g = Graph(name=f"pop_count_{bits}")
    g.const("c_one", 1)
    xs = _fanout(g, "x", bits, "px")
    terms = []
    for k in range(bits):
        g.const(f"sh{k}", k)
        g.add(Op.SHR, [xs[k], f"sh{k}"], [f"sr{k}"])
        g.add(Op.AND, [f"sr{k}", "c_one"], [f"bit{k}"])
        terms.append(f"bit{k}")
    _reduce_tree(g, terms, Op.ADD, "pc", final="popc")
    g.validate()

    def make_feeds(x):
        x = np.atleast_1d(np.asarray(x))
        return {"x": x}

    def reference(x):
        x = np.atleast_1d(np.asarray(x)).astype(np.int32)
        return np.array([bin(int(v) & ((1 << bits) - 1)).count("1")
                         for v in x])

    return Bench(g, make_feeds, reference, "popc")


def fir_filter_graph(taps: int = 8) -> Bench:
    """Paper-style constant-coefficient FIR filter
    ``y[t] = sum_k c_k * x[t-k]``: one MUL-by-const per tap feeding an
    ADD reduce tree.  The host supplies the tapped delay line
    (``make_feeds`` windows the signal, one stream per tap), so the
    fabric is a pure streaming DAG like the other vector benches."""
    coeffs = [((3 * k) % 7) + 1 for k in range(taps)]   # 1..7, c0 == 1
    g = Graph(name=f"fir_{taps}")
    terms = []
    for k in range(taps):
        g.const(f"c{k}", coeffs[k])
        g.add(Op.MUL, [f"x{k}", f"c{k}"], [f"t{k}"])
        terms.append(f"t{k}")
    _reduce_tree(g, terms, Op.ADD, "y", final="fir")
    g.validate()

    def make_feeds(x):
        """x: raw signal of length T >= taps; emits T - taps + 1 output
        tokens (tap k sees the signal delayed by k)."""
        x = np.atleast_1d(np.asarray(x))
        if x.shape[0] < taps:
            raise ValueError(
                f"fir_{taps} needs a signal of at least {taps} samples, "
                f"got {x.shape[0]}")
        T = x.shape[0] - taps + 1
        return {f"x{k}": x[taps - 1 - k: taps - 1 - k + T]
                for k in range(taps)}

    def reference(x):
        x = np.atleast_1d(np.asarray(x)).astype(np.int64)
        return np.convolve(x, np.asarray(coeffs), "valid").astype(np.int64)

    return Bench(g, make_feeds, reference, "fir")


# ---------------------------------------------------------------------------
# Traced fabrics (synthesized by the repro_torch.front frontend)
# ---------------------------------------------------------------------------
# Three regenerate hand-assembled benches above from plain Python (the
# paper's algorithm->graph toolchain step), three are traced-only
# workloads no one hand-assembled.  The frontend import is deferred into
# each builder: front depends on this module's fan-out / reduce-tree
# helpers.

def _traced(fn, *avals, **kw):
    from repro_torch.front import trace
    return trace(fn, *avals, **kw), (fn, avals, kw)


def traced_dot_product_graph(n: int = 32) -> Bench:
    """dot_product_graph regenerated from traced Python: the same
    multiply-accumulate math written as an ordinary expression (a
    left-fold chain rather than the hand-built reduce tree — same
    values bit-for-bit in integer arithmetic)."""
    def dot(*ab):
        a, b = ab[:n], ab[n:]
        acc = a[0] * b[0]
        for i in range(1, n):
            acc = acc + a[i] * b[i]
        return acc

    prog, program = _traced(dot, *([np.int32] * (2 * n)),
                            name=f"dot_prod_traced_{n}")

    def make_feeds(a, b):
        a = np.atleast_2d(np.asarray(a))
        b = np.atleast_2d(np.asarray(b))
        return prog.make_feeds(*(a[:, i] for i in range(n)),
                               *(b[:, i] for i in range(n)))

    return Bench(prog, make_feeds,
                 lambda a, b: (np.atleast_2d(a) * np.atleast_2d(b))
                 .sum(axis=1), prog.out_arc, program=program)


def traced_popcount_graph(bits: int = 16) -> Bench:
    """popcount_graph regenerated from traced Python: shift/mask/add
    over the word's bits, exactly the paper's pop-count fabric but
    synthesized from the expression (the ``x >> 0`` tap is a no-op the
    identity-elimination pass splices out, like fir's c0)."""
    def popc(x):
        acc = (x >> 0) & 1
        for k in range(1, bits):
            acc = acc + ((x >> k) & 1)
        return acc

    prog, program = _traced(popc, np.int32, name=f"pop_count_traced_{bits}")

    def make_feeds(x):
        return prog.make_feeds(np.atleast_1d(np.asarray(x)))

    def reference(x):
        x = np.atleast_1d(np.asarray(x)).astype(np.int32)
        return np.array([bin(int(v) & ((1 << bits) - 1)).count("1")
                         for v in x])

    return Bench(prog, make_feeds, reference, prog.out_arc, program=program)


def traced_fir_graph(taps: int = 8) -> Bench:
    """fir_filter_graph regenerated from traced Python with the
    coefficients bound as sticky const buses (``trace(const_args=...)``
    — the paper's persistently-presented input buses), so the fabric
    carries the same MUL-by-const taps as the hand-built bench."""
    coeffs = [((3 * k) % 7) + 1 for k in range(taps)]   # same as fir

    def fir(*args):
        xs, cs = args[:taps], args[taps:]
        acc = xs[0] * cs[0]
        for k in range(1, taps):
            acc = acc + xs[k] * cs[k]
        return acc

    prog, program = _traced(
        fir, *([np.int32] * (2 * taps)), name=f"fir_traced_{taps}",
        const_args={taps + k: c for k, c in enumerate(coeffs)})

    def make_feeds(x):
        x = np.atleast_1d(np.asarray(x))
        if x.shape[0] < taps:
            raise ValueError(
                f"fir_traced_{taps} needs a signal of at least {taps} "
                f"samples, got {x.shape[0]}")
        T = x.shape[0] - taps + 1
        return prog.make_feeds(*(x[taps - 1 - k: taps - 1 - k + T]
                                 for k in range(taps)))

    def reference(x):
        x = np.atleast_1d(np.asarray(x)).astype(np.int64)
        return np.convolve(x, np.asarray(coeffs), "valid").astype(np.int64)

    return Bench(prog, make_feeds, reference, prog.out_arc, program=program)


def horner_graph(degree: int = 5) -> Bench:
    """Traced-only bench: Horner evaluation of a fixed int polynomial,
    ``(((c0 x + c1) x + c2) ...)`` — a deep multiply-add chain that
    pipelines through the fabric one token per wave."""
    coeffs = [((2 * k + 1) % 9) - 4 for k in range(degree + 1)]

    def horner(x):
        acc = coeffs[0] * x + coeffs[1]
        for c in coeffs[2:]:
            acc = acc * x + c
        return acc

    prog, program = _traced(horner, np.int32, name=f"horner_{degree}")

    def make_feeds(x):
        return prog.make_feeds(np.atleast_1d(np.asarray(x)))

    def reference(x):
        x = np.atleast_1d(np.asarray(x)).astype(np.int32)
        acc = np.full_like(x, coeffs[0]) * x + np.int32(coeffs[1])
        for c in coeffs[2:]:
            acc = acc * x + np.int32(c)     # int32 wrap, like the fabric
        return acc

    return Bench(prog, make_feeds, reference, prog.out_arc, program=program)


def saxpy_graph(a: int = 3) -> Bench:
    """Traced-only bench: ``a*x + y`` over two token streams."""
    def saxpy(x, y):
        return a * x + y

    prog, program = _traced(saxpy, np.int32, np.int32, name=f"saxpy_{a}")

    def make_feeds(x, y):
        return prog.make_feeds(np.atleast_1d(np.asarray(x)),
                               np.atleast_1d(np.asarray(y)))

    def reference(x, y):
        return (np.int32(a) * np.atleast_1d(np.asarray(x)).astype(np.int32)
                + np.atleast_1d(np.asarray(y)).astype(np.int32))

    return Bench(prog, make_feeds, reference, prog.out_arc, program=program)


def relu_chain_graph() -> Bench:
    """Traced-only bench: clamp/relu chain with a data-dependent
    ``torch.where`` — the select lowering (BRANCH pair + DMERGE) running
    on every backend, including the fire-block kernels."""
    import torch

    def relu_chain(x, y):
        h = torch.clamp(x - y, min=0)               # relu
        h = torch.clamp(h * 2 + 1, max=100)         # clamp
        return torch.where(h > 50, h - 50, h)

    prog, program = _traced(relu_chain, np.int32, np.int32,
                            name="relu_chain")

    def make_feeds(x, y):
        return prog.make_feeds(np.atleast_1d(np.asarray(x)),
                               np.atleast_1d(np.asarray(y)))

    def reference(x, y):
        x = np.atleast_1d(np.asarray(x)).astype(np.int32)
        y = np.atleast_1d(np.asarray(y)).astype(np.int32)
        h = np.minimum(np.maximum(x - y, 0) * 2 + 1, 100)
        return np.where(h > 50, h - 50, h)

    return Bench(prog, make_feeds, reference, prog.out_arc, program=program)


# ---------------------------------------------------------------------------
# Iterative loop fabrics (traced cyclic programs, DESIGN.md §10)
# ---------------------------------------------------------------------------
# The frontend lowers front.while_loop / front.fori_loop onto the
# paper's loop schema — NDMERGE entry per carry, predicate cone,
# BRANCH-steered back edges — so these benches are CYCLIC fabrics with
# data-dependent (gcd, fib) or static (newton_sqrt, horner_loop) trip
# counts.  Loop fabrics initiate once per run: make_feeds takes scalar
# arguments, one result token out.

def gcd_graph() -> Bench:
    """Subtractive Euclid: while a != b, replace the larger by the
    difference — a ``while_loop`` with a data-dependent trip count, the
    acceptance workload of the loop frontend."""
    import torch
    from repro_torch.front import while_loop

    def gcd(a, b):
        def body(c):
            x, y = c
            return (torch.where(x > y, x - y, x),
                    torch.where(x > y, y, y - x))
        return while_loop(lambda c: c[0] != c[1], body, (a, b))[0]

    prog, program = _traced(gcd, np.int32, np.int32, name="gcd")

    def make_feeds(a, b):
        return prog.make_feeds([int(a)], [int(b)])

    def reference(a, b):
        import math
        return np.asarray(math.gcd(int(a), int(b)), np.int32)

    return Bench(prog, make_feeds, reference, prog.out_arc,
                 streaming=False, program=program)


def fib_loop_graph() -> Bench:
    """fibonacci_graph regenerated from traced Python: ``fori_loop``
    with a *traced* bound lowers to a while loop whose bound rides the
    carry ``(i, n, c)``, as JAX's while form of ``fori_loop`` does."""
    from repro_torch.front import fori_loop

    def fib(n):
        return fori_loop(0, n, lambda i, c: (c[1], c[0] + c[1]), (0, 1))[0]

    prog, program = _traced(fib, np.int32, name="fib")

    def make_feeds(n):
        return prog.make_feeds([int(n)])

    def reference(n):
        a, b = np.int32(0), np.int32(1)
        with np.errstate(over="ignore"):
            for _ in range(int(n)):
                a, b = b, np.int32(a + b)   # int32 wrap, like the fabric
        return np.asarray(a, np.int32)

    return Bench(prog, make_feeds, reference, prog.out_arc,
                 streaming=False, program=program)


def newton_sqrt_graph(iters: int = 8) -> Bench:
    """Float Newton iteration ``x <- (x + n/x) / 2`` over a static
    ``fori_loop`` (the counted scan schema): a float32 cyclic fabric
    whose loop-invariant ``n`` rides a synthetic carry and whose body
    uses the float DIV the DAG benches never exercise."""
    from repro_torch.front import fori_loop

    def newton_sqrt(n):
        return fori_loop(0, iters, lambda i, x: 0.5 * (x + n / x),
                         n * 0.5 + 0.5)

    prog, program = _traced(newton_sqrt, np.float32,
                            name=f"newton_sqrt_{iters}")

    def make_feeds(n):
        return prog.make_feeds([float(n)])

    def reference(n):
        n = np.float32(n)
        x = np.float32(n * np.float32(0.5) + np.float32(0.5))
        with np.errstate(all="ignore"):
            for _ in range(iters):
                x = np.float32(0.5) * (x + n / x)
        return np.asarray(x, np.float32)

    return Bench(prog, make_feeds, reference, prog.out_arc,
                 streaming=False, dtype=np.float32, program=program)


def horner_loop_graph(degree: int = 8) -> Bench:
    """horner's rule as an actual LOOP (the spatially-unrolled `horner`
    bench re-rolled): ``acc <- acc*x + 1`` for ``degree`` iterations of
    a static ``fori_loop`` — the x carry is a pure pass-through, which
    the lowering moves into the loop invariants as JAX's scan does."""
    from repro_torch.front import fori_loop

    def horner_loop(x):
        return fori_loop(0, degree, lambda i, c: (c[0] * c[1] + 1, c[1]),
                         (1, x))[0]

    prog, program = _traced(horner_loop, np.int32,
                            name=f"horner_loop_{degree}")

    def make_feeds(x):
        return prog.make_feeds([int(x)])

    def reference(x):
        acc, x = np.int32(1), np.int32(x)
        with np.errstate(over="ignore"):
            for _ in range(degree):
                acc = np.int32(acc * x + 1)  # int32 wrap, like the fabric
        return np.asarray(acc, np.int32)

    return Bench(prog, make_feeds, reference, prog.out_arc,
                 streaming=False, program=program)


# the seven hand-assembled benches (the fabrics the kernels' own tests
# and the card's kernel phases sweep)
HAND_BUILT: dict[str, Callable[[], Bench]] = {
    "fibonacci": fibonacci_graph,
    "vector_sum": vector_sum_graph,
    "max_vector": max_vector_graph,
    "dot_prod": dot_product_graph,
    "bubble_sort": bubble_sort_graph,
    "pop_count": popcount_graph,
    "fir": fir_filter_graph,
}
# synthesized by the repro_torch.front tracing frontend
TRACED: dict[str, Callable[[], Bench]] = {
    "dot_prod_traced": traced_dot_product_graph,
    "pop_count_traced": traced_popcount_graph,
    "fir_traced": traced_fir_graph,
    "horner": horner_graph,
    "saxpy": saxpy_graph,
    "relu_chain": relu_chain_graph,
    # traced CYCLIC programs (loop frontend, DESIGN.md §10)
    "gcd": gcd_graph,
    "fib": fib_loop_graph,
    "newton_sqrt": newton_sqrt_graph,
    "horner_loop": horner_loop_graph,
}
BENCHES: dict[str, Callable[[], Bench]] = {**HAND_BUILT, **TRACED}

# single-shot fabrics: one initiation -> one result token, and `k` in
# random_feeds scales the LOOP TRIP COUNT, not a stream length
SINGLE_SHOT = ("fibonacci", "gcd", "fib", "newton_sqrt", "horner_loop")


def random_feeds(name: str, bench: Bench, k: int, rng=None) -> dict:
    """A k-token random feed-stream dict for any bench (for the
    single-shot loop benches, k scales the trip count).  Draws the same
    numbers from the same generator state as the JAX package's
    ``random_feeds``."""
    rng = np.random.default_rng(rng) if not hasattr(rng, "integers") \
        else rng
    n = len(bench.graph.input_arcs())
    if name in ("fibonacci", "fib"):    # k = loop iteration count
        return bench.make_feeds(int(k))
    if name == "gcd":
        # subtractive gcd of (k+1, b<=k+1) runs O(k) iterations
        return bench.make_feeds(int(k) + 1,
                                int(rng.integers(1, int(k) + 2)))
    if name.startswith("newton_sqrt"):
        return bench.make_feeds(float(rng.uniform(0.25, 100.0)))
    if name.startswith("horner_loop"):
        return bench.make_feeds(int(rng.integers(-4, 5)))
    if name.startswith("dot_prod"):
        return bench.make_feeds(rng.integers(0, 9, (k, n // 2)),
                                rng.integers(0, 9, (k, n // 2)))
    if name.startswith("pop_count"):
        return bench.make_feeds(rng.integers(0, 2 ** 16, (k,)))
    if name.startswith("fir"):
        return bench.make_feeds(rng.integers(0, 99, (k + n - 1,)))
    if name.startswith("horner"):
        return bench.make_feeds(rng.integers(0, 10, (k,)))
    if name.startswith(("saxpy", "relu_chain")):
        return bench.make_feeds(rng.integers(0, 99, (k,)),
                                rng.integers(0, 99, (k,)))
    return bench.make_feeds(rng.integers(0, 99, (k, n)))


def tokens_out(name: str, k: int) -> int:
    """Result tokens a run of `random_feeds(name, ..., k)` produces on
    each output arc: one per stream element for DAG fabrics, one exit
    result per run for the single-shot loop fabrics (whatever their trip
    count)."""
    return 1 if name in SINGLE_SHOT else k
