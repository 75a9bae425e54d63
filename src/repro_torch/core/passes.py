"""Graph-optimizing compiler passes (PyTorch port of ``repro.core.passes``).

The paper's toolchain synthesizes a fabric containing *only* the
operators the graph actually uses; this module is the software half of
that specialization.  It rewrites a :class:`~repro_torch.core.graph.Graph`
before plan construction, the way synchronous-dataflow compilers fold
static structure out of the runtime schedule:

* **constant folding** — a pure single-output value node (primitive /
  decider / NOT) whose inputs are all sticky const buses always produces
  the same token, so its output arc *becomes* a const bus and the
  operator is dropped from the fabric (evaluated with the engine's own numpy ALU,
  :func:`repro_torch.core.engine.alu_numpy`, so folded values are bit-identical
  to fired ones at the target dtype);
* **identity elimination** — ``x op c`` where the const ``c`` makes the
  op a no-op at the target dtype (``+0 -0 |0 ^0 <<0 >>0 *1 /1`` for
  integer dtypes; only ``*1 /1`` for floats, where ``+0.0``/``-0.0``
  forms are not bit-exact on signed zeros) is spliced out of the wire;
* **dead-node/dead-arc elimination** — a *closed* region of nodes that
  cannot reach any output arc, and whose inputs come only from const
  buses or other dead nodes, is deleted along with its now-unreferenced
  arcs.  Regions fed by live producers are kept (removing the consumer
  would strand the producer's arc as a new environment-drained output),
  and so are regions fed by environment input arcs (deleting the arc
  would make the authored feed interface start rejecting valid feeds).

Contract (held against the JAX package's passes in
tests/test_torch_passes.py): for a fabric that
quiesces within ``max_cycles``, the rewritten graph drains bit-identical
last values *and token counts* on every surviving output arc.  ``cycles``
and ``fired`` may shrink — that is the point: the optimized fabric does
less work.  For full-field bit-identity (cycles/fired included) use the
*plan-level* opcode-class specialization alone
(``DataflowEngine(optimize=True)``), which is a pure layout
permutation.

**NDMERGE makes rewrites timing-sensitive — legality is REGION-SCOPED.**
NDMERGE arbitration picks whichever input token *arrives first* (tie:
a), so the winner depends on arc refill cadence, not just on values.
Folding replaces a periodically-refilled arc with an always-full const
bus, and an identity splice removes a one-token pipeline register
(tokens arrive a cycle earlier and the wire's capacity drops from two
tokens to one) — either can flip which input wins a race.  Backpressure
couples timing globally (a COPY whose outputs straddle two cones
propagates a stall from one into the other), so for a graph containing
a *racy* NDMERGE no cone-local guard is sound and the fold/identity
passes bail out entirely.

The paper's **loop-entry** NDMERGE is different: its
non-cycle input delivers exactly one initiation token per run (an
initial-token annotation, or the single-shot feed contract that
``TracedProgram.make_feeds`` enforces on loop fabrics) and every later
token arrives on the back edge, *serialized by the cycle itself* — so
its output value sequence is arrival-timing-independent, and the Kahn
determinism argument that justifies the rewrites extends to the
whole graph.  ``_loop_analysis`` classifies each NDMERGE structurally:
**loop-entry** iff the node lies on a directed cycle through exactly
one of its inputs; anything else (acyclic NDMERGE, or a merge with two
back edges) is **racy** and keeps the blanket bail-out.  When every
NDMERGE is a loop entry, fold/splice run *region-scoped*:

* nodes on directed cycles are never folded (impossible anyway — a
  cycle input is never const) and never spliced (the removed register
  is loop token capacity: blocking behavior would change);
* a node whose output arc feeds an NDMERGE input is never folded —
  turning the one-shot/periodic arc into an always-full const bus
  would re-fire the merge every refill window;
* arcs carrying initial-token annotations are never spliced away, and
  a fold never targets them (their producers sit on the back-edge
  cycle);
* everything else — the acyclic, merge-free cones before, after, and
  feeding the loop — folds/splices as in a merge-free graph, because timing shifts
  on a loop's *initiation* path cannot flip its entry merge (there is
  no back-edge token to race until the initiation has happened).

DCE is unchanged — a removable region is disconnected from the live
fabric by construction, so deleting it cannot perturb a live merge
(and once a dead NDMERGE is deleted, later fixpoint rounds fold/splice
the now merge-free remainder).

The passes run to a joint fixpoint: folding a node can turn its
consumer into an identity, and splicing an identity can strand a dead
region.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import alu_numpy
from repro_torch.core.graph import (DECIDER_OPS, Graph, Node, Op,
                              PRIMITIVE_OPS)

# ops a constant-folder may evaluate at compile time: pure SINGLE-OUTPUT
# functions of their input values.  Control ops route/merge tokens and
# SINK is a drain whose presence affects quiescence, so they never fold.
# COPY is pure but has two outputs whose refill cadences are COUPLED by
# its firing rule (both must be empty): folding it to two independent
# always-full const buses removes that backpressure coupling and can
# even flip a quiescing fabric into a free-running one — so it stays.
_FOLDABLE = frozenset((*PRIMITIVE_OPS, *DECIDER_OPS, Op.NOT))

PASS_NAMES = ("fold", "identity", "dce")


@dataclasses.dataclass
class PassReport:
    """What the pipeline did to one graph."""
    nodes_before: int = 0
    nodes_after: int = 0
    arcs_before: int = 0
    arcs_after: int = 0
    folded: int = 0         # nodes evaluated at compile time
    identities: int = 0     # no-op nodes spliced out of the wire
    dead: int = 0           # unreachable nodes removed
    iterations: int = 0     # fixpoint rounds

    @property
    def changed(self) -> bool:
        return bool(self.folded or self.identities or self.dead)

    def summary(self) -> str:
        return (f"nodes {self.nodes_before}->{self.nodes_after}, "
                f"arcs {self.arcs_before}->{self.arcs_after} "
                f"(folded={self.folded}, identities={self.identities}, "
                f"dead={self.dead}, rounds={self.iterations})")


def _rebuild(graph: Graph, nodes: list[Node], consts: dict) -> Graph:
    g = Graph(name=graph.name)
    g.nodes = list(nodes)
    # drop consts/inits no longer referenced by any node: a const arc
    # with no consumer would otherwise surface as a new environment-
    # drained output bus (free-running token source), and an orphaned
    # initial-token annotation would fail validation
    used = {a for n in nodes for a in (*n.inputs, *n.outputs)}
    orig_out = set(graph.output_arcs())
    g.consts = {a: v for a, v in consts.items()
                if a in used or a in orig_out}
    g.inits = {a: v for a, v in graph.inits.items() if a in used}
    return g


def _const_value(consts, arc, dtype):
    return np.asarray(consts[arc], dtype).reshape(())


def _loop_analysis(graph: Graph) -> tuple[set[int], bool]:
    """-> (nodes on directed cycles, any RACY ndmerge present).

    An NDMERGE is a *loop entry* (race-free under the single-initiation
    contract, see module docstring) iff it lies on a directed cycle
    through exactly one of its inputs; every other NDMERGE — acyclic,
    or merged by two back edges — is racy."""
    cons = graph.consumers()
    N = len(graph.nodes)
    adj: list[list[int]] = [
        sorted({j for a in n.outputs for j in cons.get(a, [])})
        for n in graph.nodes]
    # iterative Tarjan SCC
    scc_id = [-1] * N
    low = [0] * N
    num = [-1] * N
    count = 0
    n_sccs = 0
    stack: list[int] = []
    on_stack = [False] * N
    for root in range(N):
        if num[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            i, pi = work[-1]
            if pi == 0:
                num[i] = low[i] = count
                count += 1
                stack.append(i)
                on_stack[i] = True
            recursed = False
            for k in range(pi, len(adj[i])):
                j = adj[i][k]
                if num[j] == -1:
                    work[-1] = (i, k + 1)
                    work.append((j, 0))
                    recursed = True
                    break
                if on_stack[j]:
                    low[i] = min(low[i], num[j])
            if recursed:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[i])
            if low[i] == num[i]:
                while True:
                    j = stack.pop()
                    on_stack[j] = False
                    scc_id[j] = n_sccs
                    if j == i:
                        break
                n_sccs += 1
    size = [0] * n_sccs
    for s in scc_id:
        size[s] += 1
    cyclic = {i for i in range(N)
              if size[scc_id[i]] > 1 or i in adj[i]}
    prod = graph.producers()
    racy = False
    for i, n in enumerate(graph.nodes):
        if n.op != Op.NDMERGE:
            continue
        if i not in cyclic:
            racy = True
            continue
        back_edges = sum(
            1 for a in n.inputs
            if any(scc_id[p] == scc_id[i] for p in prod.get(a, [])))
        if back_edges != 1:
            racy = True
    return cyclic, racy


def constant_fold(graph: Graph, dtype=np.int32) -> tuple[Graph, int]:
    """Fold every pure value node whose inputs are all const arcs; its
    output arcs become const buses carrying the compile-time result.
    Iterates so chains of constants collapse completely.

    Region-scoped legality (module docstring): bails out entirely when
    the graph contains a *racy* NDMERGE (a const bus is always full
    while the folded node refilled its arc periodically, and that
    cadence change can flip which input wins the arbitration race);
    with only loop-entry NDMERGEs it folds everywhere except nodes
    whose output arc feeds an NDMERGE input or carries an initial-token
    annotation — those arcs' token cadence IS the loop semantics."""
    _, racy = _loop_analysis(graph)
    if racy:
        return graph, 0
    merge_fed = {a for n in graph.nodes if n.op == Op.NDMERGE
                 for a in n.inputs}
    dtype = np.dtype(dtype)
    nodes = list(graph.nodes)
    consts = dict(graph.consts)
    folded = 0
    changed = True
    while changed:
        changed = False
        keep = []
        for n in nodes:
            if (n.op in _FOLDABLE
                    and all(a in consts for a in n.inputs)
                    and n.outputs[0] not in merge_fed
                    and n.outputs[0] not in graph.inits):
                a = _const_value(consts, n.inputs[0], dtype)
                b = (_const_value(consts, n.inputs[1], dtype)
                     if len(n.inputs) > 1 else a)
                z = alu_numpy(n.op, a, b, dtype)
                # store as the dtype's Python scalar: ints stay exact,
                # float32 round-trips bit-exactly through Python float
                consts[n.outputs[0]] = np.asarray(z, dtype).reshape(()).item()
                folded += 1
                changed = True
            else:
                keep.append(n)
        nodes = keep
    return _rebuild(graph, nodes, consts), folded


# op -> const operand value that makes `a op const` the identity on a.
# Only MUL/DIV hold for float dtypes: OR/XOR booleanize, SHL/SHR rescale
# through exp2's rounding, and ADD/SUB are not BIT-exact identities for
# signed zeros (-0.0 + 0.0 is +0.0, and the `== 0` match also accepts a
# -0.0 const, for which x - (-0.0) flips -0.0 to +0.0) — splicing them
# would break the bit-identical-last-values contract.
_IDENTITY_B = {
    Op.ADD: 0, Op.SUB: 0, Op.MUL: 1, Op.DIV: 1,
    Op.OR: 0, Op.XOR: 0, Op.SHL: 0, Op.SHR: 0,
}
_INT_ONLY_IDENTITIES = frozenset(
    (Op.ADD, Op.SUB, Op.OR, Op.XOR, Op.SHL, Op.SHR))


def eliminate_identities(graph: Graph, dtype=np.int32
                         ) -> tuple[Graph, int]:
    """Splice out ``z = a op c`` nodes where the const ``c`` makes the
    op a no-op, rewiring ``a``'s producer straight onto ``z`` (or ``z``'s
    consumer straight onto ``a`` when ``a`` is an environment input).
    Skips the splice when it would fuse an environment input directly to
    an environment output (both interface arcs must keep existing).

    Region-scoped legality (module docstring): bails out entirely when
    the graph contains a *racy* NDMERGE (the spliced node was a
    one-token pipeline register; removing it shifts arrival timing a
    cycle earlier and can flip the race).  With only loop-entry
    NDMERGEs it splices everywhere except nodes on directed cycles
    (the lost register is loop token capacity — blocking behavior
    would change) and wires carrying initial-token annotations."""
    cyclic_nodes, racy = _loop_analysis(graph)
    if racy:
        return graph, 0
    dtype = np.dtype(dtype)
    is_int = np.issubdtype(dtype, np.integer)
    producers = graph.producers()
    consumers = graph.consumers()
    nodes = list(graph.nodes)
    consts = dict(graph.consts)
    removed = 0
    for i, n in enumerate(nodes):
        if n is None or n.op not in _IDENTITY_B:
            continue
        if i in cyclic_nodes:
            continue
        if n.inputs[0] in graph.inits or n.outputs[0] in graph.inits:
            continue
        if not is_int and n.op in _INT_ONLY_IDENTITIES:
            continue
        b_arc = n.inputs[1]
        if b_arc not in consts:
            continue
        want = _IDENTITY_B[n.op]
        # compare at the execution dtype, no int() truncation: 0.5 is
        # NOT the additive identity even though int(0.5) == 0
        if not bool(_const_value(consts, b_arc, dtype)
                    == np.asarray(want, dtype)):
            continue
        x, o = n.inputs[0], n.outputs[0]
        if x in consts:
            continue            # all-const case belongs to the folder
        prod = producers.get(x, [])
        if prod:
            # internal wire: x's producer writes o directly
            j = prod[0]
            m = nodes[j]
            nodes[j] = Node(m.op, m.inputs,
                            tuple(o if a == x else a for a in m.outputs),
                            m.name)
            producers[o] = [j]
        else:
            # x is an environment input: o's consumer reads x directly
            cons = consumers.get(o, [])
            if not cons:
                continue        # input->output splice would drop an arc
            j = cons[0]
            m = nodes[j]
            nodes[j] = Node(m.op,
                            tuple(x if a == o else a for a in m.inputs),
                            m.outputs, m.name)
            consumers[x] = [j]
        nodes[i] = None
        removed += 1
    return _rebuild(graph, [n for n in nodes if n is not None],
                    consts), removed


def eliminate_dead(graph: Graph) -> tuple[Graph, int]:
    """Remove closed dead regions: nodes with no path to any output arc
    whose every input is a const or another dead node.  (A dead node
    can never feed a live one — feeding a live node is a path to an
    output — so only incoming crossings matter.)

    Two kinds of dead nodes are deliberately KEPT: nodes fed by a live
    producer (removing the consumer would strand the producer's arc as
    a new environment-drained output), and nodes fed by an environment
    *input* arc (removing them would delete the input arc, so feeds
    that were valid for the authored graph would start raising in
    ``pack_feeds`` — the optimized fabric must accept the authored
    feed interface unchanged)."""
    consumers = graph.consumers()
    out_arcs = set(graph.output_arcs())
    input_arcs = set(graph.input_arcs())
    # liveness: reverse reachability from the output arcs
    live = [any(o in out_arcs for o in n.outputs) for n in graph.nodes]
    changed = True
    while changed:
        changed = False
        for i, n in enumerate(graph.nodes):
            if not live[i]:
                if any(live[c] for o in n.outputs
                       for c in consumers.get(o, [])):
                    live[i] = True
                    changed = True
    # closed region: drop dead nodes not fed by a live producer and not
    # fed by an environment input arc
    producers = graph.producers()
    removable = [not lv and not any(a in input_arcs for a in n.inputs)
                 for lv, n in zip(live, graph.nodes)]
    changed = True
    while changed:
        changed = False
        for i, n in enumerate(graph.nodes):
            if removable[i] and any(
                    not removable[p] for a in n.inputs
                    for p in producers.get(a, [])):
                removable[i] = False
                changed = True
    kept = [n for i, n in enumerate(graph.nodes) if not removable[i]]
    dead = len(graph.nodes) - len(kept)
    return _rebuild(graph, kept, graph.consts), dead


def optimize_graph(graph: Graph, dtype=np.int32,
                   passes=PASS_NAMES) -> tuple[Graph, PassReport]:
    """Run the rewrite pipeline to a joint fixpoint.

    Returns ``(optimized_graph, report)``.  The input graph is never
    mutated.  ``dtype`` is the execution dtype the folded constants are
    evaluated at (folding at the wrong width would change wrapped
    results)."""
    unknown = set(passes) - set(PASS_NAMES)
    if unknown:
        raise ValueError(f"unknown passes {sorted(unknown)}; "
                         f"pick from {PASS_NAMES}")
    report = PassReport(nodes_before=len(graph.nodes),
                        arcs_before=len(graph.arcs))
    g = graph
    for _ in range(max(len(graph.nodes), 1)):
        report.iterations += 1
        before = (len(g.nodes), len(g.arcs), len(g.consts))
        if "fold" in passes:
            g, k = constant_fold(g, dtype)
            report.folded += k
        if "identity" in passes:
            g, k = eliminate_identities(g, dtype)
            report.identities += k
        if "dce" in passes:
            g, k = eliminate_dead(g)
            report.dead += k
        if (len(g.nodes), len(g.arcs), len(g.consts)) == before:
            break
    g.validate()
    report.nodes_after = len(g.nodes)
    report.arcs_after = len(g.arcs)
    return g, report
