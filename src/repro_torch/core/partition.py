"""Cost-model-balanced graph partitioning for multi-fabric sharding
(PyTorch port of ``repro.core.partition``; the assignment is the JAX
package's, node for node, for every graph and P).

Splits one :class:`~repro_torch.core.graph.Graph` into P *regions* so
that :mod:`repro_torch.core.multifabric` can run each region as an
independent fabric (lanes of a stream's warp on the card), with
every inter-region arc carried by a token channel (DESIGN.md §14).  The
segmentation follows netlist partitioning practice (the connected-component / cost analysis used on
the 6502 netlist in the related repos): weight every node by a
per-opcode *fire cost*, charge a *cut penalty* for every crossing arc,
and search for an assignment that balances region weight while
minimizing cut arcs.

Legality rule — **never cut a loop cycle**.  A depth-1 handshake arc
inside a loop carries the loop's recurrence; splitting it across a
channel boundary would serialize the loop on inter-device latency and,
worse, make region quiescence detection circular.  Tarjan SCCs are
therefore collapsed into atomic *supernodes* before any assignment: a
cyclic loop core always lands whole in one region, so a cut arc always
connects two distinct SCCs.  This is enforced by construction and
re-checked by :meth:`Partition.validate`.

The cost model reuses the graph IR's ``LUT_WEIGHT`` table (the
Table-1 resource analogue): an operator's combinational datapath
complexity is the best static proxy for its per-fire work, exactly the
expression-complexity weighting the netlist segmentation uses.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core.graph import Graph, LUT_WEIGHT, Op

# Per-opcode fire cost (region balance weight).  LUT complexity is the
# resource analogue the repo already trusts for Table 1; a fired node
# costs its datapath, an idle node costs (almost) nothing, so balancing
# summed LUT weight balances worst-case per-cycle region work.
FIRE_COST: dict[Op, int] = dict(LUT_WEIGHT)

# Cost charged per cut arc, in FIRE_COST units.  A crossing arc costs a
# channel slot exchange every block; 32 ≈ two ADD datapaths keeps the
# partitioner from shaving single nodes off regions just to balance.
CUT_PENALTY = 32.0

# auto partitioning declines to shard tiny fabrics: below this many
# nodes per region the per-cycle channel merge dwarfs the region work.
MIN_AUTO_REGION_NODES = 8


@dataclasses.dataclass(frozen=True)
class Partition:
    """An assignment of every node to one of P regions.

    ``assign[i]`` is the region id of ``graph.nodes[i]``.  The spec
    string (region count + assignment hash) is the cache-key component
    :func:`repro_torch.serve.dataflow_server.cached_engine` uses, so a
    sharded and an unsharded compile of the same fabric signature never
    alias one engine.
    """

    P: int
    assign: tuple[int, ...]

    def regions(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in range(self.P)]
        for i, r in enumerate(self.assign):
            out[r].append(i)
        return out

    def spec(self) -> str:
        """``P:assignment-hash`` — the partition's cache-key identity."""
        h = hashlib.sha256(
            np.asarray(self.assign, np.int64).tobytes()).hexdigest()[:12]
        return f"{self.P}:{h}"

    def cut_arcs(self, graph: Graph) -> list[str]:
        """Arcs whose producer and consumer live in different regions
        (graph arc order)."""
        prod = {a: ns[0] for a, ns in graph.producers().items()}
        cons = graph.consumers()
        cut = []
        for a in graph.arcs:
            if a in prod and a in cons and a not in graph.consts:
                if self.assign[prod[a]] != self.assign[cons[a][0]]:
                    cut.append(a)
        return cut

    def region_weights(self, graph: Graph) -> list[int]:
        w = [0] * self.P
        for i, n in enumerate(graph.nodes):
            w[self.assign[i]] += FIRE_COST[n.op]
        return w

    def validate(self, graph: Graph) -> None:
        """Raise unless this is a valid cover of ``graph``:

        * every node in exactly one region ``0 <= r < P``;
        * every region non-empty;
        * no cut arc closes a loop cycle (producer and consumer of a
          crossing arc must belong to different SCCs).
        """
        if len(self.assign) != len(graph.nodes):
            raise ValueError(
                f"partition covers {len(self.assign)} nodes but the graph "
                f"has {len(graph.nodes)}")
        seen = set(self.assign)
        if seen - set(range(self.P)):
            raise ValueError(f"region ids {sorted(seen)} outside 0..{self.P - 1}")
        if len(seen) != self.P:
            missing = sorted(set(range(self.P)) - seen)
            raise ValueError(f"empty regions {missing} (every region must "
                             "hold at least one node)")
        scc = _scc_ids(graph)
        prod = {a: ns[0] for a, ns in graph.producers().items()}
        cons = graph.consumers()
        for a in graph.arcs:
            if a in graph.consts or a not in prod or a not in cons:
                continue
            p, c = prod[a], cons[a][0]
            if self.assign[p] != self.assign[c] and scc[p] == scc[c]:
                raise ValueError(
                    f"arc {a!r} is cut but lies on a loop cycle "
                    f"(nodes {p} and {c} share an SCC) — loop cycles "
                    "must never cross a channel boundary")


def _node_edges(graph: Graph) -> list[tuple[int, int, str]]:
    """(producer, consumer, arc) node-level edges (const buses excluded:
    they have no producer node and are replicated, never cut)."""
    prod = {a: ns[0] for a, ns in graph.producers().items()}
    cons = graph.consumers()
    edges = []
    for a in graph.arcs:
        if a in graph.consts or a not in prod or a not in cons:
            continue
        edges.append((prod[a], cons[a][0], a))
    return edges


def _scc_ids(graph: Graph) -> list[int]:
    """Tarjan SCC ids per node (iterative — netlist-sized graphs would
    blow the recursion limit)."""
    n = len(graph.nodes)
    adj: list[list[int]] = [[] for _ in range(n)]
    for p, c, _ in _node_edges(graph):
        adj[p].append(c)
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: list[int] = []
    ids = [-1] * n
    counter = 0
    n_scc = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            for k in range(pi, len(adj[v])):
                w = adj[v][k]
                if index[w] == -1:
                    work[-1] = (v, k + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    ids[w] = n_scc
                    if w == v:
                        break
                n_scc += 1
            if work:
                u, _ = work[-1]
                low[u] = min(low[u], low[v])
    return ids


def _condense(graph: Graph):
    """Collapse SCCs into supernodes: returns (scc ids, member lists,
    weights, inter-supernode edge multiset, topological order,
    locality order)."""
    ids = _scc_ids(graph)
    n_scc = max(ids) + 1 if ids else 0
    members: list[list[int]] = [[] for _ in range(n_scc)]
    weights = [0] * n_scc
    for i, n in enumerate(graph.nodes):
        members[ids[i]].append(i)
        weights[ids[i]] += FIRE_COST[n.op]
    edges: list[tuple[int, int]] = []
    for p, c, _ in _node_edges(graph):
        if ids[p] != ids[c]:
            edges.append((ids[p], ids[c]))
    # Kahn topological order over the condensation (always a DAG)
    indeg = [0] * n_scc
    succ: list[list[int]] = [[] for _ in range(n_scc)]
    for p, c in set(edges):
        succ[p].append(c)
        indeg[c] += 1
    ready = sorted(s for s in range(n_scc) if indeg[s] == 0)
    order: list[int] = []
    while ready:
        s = ready.pop(0)
        order.append(s)
        for t in sorted(succ[s]):
            indeg[t] -= 1
            if indeg[t] == 0:
                ready.append(t)
    # locality order for segmentation: post-order DFS over producers
    # from each sink, so a reduce subtree or an independent lane is
    # emitted contiguously and a contiguous chunk starts with
    # near-minimal crossing arcs.  (The Kahn order above interleaves
    # parallel structures — segmenting it would cut every lane of a
    # parallel fabric.)
    preds: list[list[int]] = [[] for _ in range(n_scc)]
    for p, c in sorted(set(edges)):
        preds[c].append(p)
    sinks = sorted(s for s in range(n_scc) if not succ[s])
    seen = [False] * n_scc
    lorder: list[int] = []
    for root in sinks + list(range(n_scc)):
        if seen[root]:
            continue
        seen[root] = True
        stack = [(root, 0)]
        while stack:
            v, pi = stack[-1]
            if pi < len(preds[v]):
                stack[-1] = (v, pi + 1)
                w = preds[v][pi]
                if not seen[w]:
                    seen[w] = True
                    stack.append((w, 0))
            else:
                stack.pop()
                lorder.append(v)
    return ids, members, weights, edges, order, lorder


def partition_graph(graph: Graph, P: int, *,
                    cut_penalty: float = CUT_PENALTY,
                    refine_rounds: int = 8) -> Partition:
    """Balanced min-cut assignment of ``graph`` into ``P`` regions.

    Two phases over the SCC condensation (supernodes are atomic, so no
    loop cycle can be cut):

    1. *Segmentation*: walk the condensation in producer-first DFS
       post-order (subtrees and independent lanes come out contiguous)
       and close a region whenever its accumulated fire cost reaches
       the balance target — contiguous chunks of that order start with
       few crossing arcs by construction (zero for parallel lanes).
    2. *Refinement*: greedy single-supernode moves; a move is taken
       when it lowers ``cut_penalty * cut_arcs + imbalance`` (imbalance
       is the sum of squared region weights, minimized when balanced)
       and leaves no region empty.  Deterministic: supernodes are
       visited in topological order, candidate regions in id order.
    """
    n = len(graph.nodes)
    if P < 1:
        raise ValueError(f"partition P must be >= 1, got {P}")
    if n == 0:
        raise ValueError("cannot partition an empty graph")
    if P == 1:
        return Partition(1, tuple([0] * n))
    ids, members, weights, edges, order, lorder = _condense(graph)
    if P > len(order):
        raise ValueError(
            f"{graph.name}: P={P} exceeds the {len(order)} atomic "
            "supernodes (loop cycles are never cut, so a fabric cannot "
            "be split finer than its SCC condensation)")

    total = float(sum(weights))
    # phase 1: contiguous segmentation of the locality order by prefix
    # cost (regions need not be topologically convex — the lockstep
    # channel exchange is direction-agnostic, so only cut count and
    # balance matter)
    sassign = [0] * len(order)
    region = 0
    done = 0.0      # weight already sealed into closed regions
    acc = 0.0       # weight of the currently-open region
    for k, s in enumerate(lorder):
        remaining_supers = len(lorder) - k
        remaining_regions = P - region
        # every remaining region must still receive >= 1 supernode
        must_close = remaining_supers <= remaining_regions and acc > 0
        target = total * (region + 1) / P
        if region < P - 1 and (must_close or done + acc >= target):
            region += 1
            done += acc
            acc = 0.0
        sassign[s] = region
        acc += weights[s]

    # phase 2: greedy cost-lowering moves
    def cost(sa):
        cut = sum(1 for p, c in edges if sa[p] != sa[c])
        w = [0.0] * P
        for s, r in enumerate(sa):
            w[r] += weights[s]
        return cut_penalty * cut + sum(x * x for x in w) / max(total, 1.0)

    cur = cost(sassign)
    counts = [0] * P
    for r in sassign:
        counts[r] += 1
    for _ in range(refine_rounds):
        improved = False
        for s in order:
            r0 = sassign[s]
            if counts[r0] == 1:
                continue    # never empty a region
            best_r, best_c = r0, cur
            for r1 in range(P):
                if r1 == r0:
                    continue
                sassign[s] = r1
                c1 = cost(sassign)
                if c1 < best_c - 1e-9:
                    best_r, best_c = r1, c1
            sassign[s] = best_r
            if best_r != r0:
                counts[r0] -= 1
                counts[best_r] += 1
                cur = best_c
                improved = True
        if not improved:
            break

    assign = [0] * n
    for s, r in enumerate(sassign):
        for i in members[s]:
            assign[i] = r
    part = Partition(P, tuple(assign))
    part.validate(graph)
    return part


def auto_partition(graph: Graph, devices: int | None = None) -> Partition:
    """Pick P from the fabric and the platform: bounded by the local
    device count (the CUDA cards, 1 where there is none), the SCC
    condensation size, and a minimum region size (sharding a tiny fabric
    only buys channel-merge overhead).  May return P=1 — the caller
    treats that as a solo fabric."""
    if devices is None:
        import torch
        devices = torch.cuda.device_count() if torch.cuda.is_available() \
            else 1
    n = len(graph.nodes)
    if n == 0:
        return Partition(1, ())
    _, _, _, _, order, _ = _condense(graph)
    P = max(1, min(int(devices), len(order),
                   n // MIN_AUTO_REGION_NODES))
    return partition_graph(graph, P)


def resolve_partition(graph: Graph, spec) -> Partition | None:
    """Normalize a user-facing partition spec (None | int | "auto" |
    Partition) to a validated :class:`Partition` or None.

    ``None`` and ``P=1`` both mean "solo fabric"; callers gate the
    sharded path on ``part is not None and part.P > 1``.
    """
    if spec is None:
        return None
    if isinstance(spec, Partition):
        spec.validate(graph)
        return spec
    if spec == "auto":
        return auto_partition(graph)
    if isinstance(spec, (int, np.integer)):
        return partition_graph(graph, int(spec))
    raise ValueError(
        f"partition must be None, an int, 'auto', or a Partition — "
        f"got {spec!r}")
