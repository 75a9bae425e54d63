"""Static dataflow graph IR.

Faithful to the paper's model (Silva et al. 2011): a graph of operator
*nodes* connected by *arcs*; each arc is a register holding at most one
token (static dataflow).  Arc = 16-bit data bus + str/ack control wires on
the FPGA; here an arc is a (full: bool, value: dtype[token_shape]) register
pair, which generalizes the 16-bit bus to tensor tokens.

Operator vocabulary is Veen's classical set, as used by the paper:
copy, primitive (arithmetic/logic/relational), dmerge, ndmerge, branch.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence


class Op(enum.IntEnum):
    """Opcodes. Values are stable — the engine dispatches on them."""

    # 1-in / 2-out
    COPY = 0
    # 2-in / 1-out primitives (paper: "add, sub, multiply, divide, and, or,
    # not, if, etc." — MAX/MIN/SHL/SHR/XOR live under the paper's "etc.")
    ADD = 1
    SUB = 2
    MUL = 3
    DIV = 4
    AND = 5
    OR = 6
    XOR = 7
    MAX = 8
    MIN = 9
    SHL = 10
    SHR = 11
    # 1-in / 1-out
    NOT = 12
    # relational deciders, 2-in / 1-out boolean token
    IFGT = 13   # a > b   (paper's `gtdecider`)
    IFGE = 14
    IFLT = 15
    IFLE = 16
    IFEQ = 17
    IFDF = 18   # a != b
    # control operators
    DMERGE = 19   # (a, b, ctrl) -> z : deterministic, ctrl selects a (true) or b
    NDMERGE = 20  # (a, b) -> z : first token to arrive wins (tie: a)
    BRANCH = 21   # (a, ctrl) -> (t, f) : routes a onto t (ctrl true) or f
    # sink: consumes a token (used to discard loop exhaust values)
    SINK = 22


# opcode -> (n_inputs, n_outputs)
ARITY: dict[Op, tuple[int, int]] = {
    Op.COPY: (1, 2),
    Op.ADD: (2, 1), Op.SUB: (2, 1), Op.MUL: (2, 1), Op.DIV: (2, 1),
    Op.AND: (2, 1), Op.OR: (2, 1), Op.XOR: (2, 1),
    Op.MAX: (2, 1), Op.MIN: (2, 1), Op.SHL: (2, 1), Op.SHR: (2, 1),
    Op.NOT: (1, 1),
    Op.IFGT: (2, 1), Op.IFGE: (2, 1), Op.IFLT: (2, 1), Op.IFLE: (2, 1),
    Op.IFEQ: (2, 1), Op.IFDF: (2, 1),
    Op.DMERGE: (3, 1),
    Op.NDMERGE: (2, 1),
    Op.BRANCH: (2, 2),
    Op.SINK: (1, 0),
}

PRIMITIVE_OPS = (
    Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.AND, Op.OR, Op.XOR, Op.MAX, Op.MIN,
    Op.SHL, Op.SHR,
)
DECIDER_OPS = (Op.IFGT, Op.IFGE, Op.IFLT, Op.IFLE, Op.IFEQ, Op.IFDF)

# LUT-complexity weights for the Table-1 resource analogue (relative logic
# cost of each operator's combinational datapath).
LUT_WEIGHT: dict[Op, int] = {
    Op.COPY: 1, Op.ADD: 16, Op.SUB: 16, Op.MUL: 64, Op.DIV: 128,
    Op.AND: 4, Op.OR: 4, Op.XOR: 4, Op.MAX: 20, Op.MIN: 20,
    Op.SHL: 12, Op.SHR: 12, Op.NOT: 2,
    Op.IFGT: 12, Op.IFGE: 12, Op.IFLT: 12, Op.IFLE: 12, Op.IFEQ: 8,
    Op.IFDF: 8, Op.DMERGE: 8, Op.NDMERGE: 8, Op.BRANCH: 8, Op.SINK: 1,
}


@dataclasses.dataclass(frozen=True)
class Node:
    op: Op
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    name: str = ""

    def __post_init__(self):
        n_in, n_out = ARITY[self.op]
        if len(self.inputs) != n_in:
            raise ValueError(
                f"{self.op.name} expects {n_in} inputs, got {self.inputs}")
        if len(self.outputs) != n_out:
            raise ValueError(
                f"{self.op.name} expects {n_out} outputs, got {self.outputs}")


@dataclasses.dataclass
class Graph:
    """A static dataflow graph.

    Arc classes (derived, except consts and inits):
      * input arcs  — no producer node; fed by the environment. The paper's
        `dado*` labels. Each is fed a *stream* of tokens (strobed one at a
        time as the arc drains), or is a sticky ``const`` (the bus always
        presents the value — e.g. the loop increment `dadoe` in Listing 1).
      * output arcs — no consumer node; drained by the environment each
        cycle (the paper's result buses, e.g. `fibo`, `pf`).
      * internal arcs — exactly one producer and one consumer (the paper:
        "each channel is allowed only one sender and one receiver").

    ``inits`` are *initial-token annotations* (DESIGN.md §10): an init
    arc starts full, holding the given value — the classical
    synchronous-dataflow "delay" marking on a loop's back-edge register.
    Unlike a const bus the token is ONE-SHOT: once consumed, the arc
    refills only from its producer (if any).  A producer-less init arc
    (a compile-time loop initial value) is never refilled at all, and is
    *not* an environment input — the feed strobe skips it.
    """

    nodes: list[Node] = dataclasses.field(default_factory=list)
    consts: dict[str, object] = dataclasses.field(default_factory=dict)
    name: str = "graph"
    inits: dict[str, object] = dataclasses.field(default_factory=dict)

    # -- construction -------------------------------------------------
    def add(self, op: Op, inputs: Sequence[str], outputs: Sequence[str],
            name: str = "") -> Node:
        node = Node(op, tuple(inputs), tuple(outputs), name)
        self.nodes.append(node)
        return node

    def const(self, arc: str, value) -> str:
        self.consts[arc] = value
        return arc

    def init(self, arc: str, value) -> str:
        """Annotate ``arc`` with an initial token (see class docstring)."""
        self.inits[arc] = value
        return arc

    # -- derived structure --------------------------------------------
    @property
    def arcs(self) -> list[str]:
        seen: dict[str, None] = {}
        for n in self.nodes:
            for a in (*n.inputs, *n.outputs):
                seen.setdefault(a, None)
        for a in self.consts:
            seen.setdefault(a, None)
        for a in self.inits:
            seen.setdefault(a, None)
        return list(seen)

    def producers(self) -> dict[str, list[int]]:
        p: dict[str, list[int]] = {}
        for i, n in enumerate(self.nodes):
            for a in n.outputs:
                p.setdefault(a, []).append(i)
        return p

    def consumers(self) -> dict[str, list[int]]:
        c: dict[str, list[int]] = {}
        for i, n in enumerate(self.nodes):
            for a in n.inputs:
                c.setdefault(a, []).append(i)
        return c

    def input_arcs(self) -> list[str]:
        prod = self.producers()
        return [a for a in self.arcs
                if a not in prod and a not in self.consts
                and a not in self.inits]

    def output_arcs(self) -> list[str]:
        cons = self.consumers()
        return [a for a in self.arcs if a not in cons]

    # -- validation -----------------------------------------------------
    def validate(self) -> None:
        prod, cons = self.producers(), self.consumers()
        for a in self.arcs:
            if len(prod.get(a, [])) > 1:
                raise ValueError(f"arc {a!r} has multiple producers "
                                 f"{prod[a]} (one sender per channel)")
            # const arcs are sticky environment buses: always full, never
            # drained, so fanning them out to several receivers is safe.
            if a not in self.consts and len(cons.get(a, [])) > 1:
                raise ValueError(f"arc {a!r} has multiple consumers "
                                 f"{cons[a]} (one receiver per channel)")
            if a in self.consts and a in prod:
                raise ValueError(f"const arc {a!r} also has a producer")
        for a in self.inits:
            if a in self.consts:
                raise ValueError(f"init arc {a!r} is also a const bus "
                                 "(a sticky bus needs no initial token)")
            if not cons.get(a):
                raise ValueError(f"init arc {a!r} has no consumer — the "
                                 "initial token could never be used")

    def is_cyclic(self) -> bool:
        order = self.try_topo_order()
        return order is None

    def try_topo_order(self) -> list[int] | None:
        """Topological order of node indices, or None if cyclic."""
        prod = self.producers()
        indeg = []
        dep: list[list[int]] = [[] for _ in self.nodes]
        for i, n in enumerate(self.nodes):
            cnt = 0
            for a in n.inputs:
                for p in prod.get(a, []):
                    dep[p].append(i)
                    cnt += 1
            indeg.append(cnt)
        ready = [i for i, d in enumerate(indeg) if d == 0]
        order: list[int] = []
        while ready:
            i = ready.pop()
            order.append(i)
            for j in dep[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        return order if len(order) == len(self.nodes) else None

    # -- Table-1 resource analogue --------------------------------------
    def resources(self) -> dict[str, int]:
        """FPGA-resource analogue of the compiled fabric.

        FF  ≈ one (data + status-bit) register per arc  (paper Fig. 5:
              dadoa/bita etc.), counted in bits for a 16-bit datapath.
        LUT ≈ summed combinational complexity of operator datapaths.
        SLICE ≈ node count (each operator = one placed FSM+datapath block).
        """
        n_arcs = len(self.arcs)
        return {
            "nodes": len(self.nodes),
            "arcs": n_arcs,
            "ff_bits": n_arcs * 17,  # 16-bit data reg + 1-bit status
            "lut_weight": int(sum(LUT_WEIGHT[n.op] for n in self.nodes)),
        }

    def summary(self) -> str:
        r = self.resources()
        kind = "cyclic" if self.is_cyclic() else "dag"
        return (f"{self.name}: {r['nodes']} nodes, {r['arcs']} arcs "
                f"({kind}), ff_bits={r['ff_bits']} lut={r['lut_weight']}")
