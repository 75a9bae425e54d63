"""FabricProfile -- per-node / per-arc counters from a profiled run.

The engine accumulates five int32 counter arrays alongside the arc
registers while a fabric runs (inside the fire-block kernel on the
card):

- ``node_fires[n]`` : cycles in which node *n* fired.
- ``stall_in[n]``   : cycles in which *n*'s inputs were not ready.
- ``stall_out[n]``  : cycles in which inputs were ready but an output
  arc was still full (backpressure) -- or, for BRANCH/DMERGE, the
  selected output/input pairing blocked the fire.
- ``arc_busy[a]``   : cycles arc *a* held a token at the sample point
  (post-fire, pre-drain).
- ``arc_hw[a]``     : high-water token count on arc *a* (0 or 1 on this
  depth-1 fabric).

The three node counters partition the profiled cycles: for every node,
``node_fires + stall_in + stall_out == cycles``.  Counters are sampled
every *simulated* cycle, so ``cycles`` here can exceed
``EngineResult.cycles`` by up to K-1 idle tail cycles when the block
length K does not divide the quiescence point; ``node_fires`` is exact
regardless (nothing fires in an idle cycle).

All arrays are in **graph order** (the plan's node/arc permutations are
undone before this object is built).  A partitioned (multi-fabric)
run adds the channel counters of its cut arcs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.graph import Graph


@dataclasses.dataclass
class FabricProfile:
    """Counters for one fabric run (or one request's residency)."""

    node_names: list[str]
    arc_names: list[str]
    node_fires: np.ndarray  # int64[N]
    stall_in: np.ndarray    # int64[N]
    stall_out: np.ndarray   # int64[N]
    arc_busy: np.ndarray    # int64[A]
    arc_hw: np.ndarray      # int64[A]
    cycles: int             # simulated (profiled) cycles
    dispatches: int         # launches that produced these counters

    # Channel counters -- present only on partitioned (multi-fabric) runs.
    # Channels are the inter-region arcs; each is a depth-1 register pair
    # both endpoint regions see, so busy/high-water obey the same bounds as
    # ordinary arcs.  ``ch_pushes`` counts tokens that crossed the channel,
    # i.e. the cut-arc traffic of the run.  ``ch_depth`` records the block
    # length K whose fused channel exchange the depth argument is about.
    ch_names: list[str] | None = None
    ch_busy: np.ndarray | None = None    # int64[C]
    ch_hw: np.ndarray | None = None      # int64[C]
    ch_pushes: np.ndarray | None = None  # int64[C]
    ch_depth: int | None = None

    # ---------------------------------------------------------------- derived
    @property
    def fired(self) -> int:
        """Total node firings -- equals ``EngineResult.fired`` exactly."""
        return int(self.node_fires.sum())

    def fires_per_cycle(self) -> np.ndarray:
        """Per-node firing rate over the profiled window (float64[N])."""
        c = max(self.cycles, 1)
        return self.node_fires.astype(np.float64) / c

    def occupancy(self) -> np.ndarray:
        """Per-arc fraction of cycles holding a token (float64[A])."""
        c = max(self.cycles, 1)
        return self.arc_busy.astype(np.float64) / c

    def utilization(self) -> float:
        """Fraction of node-cycles spent firing (the fabric's duty cycle)."""
        n = len(self.node_names)
        if n == 0 or self.cycles == 0:
            return 0.0
        return float(self.node_fires.sum()) / (n * self.cycles)

    def fires_per_dispatch(self) -> float:
        """Firings amortized per launch."""
        return float(self.node_fires.sum()) / max(self.dispatches, 1)

    def top_nodes(self, k: int = 5) -> list[tuple[str, int]]:
        """The k hottest nodes by fire count."""
        order = np.argsort(self.node_fires)[::-1][:k]
        return [(self.node_names[i], int(self.node_fires[i])) for i in order]

    # ------------------------------------------------------------- validation
    def check(self) -> None:
        """Assert the counter partition invariant."""
        total = self.node_fires + self.stall_in + self.stall_out
        if self.cycles and not (total == self.cycles).all():
            bad = int(np.argmax(total != self.cycles))
            raise AssertionError(
                f"profile partition broken at node {self.node_names[bad]}: "
                f"fires={int(self.node_fires[bad])} + stall_in="
                f"{int(self.stall_in[bad])} + stall_out="
                f"{int(self.stall_out[bad])} != cycles={self.cycles}")
        if (self.arc_busy > self.cycles).any():
            raise AssertionError("arc_busy exceeds profiled cycles")
        if (self.arc_hw > 1).any():
            raise AssertionError("arc high-water > 1 on a depth-1 fabric")
        if self.ch_busy is not None and (self.ch_busy > self.cycles).any():
            raise AssertionError("channel busy exceeds profiled cycles")
        if self.ch_hw is not None and (self.ch_hw > 1).any():
            raise AssertionError("channel high-water > 1 (register pair)")

    # ---------------------------------------------------------------- export
    def to_json(self) -> dict:
        out = {
            "cycles": int(self.cycles),
            "dispatches": int(self.dispatches),
            "fired": self.fired,
            "utilization": self.utilization(),
            "fires_per_dispatch": self.fires_per_dispatch(),
            "nodes": [
                {
                    "name": self.node_names[i],
                    "fires": int(self.node_fires[i]),
                    "stall_in": int(self.stall_in[i]),
                    "stall_out": int(self.stall_out[i]),
                }
                for i in range(len(self.node_names))
            ],
            "arcs": [
                {
                    "name": self.arc_names[i],
                    "busy": int(self.arc_busy[i]),
                    "high_water": int(self.arc_hw[i]),
                }
                for i in range(len(self.arc_names))
            ],
        }
        if self.ch_names is not None:
            out["channels"] = {
                "depth": int(self.ch_depth or 0),
                "arcs": [
                    {
                        "name": self.ch_names[i],
                        "busy": int(self.ch_busy[i]),
                        "high_water": int(self.ch_hw[i]),
                        "pushes": int(self.ch_pushes[i]),
                    }
                    for i in range(len(self.ch_names))
                ],
            }
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1)

    def summary(self) -> str:
        hot = ", ".join(f"{n}={c}" for n, c in self.top_nodes(3))
        return (f"cycles={self.cycles} fired={self.fired} "
                f"util={self.utilization():.3f} "
                f"fires/dispatch={self.fires_per_dispatch():.1f} hot[{hot}]")

    # ------------------------------------------------------------ constructor
    @staticmethod
    def names_for(graph: "Graph") -> tuple[list[str], list[str]]:
        node_names = [
            f"{i}:{node.op.name}" + (f":{node.name}" if getattr(node, "name", "") else "")
            for i, node in enumerate(graph.nodes)
        ]
        return node_names, list(graph.arcs)

    @classmethod
    def from_plan(
        cls,
        graph: "Graph",
        plan: dict,
        node_fires: np.ndarray,
        stall_in: np.ndarray,
        stall_out: np.ndarray,
        arc_busy: np.ndarray,
        arc_hw: np.ndarray,
        cycles: int,
        dispatches: int,
    ) -> "FabricProfile":
        """Undo the plan's node/arc permutations -> graph-order arrays.

        The counter arrays arrive in plan order and may carry padding
        rows (the kernel tables append a dummy node; the arc axis has
        FULL_PAD/EMPTY_PAD slots) -- both are sliced away here.
        """
        node_names, arc_names = cls.names_for(graph)
        node_inv = np.asarray(plan["node_inv"])          # graph idx -> plan row
        aidx = plan["aidx"]                              # arc name -> plan slot
        arc_rows = np.array([aidx[a] for a in graph.arcs], dtype=np.int64)
        return cls(
            node_names=node_names,
            arc_names=arc_names,
            node_fires=np.asarray(node_fires, dtype=np.int64)[node_inv],
            stall_in=np.asarray(stall_in, dtype=np.int64)[node_inv],
            stall_out=np.asarray(stall_out, dtype=np.int64)[node_inv],
            arc_busy=np.asarray(arc_busy, dtype=np.int64)[arc_rows],
            arc_hw=np.asarray(arc_hw, dtype=np.int64)[arc_rows],
            cycles=int(cycles),
            dispatches=int(dispatches),
        )
