"""Pipeline schedules scheduled BY the paper's dataflow engine (PyTorch
port of the schedule half of ``repro.core.pipeline``).

The mapping (DESIGN.md §4): pipeline stages are dataflow operator nodes,
microbatches are tokens, the inter-stage activation transfer is the arc,
and the schedule is obtained by *simulating the stage chain on the static
dataflow engine itself* — each stage fires when its input arc holds a
token and its output arc is empty.

Two schedules:

* ``dataflow`` (paper-faithful): the engine's one-token-per-arc handshake
  sustains one token per TWO cycles per arc (paper §3.1), giving a
  2M+S-2-step schedule — stages alternate work/idle exactly like the
  str/ack exchange in paper Fig. 3;
* ``dense`` (beyond-paper): double-buffered arcs recover the classic
  M+S-1 GPipe wavefront.

The JAX package also runs a schedule: ``pipeline_apply`` drives stage
functions over a ``"pp"`` device mesh (``shard_map``, ``lax.scan`` over
the steps, ``ppermute`` between stages), and ``make_stage_fn`` builds a
stage of transformer layers.  Both need several devices and are not
ported yet: on the card they become point-to-point sends between
processes of ``torch.distributed`` (ROADMAP Queue A 10b), so here they
raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import run_reference
from repro_torch.core.graph import Graph, Op


# ---------------------------------------------------------------------------
# schedule generation
# ---------------------------------------------------------------------------
def stage_chain_graph(n_stages: int) -> Graph:
    """The pipeline as a dataflow fabric: a chain of operator nodes."""
    g = Graph(name=f"pipeline_{n_stages}")
    g.const("zero", 0)
    arcs = ["mb_in"] + [f"a{i}" for i in range(1, n_stages)] + ["mb_out"]
    for s in range(n_stages):
        # identity operator (OR with 0) so the traced token value is the
        # microbatch id itself
        g.add(Op.OR, [arcs[s], "zero"], [arcs[s + 1]], name=f"stage{s}")
    return g


def dataflow_schedule(n_stages: int, n_micro: int) -> np.ndarray:
    """Schedule table [T, S] (microbatch index or -1) simulated on the
    static dataflow engine (paper-faithful one-token-per-arc)."""
    g = stage_chain_graph(n_stages)
    events = []
    run_reference(g, {"mb_in": np.arange(n_micro)}, trace=events.append)
    # events: (cycle, node_index, microbatch_value)
    T = max(c for c, _, _ in events)
    table = np.full((T, n_stages), -1, np.int32)
    for cycle, node, val in events:
        table[cycle - 1, node] = val
    return table


def dense_schedule(n_stages: int, n_micro: int) -> np.ndarray:
    """Double-buffered-arc schedule: classic M+S-1 wavefront."""
    T = n_micro + n_stages - 1
    table = np.full((T, n_stages), -1, np.int32)
    for t in range(T):
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_micro:
                table[t, s] = m
    return table


# ---------------------------------------------------------------------------
# executor (not ported: needs several cards)
# ---------------------------------------------------------------------------
def pipeline_apply(*args, **kwargs):
    """The pipelined stack over a device mesh: not ported yet (it needs
    several cards and ``torch.distributed``; ROADMAP Queue A 10b)."""
    raise NotImplementedError(
        "pipeline_apply runs stages on several devices; its port "
        "(torch.distributed point-to-point sends) is ROADMAP Queue A 10b")


def make_stage_fn(*args, **kwargs):
    """A stage of dense transformer layers for :func:`pipeline_apply`:
    not ported yet (ROADMAP Queue A 10b)."""
    raise NotImplementedError(
        "make_stage_fn builds stages for pipeline_apply, which is "
        "ROADMAP Queue A 10b")
