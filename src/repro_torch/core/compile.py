"""One compile pipeline for static dataflow graphs (PyTorch port of
``repro.core.compile``).

:func:`compile` is the single entry point.  It probes the graph's
capabilities (:class:`GraphTraits`: cyclic? control operators?
initial-token annotations?) and selects an executor:

* ``"dag"``      — lockstep SSA: nodes evaluated in topological order as
  tensor code over a whole token stream at once (the stream is the
  leading dimension).  Legal only when ``traits.tokens_out_static`` —
  acyclic, control-free, init-free — so every stream element fires
  every node exactly once.
* ``"unrolled"`` — token-presence execution: cycles, BRANCH/NDMERGE/
  DMERGE and initial tokens, bit-identical to the engine in outputs,
  counts, cycles and fired.  It runs the ``"torch"`` backend's cycle
  body over the graph as authored (see :func:`compile_cyclic`).
* ``"torch" | "cuda" | "reference"`` — the cycle-accurate block-fused
  engines (:class:`repro_torch.core.engine.DataflowEngine`: batching,
  and on ``"cuda"`` the resumable slots and serving).
* ``"auto"``     — ``"dag"`` when the traits allow it, else
  ``"unrolled"``.

Every executor runs on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.engine import (BACKENDS, DataflowEngine, EngineResult,
                                     _alu_op, _expand, _truthy, from_carrier,
                                     resolve_device, to_carrier, token_dtype)
from repro_torch.core.graph import Graph, Op

# ---------------------------------------------------------------------------
# Capability probe
# ---------------------------------------------------------------------------
_CONTROL_OPS = (Op.BRANCH, Op.NDMERGE, Op.DMERGE)


@dataclasses.dataclass(frozen=True)
class GraphTraits:
    """What a fabric demands of its executor (the :func:`compile` probe).

    cyclic       — the graph has feedback arcs (the paper's loop schema).
    control_ops  — names of token-routing operators present.  DMERGE
      counts: it consumes only its CHOSEN input token, so under
      data-dependent control the input streams advance unevenly — only
      token-presence execution reproduces that.
    has_inits    — initial-token annotations (one-shot pre-loaded arc
      registers, the loop back-edge delays).

    ``tokens_out_static`` is the lockstep property the "dag" executor
    needs: every stream element fires every node exactly once, so each
    output arc drains exactly one token per input element and the token
    counts are static in the stream length.
    """
    cyclic: bool
    control_ops: tuple[str, ...]
    has_inits: bool

    @classmethod
    def probe(cls, graph: Graph) -> "GraphTraits":
        return cls(
            cyclic=graph.is_cyclic(),
            control_ops=tuple(sorted({n.op.name for n in graph.nodes
                                      if n.op in _CONTROL_OPS})),
            has_inits=bool(graph.inits))

    @property
    def tokens_out_static(self) -> bool:
        return not (self.cyclic or self.control_ops or self.has_inits)

    def blockers(self) -> str:
        """The trait names that rule out lockstep execution."""
        why = []
        if self.cyclic:
            why.append("cyclic=True")
        if self.control_ops:
            why.append(f"control_ops={list(self.control_ops)}")
        if self.has_inits:
            why.append("has_inits=True")
        return ", ".join(why) or "none"


# ---------------------------------------------------------------------------
# DAG (lockstep SSA) executor
# ---------------------------------------------------------------------------
def _dag_program(graph: Graph):
    """(input arcs, output arcs, nodes in topological order, consts) of a
    fabric the lockstep executor takes; raises for one it does not."""
    order = graph.try_topo_order()
    if order is None:
        raise ValueError(f"{graph.name}: cyclic — use compile_cyclic")
    if graph.inits:
        raise ValueError(
            f"{graph.name}: initial-token annotations (has_inits) need "
            "token-presence semantics — use the unrolled executor")
    for n in graph.nodes:
        if n.op in (Op.BRANCH, Op.NDMERGE):
            raise ValueError(
                f"{graph.name}: {n.op.name} requires the cyclic backend")
    return (graph.input_arcs(), graph.output_arcs(),
            [graph.nodes[i] for i in order], dict(graph.consts))


def _dag_eval(nodes, env: dict, dtype, nts: int) -> None:
    """Evaluate ``nodes`` in order into ``env`` (arc -> carrier tensor
    [..., *token_shape]); DMERGE's control is element 0 of its token."""
    for n in nodes:
        a = env[n.inputs[0]]
        if n.op == Op.COPY:
            env[n.outputs[0]] = env[n.outputs[1]] = a
        elif n.op == Op.SINK:
            pass
        elif n.op == Op.DMERGE:
            c = _expand(_truthy(env[n.inputs[2]], nts), nts)
            env[n.outputs[0]] = torch.where(c, a, env[n.inputs[1]])
        else:
            b = env[n.inputs[1]] if len(n.inputs) > 1 else a
            env[n.outputs[0]] = _alu_op(n.op, a, b, dtype)


def compile_dag(graph: Graph, dtype=np.int32, *, device="cuda"):
    """Return ``fn(inputs: dict) -> dict`` evaluating the fabric once on
    one token per input arc (numpy values of ``dtype``; results as
    numpy).

    Supports primitive/decider/copy/dmerge/sink nodes.  ``branch`` and
    ``ndmerge`` (and initial-token annotations) need token-presence
    semantics — use the unrolled executor or an engine backend.
    Note ``dmerge`` here is a pure per-element select (both inputs
    advance together); that matches the engine only when every stream
    element fires every node once, which is why :func:`compile`'s
    auto dispatch sends DMERGE-bearing graphs to the unrolled executor.
    """
    input_arcs, output_arcs, nodes, consts = _dag_program(graph)
    dt, dev = token_dtype(dtype), resolve_device(device)

    @torch.inference_mode()
    def fn(inputs: Mapping[str, object]) -> dict:
        env = {a: to_carrier(inputs[a], dt, dev) for a in input_arcs}
        ts = next(iter(env.values())).shape if env else ()
        for a, v in consts.items():
            env[a] = to_carrier(np.full(ts, v, dt), dt, dev)
        _dag_eval(nodes, env, dt, len(ts))
        return {a: from_carrier(env[a], dt) for a in output_arcs}

    return fn


def compile_dag_stream(graph: Graph, dtype=np.int32, *, device="cuda"):
    """The DAG fabric over a whole token stream at once (throughput
    mode): ``fn(feeds)`` takes arc -> [k, *token_shape] and returns
    arc -> [k, *token_shape] (numpy of ``dtype``).  The stream is the
    leading dimension of every tensor, so one evaluation of the node
    list computes all k elements; const buses broadcast over it."""
    input_arcs, output_arcs, nodes, consts = _dag_program(graph)
    dt, dev = token_dtype(dtype), resolve_device(device)

    @torch.inference_mode()
    def fn(feeds: Mapping[str, object]) -> dict:
        env = {a: to_carrier(feeds[a], dt, dev) for a in input_arcs}
        if not env:
            raise ValueError(f"{graph.name}: the stream executor needs at "
                             "least one input stream")
        shape = next(iter(env.values())).shape      # [k, *token_shape]
        for a, v in consts.items():
            env[a] = to_carrier(np.full((), v, dt), dt, dev).expand(shape)
        _dag_eval(nodes, env, dt, len(shape) - 1)
        return {a: from_carrier(env[a].expand(shape), dt)
                for a in output_arcs}

    return fn


# ---------------------------------------------------------------------------
# Unrolled (token-presence) executor
# ---------------------------------------------------------------------------
def compile_cyclic(graph: Graph, token_shape=(), dtype=np.int32,
                   max_cycles: int = 100_000, *, device="cuda",
                   block_cycles: int = 16):
    """Return ``fn(feeds: dict[str, [k, *ts] stream]) -> EngineResult``
    with the fields of the JAX package's executor: ``outputs``,
    ``counts``, ``cycles`` and ``fired`` (``dispatches`` None, no
    profile).  This is the ``"unrolled"`` executor of :func:`compile`.

    The JAX package unrolls the cycle over the arcs at trace time into
    one XLA program; in eager PyTorch that unroll would be thousands of
    launches per cycle.  So the executor shares the ``"torch"``
    backend's cycle body (:class:`~repro_torch.core.engine.DataflowEngine`
    with ``backend="torch"``, ``optimize=False``: the graph as authored)
    and stops at the first idle cycle or at ``max_cycles``.  It checks
    for idleness once per ``block_cycles`` cycles; idle is absorbing, so
    the cycle of last progress gives the same ``cycles`` as a check every
    cycle."""
    graph.validate()
    eng = DataflowEngine(graph, max_cycles, "torch", block_cycles, device,
                         token_shape=token_shape, dtype=dtype)

    def run(feeds: Mapping[str, object], max_cycles: int = max_cycles):
        res = eng.run(feeds, max_cycles)
        return EngineResult(outputs=res.outputs, counts=res.counts,
                            cycles=res.cycles, fired=res.fired)

    run.engine = eng
    return run


OPTIMIZE_LEVELS = (False, "spec", "full", True, "sched")
BACKENDS_NOTE = "torch | cuda | reference"
EXECUTORS = ("auto", "dag", "unrolled", *BACKENDS)


def compile(graph: Graph, token_shape=(), dtype=np.int32,    # noqa: A001
            max_cycles: int = 100_000, backend: str = "auto",
            block_cycles: int = 16, optimize=False,
            profile: bool = False, partition=None, *, device="cuda"):
    """THE compile pipeline: probe traits, pick a legal executor +
    optimize level, return ``run(feeds) -> EngineResult`` (or the
    stream fn for the "dag" executor).

    backend:
      * ``"auto"``     — ``"dag"`` when ``GraphTraits.tokens_out_static``
        holds, else ``"unrolled"``;
      * ``"dag"``      — lockstep SSA over the stream
        (:func:`compile_dag_stream`).  Raises, naming the blocking
        traits, for any graph that needs token-presence semantics —
        asking for lockstep on such a fabric would silently compute
        wrong token counts, not a slower right answer;
      * ``"unrolled"`` — token-presence execution
        (:func:`compile_cyclic`): cycles, control ops, initial tokens;
      * any :data:`repro_torch.core.engine.BACKENDS` name — a
        cycle-accurate block-fused engine callable (plus ``.engine``
        exposing ``run_batch`` and, on ``"cuda"``, the resumable slot
        API).

    optimize selects the compiler pipeline:
      * ``False``  — run the graph exactly as authored;
      * ``"spec"`` — opcode-class-specialized plan only: a pure layout
        permutation, every EngineResult field bit-identical to the
        unoptimized engine.  Engine backends only (the SSA executors
        have no plan to specialize);
      * ``True`` / ``"full"`` — graph rewrite passes (region-scoped
        constant folding, identity elimination, DCE;
        :func:`repro_torch.core.passes.optimize_graph`) *then* the
        specialized plan where a plan exists.  For fabrics that quiesce
        the surviving output arcs drain bit-identical values and token
        counts while ``cycles``/``fired`` may shrink;
      * ``"sched"`` — everything ``"full"`` does, plus static firing
        schedules (``schedule="auto"``) when the rewritten graph is
        statically schedulable, the dynamic engine otherwise.  Engine
        backends only, bit-identical results either way.

    profile=True turns on the fabric counters: every EngineResult
    carries ``node_fires`` and a :class:`repro_torch.obs.FabricProfile`.
    Engine backends only — the SSA executors have no fabric to count, so
    asking is an error, not a silent no-op.

    partition shards the fabric across regions (DESIGN.md §14):
      * ``None``   — single fabric (default);
      * ``int P``  — :func:`repro_torch.core.partition.partition_graph`
        splits the (post-rewrite) graph into P cost-balanced regions,
        never cutting a loop cycle;
      * ``"auto"`` — :func:`repro_torch.core.partition.auto_partition`
        picks P from the CUDA card count (1 without a card) and the
        graph's size;
      * a :class:`repro_torch.core.partition.Partition` — used as given
        (validated).
    A resolved P > 1 partition needs a cycle-accurate engine: with
    ``backend="auto"`` it routes to ``"cuda"`` for scalar int32 tokens
    and to ``"torch"`` otherwise (where the JAX package routes to
    ``"xla"``); asking for ``"dag"``/``"unrolled"`` raises.  Execution
    stays bit-identical to the single-fabric engine in every EngineResult
    field.  P = 1 (or an ``"auto"`` resolution of 1) is the ordinary
    pipeline.  ``device`` is where every executor runs (the card unless
    ``"cpu"`` is asked for).

    The returned callable exposes the (possibly rewritten) graph as
    ``.graph``, the rewrite report as ``.report`` (None when no
    rewrites ran), the capability probe as ``.traits``, the executor it
    resolved to as ``.executor`` and the resolved partition (or None) as
    ``.partition``.
    """
    if block_cycles < 1:
        raise ValueError(
            f"block_cycles must be >= 1, got {block_cycles}")
    if optimize not in OPTIMIZE_LEVELS:
        raise ValueError(f"optimize {optimize!r} not in {OPTIMIZE_LEVELS}")
    if backend not in EXECUTORS:
        raise ValueError(f"backend {backend!r} not in {EXECUTORS}")
    if optimize in ("spec", "sched") and backend in ("auto", "dag",
                                                     "unrolled"):
        # specialization/scheduling is plan-level; the SSA executors
        # have no plan, so either would silently measure an
        # unoptimized runner
        raise ValueError(
            f'optimize={optimize!r} needs an engine backend '
            f'({BACKENDS_NOTE}); backend={backend!r} only supports the '
            'rewrite pipeline (optimize="full"/True)')
    if profile and backend not in BACKENDS and not (
            backend == "auto" and partition is not None):
        # (auto + partition defers: a resolved P>1 routes to an engine)
        raise ValueError(
            f"profile=True needs an engine backend ({BACKENDS_NOTE}); "
            f"backend={backend!r} runs SSA semantics with no fabric "
            "cycles to count")
    dt = token_dtype(dtype)
    resolve_device(device)
    report = None
    if optimize in (True, "full", "sched"):
        from repro_torch.core import passes
        graph, report = passes.optimize_graph(graph, dtype=dt)
    traits = GraphTraits.probe(graph)
    part = None
    if partition is not None:
        # resolve against the post-rewrite graph: node indices in the
        # assignment must name the fabric that actually runs
        from repro_torch.core.partition import resolve_partition
        part = resolve_partition(graph, partition)
    if part is not None and part.P > 1:
        if backend in ("dag", "unrolled"):
            raise ValueError(
                f"{graph.name}: partition={partition!r} needs a "
                f"cycle-accurate engine backend ({BACKENDS_NOTE}); the "
                f"{backend!r} SSA executor has no fabric to shard")
        if backend == "auto":
            # the sharded block kernel takes scalar int32 tokens; the
            # stacked PyTorch program every other dtype
            backend = "cuda" if tuple(token_shape) == () \
                and dt == np.int32 else "torch"
    if backend == "auto":
        backend = "dag" if traits.tokens_out_static else "unrolled"
        if profile and backend not in BACKENDS:
            # the deferred check above: partition resolved to P=1, so
            # auto landed on an SSA executor after all
            raise ValueError(
                f"profile=True needs an engine backend ({BACKENDS_NOTE});"
                f" backend={backend!r} runs SSA semantics with no fabric "
                "cycles to count")
    if backend == "dag" and not traits.tokens_out_static:
        raise ValueError(
            f"{graph.name}: backend='dag' runs lockstep SSA semantics "
            f"(one firing per node per stream element), but the "
            f"GraphTraits probe found {traits.blockers()} — these need "
            f"token-presence execution: backend='unrolled' or an "
            f"engine backend ({BACKENDS_NOTE})")
    if backend in BACKENDS:
        eng = DataflowEngine(graph, max_cycles, backend, block_cycles,
                             device, optimize=optimize is not False,
                             profile=profile,
                             schedule="auto" if optimize == "sched"
                             else False, token_shape=token_shape, dtype=dt,
                             partition=part)
        run = lambda feeds, max_cycles=None: eng.run(feeds, max_cycles)
        run.engine = eng
    elif backend == "unrolled":
        # DMERGE joins BRANCH/NDMERGE in needing this executor: the
        # lockstep DMERGE is a pure per-element select (both input streams
        # advance in lockstep), but the engine's DMERGE consumes only the
        # CHOSEN input token, so the streams advance unevenly under
        # data-dependent control — only token-presence execution
        # reproduces that
        run = compile_cyclic(graph, token_shape, dt, max_cycles,
                             device=device, block_cycles=block_cycles)
    else:
        fn = compile_dag_stream(graph, dt, device=device)
        run = lambda feeds: fn(feeds)
    run.graph = graph
    run.report = report
    run.traits = traits
    run.partition = part
    run.executor = backend
    return run


def compile_graph(graph: Graph, token_shape=(), dtype=np.int32,
                  max_cycles: int = 100_000, backend: str = "auto",
                  block_cycles: int = 16, optimize=False,
                  profile: bool = False, partition=None, *, device="cuda"):
    """The historical name of :func:`compile` (a thin wrapper)."""
    return compile(graph, token_shape, dtype, max_cycles, backend,
                   block_cycles, optimize, profile, partition,
                   device=device)


def compile_fn(fn, *avals, backend: str = "cuda", block_cycles: int = 16,
               optimize=False, max_cycles: int = 100_000,
               name: str | None = None, const_args: dict | None = None,
               profile: bool = False, device="cuda"):
    """Trace a scalar torch program (:func:`repro_torch.front.trace`) and
    hand the synthesized fabric to :func:`compile` in one step.

    The fabric is routed through the :class:`GraphTraits` probe like
    any other graph, so a traced program that needs token-presence
    semantics (loops, ``torch.where`` control, initial tokens) either
    gets an executor that provides them (the default ``backend="cuda"``
    engine and ``"auto"`` both do) or a precise error naming the
    blocking trait — never a silently-lockstep compilation.  The
    execution dtype is the avals' common dtype; ``"cuda"`` runs int32
    only and raises for another, naming ``backend="torch"``.

    Returns the executor callable with the frontend bookkeeping
    attached: ``run.make_feeds(*streams)`` is the positional feed
    adapter, ``run.out_arcs`` the result arcs in return order,
    ``run.traced`` the :class:`~repro_torch.front.TracedProgram` as
    authored (``run.graph`` is the post-rewrite fabric when
    ``optimize`` folds it)::

        run = compile_fn(lambda x, y: torch.where(x > y, x - y, y - x),
                         np.int32, np.int32, optimize="full")
        res = run(run.make_feeds([5, 1], [2, 9]))
        res.outputs[run.out_arcs[0]]        # -> 8 (last token)
    """
    from repro_torch.front import trace
    prog = trace(fn, *avals, name=name, const_args=const_args)
    run = compile(prog, token_shape=(), dtype=prog.dtype,
                  max_cycles=max_cycles, backend=backend,
                  block_cycles=block_cycles, optimize=optimize,
                  profile=profile, device=device)
    run.traced = prog
    run.make_feeds = prog.make_feeds
    run.out_arcs = list(prog.out_arcs)
    return run
