"""Continuous-batching dataflow serving: per-slot stream lifecycle.

A :class:`DataflowServer` owns a request queue and B live *slots* on one
block-fused fabric (the engine's resumable slot API).  After each
K-cycle block it detects per-slot quiescence (idle block tail — idle is
absorbing), harvests finished requests, and refills those slots from the
queue *while the other slots keep running*; free and quiesced slots are
clock-gated out of feed/fire/drain by the kernel's per-stream ``active``
gate.

Determinism: admissions happen only at block boundaries and each slot
carries its own cycle clock, so every request's
:class:`~repro_torch.core.engine.EngineResult` is bit-identical to
running it alone via ``DataflowEngine.run`` — regardless of what rides
the other slots or of admission order.

Admission control: ``max_queue`` + ``policy`` ("reject" | "block" |
"drop-oldest") with round-robin fairness across ``Request.tenant`` keys
(:mod:`repro_torch.serve.admission`); ``Request.deadline_blocks``
expires a request (queued or resident); ``Request.max_cycles``
overrides the engine cap per slot; a stall watchdog force-harvests a
slot whose progress counters freeze for ``wedge_timeout_blocks``.

Faults and observability: a seeded
:class:`~repro_torch.serve.faults.FaultPlan` (``faults=``) injects
compile and dispatch failures, wedged slots and poisoned feeds; an
injected dispatch failure is retried (``max_retries``), and one that
outlives its retries answers every resident request with a typed error
``Result`` while the queue goes on being served; the failed attempts
count on towards the same block, so a transient fault clears on a later
heartbeat.  ``retry_backoff_s`` keeps the JAX constructor's signature:
the port retries only injected faults, which clear by attempt count and
never by time, so its exponential sleep adds wall time between retries
and changes no result, block-clock trace or metric.  ``trace=`` (a
:class:`~repro_torch.obs.TraceRecorder`) records every lifecycle edge on
the block clock, ``metrics=`` (a :class:`~repro_torch.obs.MetricsRegistry`)
counts them; ``events`` logs retries, failures, poisons and drops.

What the JAX package's server does and this one does not: it has no
degradation chain and no reference mode (a backend that fails is not
swapped for a slower one that hides the card), and it retries nothing
but injected faults.  A real launch failure raises at once, unretried:
a failed CUDA launch can leave the context unusable, and a retry would
hide that.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
import time
from typing import Iterable, Mapping

import numpy as np

from repro_torch.core import asm
from repro_torch.core.engine import DataflowEngine
from repro_torch.core.graph import Graph
from repro_torch.core.partition import resolve_partition
from repro_torch.serve.admission import (POLICIES, DroppedError, FairQueue,
                                         QueueFullError, Rejected)
from repro_torch.serve.faults import InjectedFault
from repro_torch.serve.types import (InvalidRequestError, Request,
                                     RequestMetrics, Result)

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Compiled-plan cache: many requests, one fabric
# ---------------------------------------------------------------------------
_ENGINE_CACHE: "collections.OrderedDict[tuple, DataflowEngine]" = \
    collections.OrderedDict()
_ENGINE_CACHE_MAX = 64      # LRU bound: a long-running service sees a
                            # finite fabric vocabulary; evicted engines
                            # stay alive wherever still referenced


def graph_signature(graph: Graph) -> str:
    """Canonical text of a fabric (assembler emission: consts + node
    table with arc labels).  Two graphs with equal signatures compile
    to identical plans, so their requests can share one engine."""
    return asm.emit(graph)


def cached_engine(graph: Graph, *, block_cycles: int = 16,
                  max_cycles: int = 100_000, device="cuda",
                  optimize: bool = False, profile: bool = False,
                  schedule: bool | str = False,
                  partition=None) -> DataflowEngine:
    """Engine for (graph signature, K, max_cycles, device, optimize,
    profile, schedule, partition) — built once and shared by every server
    that presents the same fabric (the key hashes the signature, not the
    graph object, so structurally equal graphs share).  The flags join the
    key: an optimized engine runs other tables, a profiled engine threads
    counters through every step, a scheduled engine runs other kernels,
    and a partitioned engine runs the sharded block over state that
    carries channel registers, so none may stand in for another's
    (``schedule`` keys as ``str(schedule)``: True and "auto" stay apart).
    The partition keys as ``Partition.spec()`` (region count and
    assignment hash), so two region assignments never alias; a P = 1
    partition keys as unsharded, since it is the same engine."""
    part = resolve_partition(graph, partition)
    if part is not None and part.P <= 1:
        part = None            # degenerate: same engine as unsharded
    key = (hashlib.sha256(graph_signature(graph).encode()).hexdigest(),
           int(block_cycles), int(max_cycles), str(device), bool(optimize),
           bool(profile), str(schedule),
           "none" if part is None else part.spec())
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        eng = DataflowEngine(graph, max_cycles=max_cycles,
                             block_cycles=block_cycles, device=device,
                             optimize=optimize, profile=profile,
                             schedule=schedule, partition=part)
        _ENGINE_CACHE[key] = eng
        while len(_ENGINE_CACHE) > _ENGINE_CACHE_MAX:
            _ENGINE_CACHE.popitem(last=False)
    else:
        _ENGINE_CACHE.move_to_end(key)
    return eng


def clear_engine_cache() -> None:
    _ENGINE_CACHE.clear()


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------
class DataflowServer:
    """Request-level continuous batching over one block-fused fabric.

    Usage::

        srv = DataflowServer(graph, slots=8, block_cycles=16,
                             max_queue=64, policy="reject",
                             optimize=True, profile=True)
        srv.submit(feeds_a)            # returns uid (or typed Rejected)
        srv.submit(Request(uid=7, feeds=feeds_b, deadline_blocks=50))
        done = srv.step()              # one K-cycle block; may finish 0+
        rest = srv.drain()             # run until queue + slots empty

    ``step()`` is the scheduler heartbeat: expire deadline-blown
    requests, force-harvest budget-exhausted and wedged slots, admit
    from the queue into free slots (round-robin across tenants),
    advance every active slot by one K-cycle block (one kernel launch),
    harvest slots whose block had an idle tail.  Every submitted
    request receives exactly one :class:`Result` (value, truncated,
    expired, wedged, or a typed error: a drop, or an injected dispatch
    fault that outlived ``max_retries``).

    ``optimize=True`` serves every slot from the opcode-class-specialized
    plan; ``profile=True`` carries the fabric counters through every
    block, so each harvested ``Result.engine.profile`` is a
    :class:`~repro_torch.obs.FabricProfile` of that request's residency.
    ``schedule=True`` (or ``"auto"``) steps a control-free fabric's slots
    from its static firing schedule (one launch of the scheduled
    slot-step kernel per block, no device read per block).  None of the
    three changes a result.  ``partition=`` (None, an int P, ``"auto"``
    or a :class:`~repro_torch.core.partition.Partition`) serves the fabric
    sharded into P regions: each block one launch of the sharded block
    kernel, every result the solo fabric's.  An explicit ``engine=``
    decides all four.

    ``faults=`` takes a :class:`~repro_torch.serve.faults.FaultPlan`,
    ``trace=`` a :class:`~repro_torch.obs.TraceRecorder` and
    ``metrics=`` a :class:`~repro_torch.obs.MetricsRegistry`; left at
    None, each costs one ``is None`` test where it would record.  A
    planned compile fault raises :class:`~repro_torch.serve.faults.
    CompileFault` from the constructor (there is no backend to fall to).
    """

    def __init__(self, graph: Graph, slots: int = 8,
                 block_cycles: int = 16, max_cycles: int = 100_000,
                 engine: DataflowEngine | None = None,
                 max_queue: int | None = None, policy: str = "reject",
                 wedge_timeout_blocks: int = 32, device="cuda",
                 optimize: bool = False, profile: bool = False,
                 schedule: bool | str = False, max_retries: int = 3,
                 retry_backoff_s: float = 0.0, faults=None, trace=None,
                 metrics=None, partition=None):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None: unbounded)")
        if wedge_timeout_blocks < 1:
            raise ValueError("wedge_timeout_blocks must be >= 1")
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.faults = faults
        self.trace = trace
        self.metrics = metrics
        self._gauged_tenants: set[str] = set()
        self.block = 0            # server block clock (launches issued)
        if faults is not None and trace is not None \
                and getattr(faults, "notify", None) is None:
            # injected faults land on the trace timeline next to the
            # lifecycle events they cause
            faults.notify = lambda kind, *key: self._trace(
                "fault", injected=kind, key=list(map(str, key)))
        if engine is not None:
            # an explicit engine wins over block_cycles/max_cycles
            # (block size is a perf knob, never a semantics one), but it
            # must serve THIS fabric — a mismatched plan would silently
            # produce another graph's results
            if graph_signature(engine.graph) != graph_signature(graph):
                raise ValueError(
                    "engine= was built for a different fabric "
                    f"({engine.graph.name!r}, not {graph.name!r})")
        else:
            if faults is not None:
                faults.check_compile("cuda")
            engine = cached_engine(graph, block_cycles=block_cycles,
                                   max_cycles=max_cycles, device=device,
                                   optimize=optimize, profile=profile,
                                   schedule=schedule, partition=partition)
        self.graph = graph
        self.slots = slots
        self.engine = engine
        self.max_cycles = engine.max_cycles
        self.max_queue = max_queue
        self.policy = policy
        self.wedge_timeout_blocks = int(wedge_timeout_blocks)
        self._input_arcs = tuple(graph.input_arcs())
        self.queue = FairQueue()
        self.admission_rounds = 0  # fused reset launches issued
        self.max_queue_depth = 0   # high-water mark of the queue
        self.events: list[dict] = []   # retries/failures/poisons/drops log
        self._queued_at: dict[int, int] = {}     # uid -> block at submit
        self._resident: dict[int, tuple[Request, int]] = {}  # slot -> (req, admitted)
        self._retries: dict[int, int] = {}       # uid -> dispatch retries
        self._attempt = 0          # failed launches of the current block
        self._wedge_traced: set[int] = set()     # first-wedge trace dedupe
        self._done: list[Result] = []  # results finished out-of-band
        #                                (drops, blocking-submit pumps)
        self._auto_uid = 0
        self.state = engine.init_state(slots)

    def _log_event(self, kind: str, **kw) -> None:
        ev = dict(kind=kind, block=self.block, **kw)
        self.events.append(ev)
        log.warning("dataflow-server %s: %s", kind, kw)

    # -- observability plumbing (no-ops when trace/metrics are None) ----
    def _trace(self, kind: str, *, uid=None, slot=None, tenant=None,
               status=None, **args) -> None:
        """Record one lifecycle event at the server's block clock."""
        if self.trace is not None:
            self.trace.record(
                kind, block=self.block, uid=uid, slot=slot,
                tenant=None if tenant is None else str(tenant),
                status=status, **args)

    def _count(self, name: str, n: int = 1, **labels) -> None:
        if self.metrics is not None:
            self.metrics.counter(name, **labels).inc(n)

    def _update_queue_metrics(self) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge("queue_depth").set(len(self.queue))
        depths = {str(t): d for t, d in self.queue.depths().items()}
        self._gauged_tenants |= set(depths)
        for t in self._gauged_tenants:
            self.metrics.gauge("queue_depth", tenant=t).set(
                depths.get(t, 0))

    def _observe_result(self, res: Result) -> Result:
        """Per-request terminal accounting — every Result passes
        through here exactly once, whichever path produced it."""
        if self.metrics is None:
            return res
        self._count("requests_finished", status=res.status)
        m = res.metrics
        if m is not None:
            self.metrics.histogram("queue_wait_blocks").observe(
                m.queue_wait_blocks)
            if m.residency_cycles:
                self.metrics.histogram("residency_cycles").observe(
                    m.residency_cycles)
            if m.backend:
                self._count("requests_served", backend=m.backend)
        return res

    @property
    def backend(self) -> str:
        """The serving engine's backend (always ``"cuda"``: the slot API
        runs on no other)."""
        return self.engine.backend

    @classmethod
    def for_fn(cls, fn, *avals, const_args=None, name=None,
               **server_kw) -> "DataflowServer":
        """Serve a traced Python program: lower ``fn`` through the
        :mod:`repro_torch.front` frontend and build the server on the
        synthesized fabric.  A traced program is just another asm
        signature to the engine cache, so structurally equal traces
        (across servers, across processes re-tracing the same source)
        share one engine.  The program's positional feed adapter rides
        along as ``server.make_feeds``, the program as ``server.traced``::

            srv = DataflowServer.for_fn(
                lambda x, y: torch.where(x > y, x - y, y - x),
                np.int32, np.int32, slots=8)
            srv.submit(srv.make_feeds([5, 1], [2, 9]))

        The trace runs once, here, before the first request.
        """
        from repro_torch.front import trace
        prog = trace(fn, *avals, name=name, const_args=const_args)
        srv = cls(prog, **server_kw)
        srv.traced = prog
        srv.make_feeds = prog.make_feeds
        return srv

    def submit_args(self, *args) -> int:
        """Submit one *evaluation* of a traced program (``for_fn``
        servers): ``make_feeds(*args)`` + ``submit`` in one step.  This
        is the natural request shape for loop fabrics (DESIGN.md §10):
        one initiation per request, data-dependent trip count inside
        the slot, per-slot quiescence detection ending it — requests
        that never quiesce are force-harvested at their cycle cap with
        ``metrics.truncated`` set."""
        if not hasattr(self, "make_feeds"):
            raise AttributeError(
                "submit_args needs a server built by for_fn (only "
                "traced programs carry a positional feed adapter)")
        return self.submit(self.make_feeds(*args))

    # -- admission ------------------------------------------------------
    def submit(self, request):
        """Enqueue a request (a :class:`Request` or a bare feeds dict);
        returns its uid, or a typed :class:`Rejected` when the queue is
        at ``max_queue`` under ``policy="reject"``.  uids must be
        unique among in-flight requests — auto-assigned ones skip any
        the caller has taken."""
        if isinstance(request, Mapping) or request is None:
            while self._auto_uid + 1 in self._queued_at:
                self._auto_uid += 1
            self._auto_uid += 1
            request = Request(uid=self._auto_uid, feeds=dict(request or {}))
        if not isinstance(request, Request):
            raise TypeError(f"submit wants a Request or feeds dict, "
                            f"got {type(request).__name__}")
        # a deadline or cycle budget below 1 could never run
        if request.deadline_blocks is not None \
                and request.deadline_blocks < 1:
            raise InvalidRequestError(
                f"request {request.uid}: deadline_blocks must be >= 1, "
                f"got {request.deadline_blocks}")
        if request.max_cycles is not None and request.max_cycles < 1:
            raise InvalidRequestError(
                f"request {request.uid}: max_cycles must be >= 1, "
                f"got {request.max_cycles}")
        if request.feeds is None:
            raise ValueError(f"request {request.uid} has no feeds — the "
                             "dataflow server serves feed-stream requests")
        if request.uid in self._queued_at:
            raise ValueError(f"uid {request.uid} is already in flight")
        # fail fast on feeds the fabric cannot take: unknown arcs have
        # nowhere to go; MISSING arcs would strand the fabric waiting on
        # tokens that never arrive
        unknown = set(request.feeds) - set(self._input_arcs)
        if unknown:
            raise ValueError(f"request {request.uid}: feeds for "
                             f"non-input arcs: {sorted(unknown)}")
        missing = [a for a in self._input_arcs if a not in request.feeds]
        if missing:
            raise ValueError(
                f"request {request.uid}: missing feeds for input arcs "
                f"{missing} — every input arc needs a stream")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.policy == "reject":
                self._trace("reject", uid=request.uid,
                            tenant=request.tenant,
                            queue_depth=len(self.queue))
                self._count("requests_rejected",
                            tenant=str(request.tenant))
                return Rejected(uid=request.uid,
                                reason=f"queue full ({self.max_queue})",
                                queue_depth=len(self.queue),
                                tenant=request.tenant)
            if self.policy == "drop-oldest":
                victim = self.queue.drop_oldest()
                queued = self._queued_at.pop(victim.uid)
                self._retries.pop(victim.uid, None)
                self._log_event("drop-oldest", uid=victim.uid,
                                tenant=victim.tenant)
                self._trace("drop", uid=victim.uid, tenant=victim.tenant,
                            status="error")
                self._count("requests_dropped", tenant=str(victim.tenant))
                self._done.append(self._observe_result(Result(
                    uid=victim.uid,
                    error=DroppedError(
                        f"request {victim.uid} dropped by admission "
                        f"(queue full at {self.max_queue}, "
                        f"policy=drop-oldest)"),
                    metrics=self._queue_only_metrics(queued))))
            else:       # "block": the submitting host pumps heartbeats
                guard = 0
                while len(self.queue) >= self.max_queue:
                    self._done.extend(self._step_inner())
                    guard += 1
                    if guard > 1_000_000:
                        raise QueueFullError(
                            "blocking submit pumped 1e6 heartbeats "
                            "without a queue slot freeing")
        if self.faults is not None and request.feeds:
            # the slot API serves int32 tokens only
            poisoned = self.faults.poison(request.feeds, request.uid,
                                          np.int32)
            if poisoned is not request.feeds:
                self._log_event("poison", uid=request.uid)
                self._trace("poison", uid=request.uid,
                            tenant=request.tenant)
                request = dataclasses.replace(request, feeds=poisoned)
        self.queue.push(request)
        self._queued_at[request.uid] = self.block
        self.max_queue_depth = max(self.max_queue_depth, len(self.queue))
        self._trace("submit", uid=request.uid, tenant=request.tenant,
                    queue_depth=len(self.queue))
        self._count("requests_submitted", tenant=str(request.tenant))
        self._update_queue_metrics()
        return request.uid

    def _queue_only_metrics(self, queued: int,
                            expired: bool = False) -> RequestMetrics:
        """Metrics for a request that never reached a slot (dropped or
        expired while queued): slot == -1, no residency."""
        return RequestMetrics(
            slot=-1, queued_block=queued, admitted_block=-1,
            finished_block=self.block,
            queue_wait_blocks=self.block - queued,
            residency_blocks=0, residency_cycles=0, tokens_out=0,
            expired=expired, backend="")

    def _admit(self) -> None:
        free = self.state.free_slots()
        batch: list[tuple[int, Request]] = []
        while free and self.queue:
            batch.append((free.pop(0), self.queue.pop()))
        if batch:
            self.state = self.engine.reset_slots(
                self.state, [b for b, _ in batch],
                [r.feeds for _, r in batch],
                caps=[r.max_cycles for _, r in batch])
            self.admission_rounds += 1
            for b, r in batch:
                self._resident[b] = (r, self.block)
                self._trace("admit", uid=r.uid, slot=b, tenant=r.tenant,
                            queue_wait_blocks=self.block
                            - self._queued_at[r.uid])
                self._count("requests_admitted", tenant=str(r.tenant))
            self._update_queue_metrics()

    # -- heartbeat ------------------------------------------------------
    def step(self) -> list[Result]:
        """One scheduler heartbeat; returns the requests that finished
        (possibly none) — including any completed out-of-band since the
        last call (queue drops, blocking-submit pumps).

        A heartbeat's block never lets any slot cross its cycle cap
        (engine ``max_cycles`` or ``Request.max_cycles``): it is
        shortened to the smallest remaining per-slot budget, so even a
        truncated request simulates exactly its cap, bit-identical to a
        solo ``run`` under the same cap."""
        done, self._done = self._done, []
        return done + self._step_inner()

    def _step_inner(self) -> list[Result]:
        results = self._expire_queued()
        # 1. deadline / budget / watchdog exits on resident slots
        #    (precedence: expired > truncated > wedged)
        results += self._harvest_slots(
            [b for b in sorted(self._resident)
             if not self.state.quiesced[b] and self._deadline_blown(b)],
            kind="expired")
        results += self._harvest_slots(
            [b for b in sorted(self._resident)
             if not self.state.quiesced[b]
             and self.state.base[b] >= self.state.cap[b]],
            kind="truncated")
        results += self._harvest_slots(
            [b for b in sorted(self._resident)
             if int(self.state.stalled[b]) >= self.wedge_timeout_blocks],
            kind="wedged")
        # 2. admission (round-robin across tenants)
        self._admit()
        if not self._resident:
            return results
        # 3. advance one block, retrying injected faults
        n_cycles = min(
            self.engine.block_cycles,
            min(int(self.state.cap[b]) - int(self.state.base[b])
                for b in self._resident))
        try:
            self.state = self._dispatch_block(n_cycles)
        except InjectedFault as e:      # retries exhausted: answer them
            return results + self._fail_residents(e)
        self.block += 1
        self._count("dispatches", backend=self.engine.backend)
        # 4. harvest quiesced slots; a fault-wedged request's quiescence
        #    signal is suppressed (the slot stalls until the watchdog)
        done = self.state.quiesced_slots()
        if self.faults is not None:
            wedged = [b for b in done
                      if self.faults.wedge(self._resident[b][0].uid)]
            for b in wedged:
                self.state.quiesced[b] = False
                req = self._resident[b][0]
                if req.uid not in self._wedge_traced:
                    # wedging suppresses quiescence every block; trace
                    # only the first suppression per request
                    self._wedge_traced.add(req.uid)
                    self._trace("wedge", uid=req.uid, slot=b,
                                tenant=req.tenant)
            done = [b for b in done if b not in wedged]
        return results + self._harvest_slots(done)

    def _deadline_blown(self, b: int) -> bool:
        req, _ = self._resident[b]
        return (req.deadline_blocks is not None
                and self.block - self._queued_at[req.uid]
                >= req.deadline_blocks)

    def _expire_queued(self) -> list[Result]:
        """Deadline sweep over the queue: requests whose budget elapsed
        before admission are answered as expired without ever touching
        a slot."""
        expired = self.queue.remove_if(
            lambda r: r.deadline_blocks is not None
            and self.block - self._queued_at[r.uid] >= r.deadline_blocks)
        results = []
        for r in expired:
            queued = self._queued_at.pop(r.uid)
            self._retries.pop(r.uid, None)
            self._trace("expire", uid=r.uid, tenant=r.tenant,
                        status="expired", queued_block=queued)
            results.append(self._observe_result(Result(
                uid=r.uid,
                metrics=self._queue_only_metrics(queued, expired=True))))
        if expired:
            self._update_queue_metrics()
        return results

    def _dispatch_block(self, n_cycles: int):
        """One block launch, retried on injected faults; raises once a
        heartbeat has spent ``max_retries`` retries (the caller answers
        the residents).  The attempts are counted per block across
        heartbeats (``_attempt``), so a transient fault that outlives one
        heartbeat's retries clears on a later one, as ``FaultPlan``
        plans it.  Only an :class:`InjectedFault` is retried: any other
        exception from ``step_block`` propagates at once, since a failed
        CUDA launch can leave the context unusable and a retry would
        hide that."""
        tries = 0
        while True:
            try:
                if self.faults is not None:
                    err = self.faults.dispatch_error(
                        self.engine.backend, self.block, self._attempt)
                    if err is not None:
                        raise err
                state = self.engine.step_block(self.state,
                                               n_cycles=n_cycles)
                self._attempt = 0
                return state
            except InjectedFault as e:
                self._attempt += 1
                attempt = self._attempt
                tries += 1
                if tries > self.max_retries:
                    raise
                for req, _ in self._resident.values():
                    self._retries[req.uid] = \
                        self._retries.get(req.uid, 0) + 1
                self._log_event("dispatch-retry", attempt=attempt,
                                backend=self.engine.backend,
                                error=repr(e))
                self._trace("retry", attempt=attempt,
                            backend=self.engine.backend, error=repr(e))
                self._count("dispatch_retries",
                            backend=self.engine.backend)
                if self.retry_backoff_s > 0.0:
                    time.sleep(self.retry_backoff_s * 2 ** (tries - 1))

    def _fail_residents(self, err: InjectedFault) -> list[Result]:
        """An injected fault outlived its retries: harvest every resident
        slot as it stood after the last good block (the state the failed
        launch never replaced) and answer each request with the fault.
        The block clock does not advance and its failed attempts count
        on, so the queue goes on being served and a transient fault
        clears at a later heartbeat's launch."""
        seats = sorted(self._resident)
        self._log_event("dispatch-failed", backend=self.engine.backend,
                        error=repr(err),
                        uids=[self._resident[b][0].uid for b in seats])
        return self._harvest_slots(seats, error=err)

    def _harvest_slots(self, done: list[int], kind: str = "ok",
                       error: Exception | None = None) -> list[Result]:
        if not done:
            return []
        self.state, engine_results = self.engine.harvest(self.state, done)
        results = []
        for b, er in zip(done, engine_results):
            req, admitted = self._resident.pop(b)
            # strict: a uid resident in a slot MUST have submit-time
            # accounting; a silent fallback would mask a bookkeeping bug
            queued = self._queued_at.pop(req.uid)
            self._wedge_traced.discard(req.uid)
            res = Result(
                uid=req.uid, engine=er, error=error,
                metrics=RequestMetrics(
                    slot=b, queued_block=queued, admitted_block=admitted,
                    finished_block=self.block,
                    queue_wait_blocks=admitted - queued,
                    residency_blocks=er.dispatches,
                    residency_cycles=er.cycles,
                    tokens_out=sum(er.counts.values()),
                    truncated=kind == "truncated",
                    expired=kind == "expired",
                    wedged=kind == "wedged",
                    retries=self._retries.pop(req.uid, 0),
                    backend=self.engine.backend))
            self._trace("harvest", uid=req.uid, slot=b, tenant=req.tenant,
                        status=res.status, cycles=er.cycles,
                        fired=er.fired, tokens_out=res.metrics.tokens_out,
                        backend=self.engine.backend)
            results.append(self._observe_result(res))
        return results

    def drain(self) -> list[Result]:
        """Step until the queue and every slot are empty."""
        out: list[Result] = []
        while self.queue or self._resident or self._done:
            out.extend(self.step())
        return out

    def run(self, requests: Iterable) -> list[Result]:
        """Serve a closed workload: submit everything, drain, return
        results sorted by uid."""
        for r in requests:
            self.submit(r)
        return sorted(self.drain(), key=lambda r: r.uid)

    @property
    def pending(self) -> int:
        return len(self.queue) + len(self._resident) + len(self._done)
