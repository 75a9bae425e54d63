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
slot whose progress counters freeze for ``wedge_timeout_blocks``.  A
failed launch raises: this server has no fallback backend.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Iterable, Mapping

from repro_torch.core import asm
from repro_torch.core.engine import DataflowEngine
from repro_torch.core.graph import Graph
from repro_torch.serve.admission import (POLICIES, DroppedError, FairQueue,
                                         QueueFullError, Rejected)
from repro_torch.serve.types import (InvalidRequestError, Request,
                                     RequestMetrics, Result)

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
                  schedule: bool | str = False) -> DataflowEngine:
    """Engine for (graph signature, K, max_cycles, device, optimize,
    profile, schedule) — built once and shared by every server that
    presents the same fabric (the key hashes the signature, not the graph
    object, so structurally equal graphs share).  The flags join the key:
    an optimized engine runs other tables, a profiled engine threads
    counters through every step, and a scheduled engine runs other
    kernels, so none may stand in for another's (``schedule`` keys as
    ``str(schedule)``: True and "auto" stay apart)."""
    key = (hashlib.sha256(graph_signature(graph).encode()).hexdigest(),
           int(block_cycles), int(max_cycles), str(device), bool(optimize),
           bool(profile), str(schedule))
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        eng = DataflowEngine(graph, max_cycles=max_cycles,
                             block_cycles=block_cycles, device=device,
                             optimize=optimize, profile=profile,
                             schedule=schedule)
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
    expired, wedged, or a typed drop).

    ``optimize=True`` serves every slot from the opcode-class-specialized
    plan; ``profile=True`` carries the fabric counters through every
    block, so each harvested ``Result.engine.profile`` is a
    :class:`~repro_torch.obs.FabricProfile` of that request's residency.
    ``schedule=True`` (or ``"auto"``) steps a control-free fabric's slots
    from its static firing schedule (one launch of the scheduled
    slot-step kernel per block, no device read per block).  None of the
    three changes a result.  An explicit ``engine=`` decides all three.
    """

    def __init__(self, graph: Graph, slots: int = 8,
                 block_cycles: int = 16, max_cycles: int = 100_000,
                 engine: DataflowEngine | None = None,
                 max_queue: int | None = None, policy: str = "reject",
                 wedge_timeout_blocks: int = 32, device="cuda",
                 optimize: bool = False, profile: bool = False,
                 schedule: bool | str = False):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None: unbounded)")
        if wedge_timeout_blocks < 1:
            raise ValueError("wedge_timeout_blocks must be >= 1")
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
            engine = cached_engine(graph, block_cycles=block_cycles,
                                   max_cycles=max_cycles, device=device,
                                   optimize=optimize, profile=profile,
                                   schedule=schedule)
        self.graph = graph
        self.slots = slots
        self.engine = engine
        self.max_cycles = engine.max_cycles
        self.max_queue = max_queue
        self.policy = policy
        self.wedge_timeout_blocks = int(wedge_timeout_blocks)
        self._input_arcs = tuple(graph.input_arcs())
        self.queue = FairQueue()
        self.block = 0            # server block clock (launches issued)
        self._queued_at: dict[int, int] = {}     # uid -> block at submit
        self._resident: dict[int, tuple[Request, int]] = {}  # slot -> (req, admitted)
        self._done: list[Result] = []  # results finished out-of-band
        #                                (drops, blocking-submit pumps)
        self._auto_uid = 0
        self.state = engine.init_state(slots)

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
                return Rejected(uid=request.uid,
                                reason=f"queue full ({self.max_queue})",
                                queue_depth=len(self.queue),
                                tenant=request.tenant)
            if self.policy == "drop-oldest":
                victim = self.queue.drop_oldest()
                queued = self._queued_at.pop(victim.uid)
                self._done.append(Result(
                    uid=victim.uid,
                    error=DroppedError(
                        f"request {victim.uid} dropped by admission "
                        f"(queue full at {self.max_queue}, "
                        f"policy=drop-oldest)"),
                    metrics=self._queue_only_metrics(queued)))
            else:       # "block": the submitting host pumps heartbeats
                guard = 0
                while len(self.queue) >= self.max_queue:
                    self._done.extend(self._step_inner())
                    guard += 1
                    if guard > 1_000_000:
                        raise QueueFullError(
                            "blocking submit pumped 1e6 heartbeats "
                            "without a queue slot freeing")
        self.queue.push(request)
        self._queued_at[request.uid] = self.block
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
            for b, r in batch:
                self._resident[b] = (r, self.block)

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
        # 3. advance one block
        n_cycles = min(
            self.engine.block_cycles,
            min(int(self.state.cap[b]) - int(self.state.base[b])
                for b in self._resident))
        self.state = self.engine.step_block(self.state, n_cycles=n_cycles)
        self.block += 1
        # 4. harvest quiesced slots
        return results + self._harvest_slots(self.state.quiesced_slots())

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
        return [Result(uid=r.uid, metrics=self._queue_only_metrics(
                    self._queued_at.pop(r.uid), expired=True))
                for r in expired]

    def _harvest_slots(self, done: list[int],
                       kind: str = "ok") -> list[Result]:
        if not done:
            return []
        self.state, engine_results = self.engine.harvest(self.state, done)
        results = []
        for b, er in zip(done, engine_results):
            req, admitted = self._resident.pop(b)
            queued = self._queued_at.pop(req.uid)
            results.append(Result(
                uid=req.uid, engine=er,
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
                    backend=self.engine.backend)))
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
