"""Bounded admission control for the serving stack (DESIGN.md §11).

A plain FIFO grows without bound: a chatty tenant could
queue thousands of requests and every later arrival — no matter whose —
waited behind all of them.  This module gives :class:`DataflowServer`
the two admission primitives a multi-tenant fabric front-end needs:

* **a bound with a policy** — ``max_queue`` caps the number of queued
  (not-yet-resident) requests, and the ``policy`` decides what happens
  at the cap:

  - ``"reject"``      — ``submit`` returns a typed :class:`Rejected`
    (never raises, never enqueues) so the caller can shed load;
  - ``"block"``       — ``submit`` runs server heartbeats until a
    queue slot frees (single-threaded backpressure: the submitting
    host *is* the event loop);
  - ``"drop-oldest"`` — the oldest queued request of the *most
    backlogged tenant* is evicted with a
    ``Result(error=DroppedError)`` and the new request takes its
    place.

* **per-tenant fairness** — :class:`FairQueue` buckets requests by
  ``Request.tenant`` and dequeues round-robin across tenants in
  first-seen order, so one tenant flooding the queue delays only its
  own backlog: another tenant's single request is at most one
  round-robin lap from admission.  (A ``tenant`` of ``None`` is just
  the shared anonymous bucket — untagged traffic behaves exactly like
  a plain FIFO.)

Admission stays a *scheduling* concern: none of this touches what runs
on the fabric, so every admitted request's result remains bit-identical
to a solo ``DataflowEngine.run`` (the server's core property).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

POLICIES = ("reject", "block", "drop-oldest")


@dataclasses.dataclass
class Rejected:
    """Typed admission rejection returned by ``submit`` under
    ``policy="reject"`` when the queue is at ``max_queue``.  The request
    was *not* enqueued and will receive no :class:`~repro_torch.serve.types.Result`;
    the uid is returned so the caller can retry/re-submit it later."""
    uid: int
    reason: str
    queue_depth: int
    tenant: object = None

    def __bool__(self) -> bool:      # `if srv.submit(...)` reads naturally
        return False


class QueueFullError(RuntimeError):
    """The bounded queue could not make room (``policy="block"`` safety
    valve: the pump ran a pathological number of heartbeats without a
    slot freeing — only reachable if the server itself cannot make
    progress)."""


class DroppedError(RuntimeError):
    """``policy="drop-oldest"`` evicted this queued request to admit a
    newer one; delivered as ``Result(error=DroppedError(...))``."""


class FairQueue:
    """Bounded-agnostic round-robin-across-tenants request queue.

    Requests land in per-tenant FIFO buckets; :meth:`pop` serves
    tenants cyclically in first-seen order (a tenant whose bucket
    empties leaves the ring and re-enters at the back on its next
    request).  All operations are deterministic in the sequence of
    push/pop calls — admission order, and therefore every request's
    result, is reproducible.
    """

    def __init__(self) -> None:
        self._buckets: dict[object, collections.deque] = {}
        self._ring: collections.deque = collections.deque()  # tenant keys
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        """Queued requests in bucket (first-seen tenant) order — for
        inspection; pop order interleaves tenants instead."""
        for q in self._buckets.values():
            yield from q

    def depths(self) -> dict:
        """Per-tenant queued-request counts (observability export —
        feeds the server's ``queue_depth{tenant=...}`` gauges)."""
        return {t: len(q) for t, q in self._buckets.items() if q}

    def _bucket(self, tenant) -> collections.deque:
        q = self._buckets.get(tenant)
        if q is None:
            q = self._buckets[tenant] = collections.deque()
            self._ring.append(tenant)
        return q

    def push(self, req) -> None:
        self._bucket(getattr(req, "tenant", None)).append(req)
        self._n += 1

    def pop(self):
        """Next request, round-robin across tenants."""
        while self._ring:
            t = self._ring.popleft()
            q = self._buckets[t]
            if q:
                self._ring.append(t)       # tenant goes to the back
                self._n -= 1
                return q.popleft()
            del self._buckets[t]           # empty bucket leaves the ring
        raise IndexError("pop from an empty FairQueue")

    def drop_oldest(self):
        """Evict the oldest request of the most backlogged tenant (ties
        break toward the earliest-seen tenant) — the fairness-preserving
        victim for ``policy="drop-oldest"``: load shedding lands on the
        tenant causing the backlog."""
        if not self._n:
            raise IndexError("drop_oldest from an empty FairQueue")
        victim_t = max(self._buckets, key=lambda t: len(self._buckets[t]))
        self._n -= 1
        return self._buckets[victim_t].popleft()

    def remove_if(self, pred: Callable[[object], bool]) -> list:
        """Remove and return every queued request matching ``pred``
        (deadline expiry sweep), preserving bucket order."""
        out = []
        for t, q in self._buckets.items():
            kept = collections.deque()
            for r in q:
                (out if pred(r) else kept).append(r)
            self._buckets[t] = kept
        self._n -= len(out)
        return out
