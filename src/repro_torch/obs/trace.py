"""TraceRecorder -- block-clock event tracing for the serving lifecycle.

Records the server's slot-lifecycle state machine as a flat event
log and exports Chrome trace-event JSON (the ``traceEvents`` array
format) that Perfetto / chrome://tracing load directly.

Event kinds (one per lifecycle edge):

========== ==========================================================
kind       meaning
========== ==========================================================
submit     request accepted into the queue
reject     bounded-admission rejection (never enters the queue)
drop       drop-oldest policy evicted a queued request  (terminal)
poison     fault injection corrupted the request's feeds on submit
admit      request bound to a slot (begins a slot span)
requeue    degradation unbound a resident request (ends its slot span)
retry      a dispatch attempt failed and was retried
wedge      fault injection wedged a slot (suppressed its quiescence)
degrade    backend degradation (compile- or dispatch-triggered)
expire     a *queued* request passed its deadline       (terminal)
harvest    a resident request finished; ``status`` says how (terminal)
fault      fault injection landed (``injected`` names the kind)
========== ==========================================================

The port's server never emits ``requeue`` or ``degrade`` (it has no
degradation chain); they stay in the table and the validator because
the JAX package's server emits them, and the validator checks either
package's traces.

Timestamps: every event carries the server's deterministic block clock
(``block``) and a wall-clock offset (``wall_s``).  Export with
``clock="block"`` (default; 1 block = 1000 us so Perfetto shows block
numbers as milliseconds -- deterministic, diffable) or ``clock="wall"``
(real time).

Track layout: one track (pid/tid pair) per slot under the "slots"
process, one per tenant under "tenants", plus a "server" track for
events not bound to a slot.  Slot spans run admit -> harvest/requeue;
tenant spans run submit -> terminal.

The JAX package's ``repro.obs.trace``, kept as a copy: the same event
layout, so the two packages' block-clock exports compare event for event.
"""
from __future__ import annotations

import dataclasses
import json
import time

TERMINAL_KINDS = ("harvest", "expire", "drop")

# pids for the three track groups in the chrome export
_PID_SLOTS, _PID_TENANTS, _PID_SERVER = 1, 2, 3

US_PER_BLOCK = 1000  # block-clock export scale: 1 block == 1ms in Perfetto


class TraceInvariantError(AssertionError):
    """A trace export violated a lifecycle/clock invariant."""


@dataclasses.dataclass
class TraceEvent:
    kind: str
    block: int
    wall_s: float
    uid: int | None = None
    slot: int | None = None
    tenant: str | None = None
    status: str | None = None
    args: dict = dataclasses.field(default_factory=dict)


class TraceRecorder:
    """Append-only event log with Chrome trace-event export."""

    def __init__(self) -> None:
        self.events: list[TraceEvent] = []
        self._t0 = time.perf_counter()

    def record(self, kind: str, *, block: int, uid: int | None = None,
               slot: int | None = None, tenant: str | None = None,
               status: str | None = None, **args) -> TraceEvent:
        ev = TraceEvent(kind=kind, block=int(block),
                        wall_s=time.perf_counter() - self._t0,
                        uid=uid, slot=slot, tenant=tenant, status=status,
                        args=args)
        self.events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    # ---------------------------------------------------------------- export
    def to_chrome(self, clock: str = "block") -> dict:
        """Render the log as a Chrome trace-event JSON object."""
        if clock not in ("block", "wall"):
            raise ValueError(f"clock must be 'block' or 'wall', got {clock!r}")

        def ts(ev: TraceEvent) -> float:
            if clock == "block":
                return ev.block * US_PER_BLOCK
            return ev.wall_s * 1e6

        out: list[dict] = []
        tenant_tids: dict[str, int] = {}
        seen_slots: set[int] = set()

        def meta(pid: int, tid: int, what: str, name: str) -> dict:
            return {"name": what, "ph": "M", "pid": pid, "tid": tid,
                    "args": {"name": name}}

        out.append(meta(_PID_SLOTS, 0, "process_name", "slots"))
        out.append(meta(_PID_TENANTS, 0, "process_name", "tenants"))
        out.append(meta(_PID_SERVER, 0, "process_name", "server"))

        def tenant_tid(tenant: str) -> int:
            if tenant not in tenant_tids:
                tenant_tids[tenant] = len(tenant_tids) + 1
                out.append(meta(_PID_TENANTS, tenant_tids[tenant],
                                "thread_name", str(tenant)))
            return tenant_tids[tenant]

        def slot_tid(slot: int) -> int:
            tid = slot + 1  # tid 0 is reserved for process metadata
            if slot not in seen_slots:
                seen_slots.add(slot)
                out.append(meta(_PID_SLOTS, tid, "thread_name", f"slot {slot}"))
            return tid

        def base_args(ev: TraceEvent) -> dict:
            args = {"block": ev.block, "wall_s": round(ev.wall_s, 6)}
            if ev.uid is not None:
                args["uid"] = ev.uid
            if ev.slot is not None:
                args["slot"] = ev.slot
            if ev.status is not None:
                args["status"] = ev.status
            if ev.tenant is not None:
                args["tenant"] = ev.tenant
            args.update(ev.args)
            return args

        for ev in self.events:
            args = base_args(ev)
            # slot spans: admit opens, harvest/requeue closes
            if ev.kind == "admit" and ev.slot is not None:
                out.append({"name": f"uid {ev.uid}", "ph": "B",
                            "pid": _PID_SLOTS, "tid": slot_tid(ev.slot),
                            "ts": ts(ev), "args": args})
            elif ev.kind in ("harvest", "requeue") and ev.slot is not None \
                    and ev.slot >= 0:
                out.append({"name": f"uid {ev.uid}", "ph": "E",
                            "pid": _PID_SLOTS, "tid": slot_tid(ev.slot),
                            "ts": ts(ev), "args": args})
            # tenant spans: submit opens, terminal closes.  Requests of
            # one tenant overlap (queued + resident), so these are async
            # events keyed by uid, not B/E (which must nest per track).
            if ev.kind == "submit" and ev.tenant is not None:
                out.append({"name": f"uid {ev.uid}", "cat": "request",
                            "id": ev.uid, "ph": "b",
                            "pid": _PID_TENANTS, "tid": tenant_tid(ev.tenant),
                            "ts": ts(ev), "args": args})
            elif ev.kind in TERMINAL_KINDS and ev.tenant is not None:
                out.append({"name": f"uid {ev.uid}", "cat": "request",
                            "id": ev.uid, "ph": "e",
                            "pid": _PID_TENANTS, "tid": tenant_tid(ev.tenant),
                            "ts": ts(ev), "args": args})
            # every event also lands as an instant on its home track
            if ev.slot is not None and ev.slot >= 0:
                pid, tid = _PID_SLOTS, slot_tid(ev.slot)
            elif ev.tenant is not None:
                pid, tid = _PID_TENANTS, tenant_tid(ev.tenant)
            else:
                pid, tid = _PID_SERVER, 1
            out.append({"name": ev.kind, "ph": "i", "s": "t",
                        "pid": pid, "tid": tid, "ts": ts(ev), "args": args})

        return {"traceEvents": out,
                "displayTimeUnit": "ms",
                "otherData": {"clock": clock,
                              "us_per_block": US_PER_BLOCK if clock == "block" else None}}

    def save(self, path: str, clock: str = "block") -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(clock), fh, indent=1)


def load_chrome(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def validate_chrome(trace: dict) -> dict:
    """Check a chrome export against the four lifecycle invariants; raise on violation.

    Invariants:
      1. shape: a ``traceEvents`` list whose entries all carry
         name/ph/pid/tid (+ts for non-metadata) -- what Perfetto requires;
      2. monotone clocks: per track, timestamps never decrease in
         emission order;
      3. balanced spans: per track, B/E nest and the stack drains
         empty; async b/e pairs (tenant request spans) balance per id;
      4. lifecycle: every uid has exactly one submit and exactly one
         terminal event, and admits == requeues + slot-harvests.

    Returns ``{"events": n, "uids": n, "tracks": n}`` on success so
    callers can assert non-emptiness in one place.
    """
    if not isinstance(trace, dict) or not isinstance(trace.get("traceEvents"), list):
        raise TraceInvariantError("missing traceEvents list")
    events = trace["traceEvents"]

    last_ts: dict[tuple, float] = {}
    span_stack: dict[tuple, list[str]] = {}
    async_open: dict[tuple, int] = {}
    submits: dict[int, int] = {}
    terminals: dict[int, int] = {}
    admits: dict[int, int] = {}
    closes: dict[int, int] = {}

    for i, ev in enumerate(events):
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                raise TraceInvariantError(f"event {i} missing {field!r}: {ev}")
        if ev["ph"] == "M":
            continue
        if "ts" not in ev:
            raise TraceInvariantError(f"event {i} missing ts: {ev}")
        track = (ev["pid"], ev["tid"])
        ts = ev["ts"]
        if ts < last_ts.get(track, float("-inf")):
            raise TraceInvariantError(
                f"clock went backwards on track {track}: {ts} after {last_ts[track]}")
        last_ts[track] = ts
        if ev["ph"] == "b":
            async_open[(ev.get("cat"), ev.get("id"))] = \
                async_open.get((ev.get("cat"), ev.get("id")), 0) + 1
        elif ev["ph"] == "e":
            key = (ev.get("cat"), ev.get("id"))
            if async_open.get(key, 0) <= 0:
                raise TraceInvariantError(f"async end without begin: {ev}")
            async_open[key] -= 1
        elif ev["ph"] == "B":
            span_stack.setdefault(track, []).append(ev["name"])
        elif ev["ph"] == "E":
            stack = span_stack.get(track, [])
            if not stack:
                raise TraceInvariantError(f"unmatched end on track {track}: {ev}")
            opened = stack.pop()
            if opened != ev["name"]:
                raise TraceInvariantError(
                    f"mismatched span on track {track}: began {opened!r}, "
                    f"ended {ev['name']!r}")
        args = ev.get("args", {})
        uid = args.get("uid")
        if uid is not None and ev["ph"] == "i":
            kind = ev["name"]
            if kind == "submit":
                submits[uid] = submits.get(uid, 0) + 1
            if kind in TERMINAL_KINDS:
                terminals[uid] = terminals.get(uid, 0) + 1
            if kind == "admit":
                admits[uid] = admits.get(uid, 0) + 1
            if kind == "requeue" or (kind == "harvest"
                                     and args.get("slot", -1) >= 0):
                closes[uid] = closes.get(uid, 0) + 1

    open_tracks = {t: s for t, s in span_stack.items() if s}
    if open_tracks:
        raise TraceInvariantError(f"unbalanced spans left open: {open_tracks}")
    open_async = {k: n for k, n in async_open.items() if n}
    if open_async:
        raise TraceInvariantError(f"unbalanced async spans left open: {open_async}")
    for uid, n in submits.items():
        if n != 1:
            raise TraceInvariantError(f"uid {uid} submitted {n} times")
        if terminals.get(uid, 0) != 1:
            raise TraceInvariantError(
                f"uid {uid} has {terminals.get(uid, 0)} terminal events, want 1")
    for uid, n in terminals.items():
        if uid not in submits:
            raise TraceInvariantError(f"uid {uid} terminated without a submit")
    for uid, n in admits.items():
        if closes.get(uid, 0) != n:
            raise TraceInvariantError(
                f"uid {uid}: {n} admits but {closes.get(uid, 0)} slot closes")

    return {"events": len(events), "uids": len(submits), "tracks": len(last_ts)}
