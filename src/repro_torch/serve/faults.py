"""Deterministic fault injection for the serving stack.

The recovery paths of :class:`~repro_torch.serve.dataflow_server.DataflowServer`
— dispatch retry with backoff, the wedged-slot watchdog, per-request
error results — are exactly the code that never runs in a healthy test
environment.  :class:`FaultPlan` makes them testable: every injection
decision is a pure function of ``(seed, kind, key)``, so a soak test
replays the identical fault schedule on every run and a failing seed
reproduces exactly.

Injection points (all opt-in; a server without a plan has zero
fault-path overhead):

* **compile failures** — ``check_compile(backend)`` raises
  :class:`CompileFault` for planned backends; the port's server has no
  backend to fall to, so the fault propagates out of its constructor;
* **dispatch exceptions** — ``dispatch_error(backend, block, attempt)``
  returns a :class:`DispatchFault` for planned blocks.  *Transient*
  faults clear after ``transient_attempts`` retries (the backoff path);
  backends in ``persistent_backends`` fail every attempt from
  ``persistent_from_block`` on (the server answers its residents with
  a typed error);
* **slot wedges** — ``wedge(uid)`` marks requests whose quiescence
  signal the server suppresses, simulating a stream that stops making
  progress without terminating; only the stall watchdog can free the
  slot;
* **poisoned feeds** — ``poison(feeds, uid, dtype)`` overwrites the
  first/last token of every stream with dtype-extreme values (INT_MIN /
  INT_MAX, or NaN / inf for floats).  Poison corrupts *values*, never
  structure, and is idempotent — a poisoned request still computes
  deterministically (two's-complement wraparound is the ALU contract),
  so even faulted requests stay bit-identical to a solo run over the
  same poisoned feeds while their neighbours are untouched.

The JAX package's ``repro.serve.faults`` with the same coin, so every
decision equals the JAX plan's for the same seed and key.  It leaves out
``reference_fail_uids`` and ``reference_error``: the port's server has
no reference mode to inject into.

``FaultPlan.scaled()`` honours the ``REPRO_FAULTS`` environment
variable (``off`` | default | ``full``) so a chaos run can crank
intensity without editing tests.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

__all__ = ["InjectedFault", "CompileFault", "DispatchFault", "FaultPlan"]


class InjectedFault(RuntimeError):
    """Base of every fault-plan-injected failure (lets recovery code and
    tests distinguish injected faults from genuine ones)."""


class CompileFault(InjectedFault):
    """Injected engine-construction failure for a planned backend."""


class DispatchFault(InjectedFault):
    """Injected device-dispatch failure for a planned block."""


class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    Rate-based decisions hash ``(seed, kind, key)`` — never a stateful
    RNG — so they are independent of call order and repeat exactly
    across processes.  Explicit sets (``wedge_uids`` etc.) pin faults to
    chosen requests/blocks for targeted tests; rates layer probabilistic
    faults on top for soak coverage.
    """

    def __init__(self, seed: int = 0, *,
                 compile_fail=(),            # backends whose compile raises
                 dispatch_fail_blocks=(),    # blocks with a transient fault
                 dispatch_fail_rate: float = 0.0,
                 transient_attempts: int = 1,  # retries a transient eats
                 persistent_backends=(),     # backends that fail forever...
                 persistent_from_block: int = 0,   # ...from this block on
                 wedge_uids=(), wedge_rate: float = 0.0,
                 poison_uids=(), poison_rate: float = 0.0):
        self.seed = int(seed)
        self.compile_fail = frozenset(compile_fail)
        self.dispatch_fail_blocks = frozenset(int(b) for b
                                              in dispatch_fail_blocks)
        self.dispatch_fail_rate = float(dispatch_fail_rate)
        self.transient_attempts = int(transient_attempts)
        self.persistent_backends = frozenset(persistent_backends)
        self.persistent_from_block = int(persistent_from_block)
        self.wedge_uids = frozenset(wedge_uids)
        self.wedge_rate = float(wedge_rate)
        self.poison_uids = frozenset(poison_uids)
        self.poison_rate = float(poison_rate)
        self.log: list[tuple] = []      # (kind, *key) of every injection
        # observability hook: called as notify(kind, *key) on every
        # injection (after it lands in ``log``).  The server points this
        # at its TraceRecorder so injected faults show up on the trace
        # timeline next to the lifecycle events they cause.
        self.notify = None

    def _emit(self, kind: str, *key) -> None:
        self.log.append((kind, *key))
        if self.notify is not None:
            self.notify(kind, *key)

    # -- the deterministic coin ----------------------------------------
    def _u(self, *key) -> float:
        """Uniform [0, 1) from sha256(seed, key) — order-independent."""
        h = hashlib.sha256(repr((self.seed, *key)).encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    # -- injection points ----------------------------------------------
    def check_compile(self, backend: str) -> None:
        if backend in self.compile_fail:
            self._emit("compile", backend)
            raise CompileFault(
                f"injected compile failure for backend {backend!r}")

    def dispatch_error(self, backend: str, block: int,
                       attempt: int) -> Exception | None:
        """Fault for dispatch ``attempt`` (0-based) of server ``block``,
        or None.  Transients clear after ``transient_attempts`` retries;
        persistent backends never clear."""
        if (backend in self.persistent_backends
                and block >= self.persistent_from_block):
            self._emit("dispatch-persistent", backend, block, attempt)
            return DispatchFault(
                f"injected persistent dispatch failure "
                f"(backend={backend}, block={block})")
        transient = block in self.dispatch_fail_blocks or (
            self.dispatch_fail_rate > 0.0
            and self._u("dispatch", backend, block)
            < self.dispatch_fail_rate)
        if transient and attempt < self.transient_attempts:
            self._emit("dispatch-transient", backend, block, attempt)
            return DispatchFault(
                f"injected transient dispatch failure "
                f"(backend={backend}, block={block}, attempt={attempt})")
        return None

    def wedge(self, uid: int) -> bool:
        """True if this request's quiescence signal is suppressed (the
        slot wedges and only the stall watchdog can harvest it)."""
        return uid in self.wedge_uids or (
            self.wedge_rate > 0.0 and self._u("wedge", uid) < self.wedge_rate)

    def poisoned(self, uid: int) -> bool:
        return uid in self.poison_uids or (
            self.poison_rate > 0.0
            and self._u("poison", uid) < self.poison_rate)

    def poison(self, feeds: dict, uid: int, dtype=np.int32) -> dict:
        """Feeds with dtype-extreme tokens for planned uids (idempotent:
        first element -> lowest representable / NaN, last -> highest /
        inf); unplanned uids get the feeds back unchanged."""
        if not feeds or not self.poisoned(uid):
            return feeds
        dtype = np.dtype(dtype)
        out = {}
        for a, v in feeds.items():
            arr = np.array(v, dtype=dtype, copy=True)
            if arr.size:
                if np.issubdtype(dtype, np.floating):
                    arr.flat[0] = np.nan
                    arr.flat[-1] = np.inf
                else:
                    info = np.iinfo(dtype)
                    arr.flat[0] = info.min
                    arr.flat[-1] = info.max
            out[a] = arr
        self._emit("poison", uid)
        return out

    # -- environment scaling (chaos runs) ------------------------------
    @classmethod
    def scaled(cls, seed: int = 0, **kw) -> "FaultPlan | None":
        """A plan whose rates follow ``REPRO_FAULTS``: ``off`` -> None
        (no injection), ``full`` -> rates doubled (capped at 1.0),
        anything else -> as given."""
        mode = os.environ.get("REPRO_FAULTS", "").lower()
        if mode == "off":
            return None
        if mode == "full":
            for k in ("dispatch_fail_rate", "wedge_rate", "poison_rate"):
                if k in kw:
                    kw[k] = min(1.0, 2.0 * kw[k])
        return cls(seed, **kw)
