"""Shared request/result vocabulary for both serving paths.

* **LM waves** (:class:`repro_torch.serve.engine.ServeEngine`) — a
  request carries a token ``prompt`` and decode budget; the result
  carries the generated ``tokens``.
* **Dataflow streams**
  (:class:`repro_torch.serve.dataflow_server.DataflowServer`) — a request
  carries ``feeds`` (arc -> token-stream dict, the environment buses of
  a fabric run); the result carries the fabric's
  :class:`~repro_torch.core.engine.EngineResult` plus admission and
  residency metrics.

The JAX package's ``repro.serve.types`` with the same fields, names,
order and defaults, less ``RequestMetrics.degraded`` (the port's server
has no degradation chain).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import EngineResult


class InvalidRequestError(ValueError):
    """A request carried an unusable field value (e.g.
    ``deadline_blocks < 1`` or ``max_cycles < 1``) — raised by
    ``submit`` before the request touches the queue, so a malformed
    request can never poison an admission batch or expire instantly."""


@dataclasses.dataclass
class Request:
    """One unit of admission-controlled work.

    LM path fields: ``prompt`` / ``max_new_tokens`` / ``eos_id``.
    Dataflow path field: ``feeds`` (arc -> [k] token stream).

    ``tenant`` is the fairness key bounded admission round-robins
    across; ``deadline_blocks`` expires the request — queued or
    resident — once that many server blocks pass after submit;
    ``max_cycles`` overrides the engine's cycle cap for this request's
    slot only (smaller *or* larger).
    """
    uid: int
    prompt: np.ndarray | None = None    # [S] int32 token ids (LM)
    max_new_tokens: int = 16
    eos_id: int | None = None
    feeds: dict | None = None           # arc -> stream (dataflow)
    tenant: object = None               # admission fairness key
    deadline_blocks: int | None = None  # expire after N server blocks
    max_cycles: int | None = None       # per-slot engine-cap override


@dataclasses.dataclass
class RequestMetrics:
    """Per-request serving metrics, in deterministic block-clock units
    (one unit = one K-cycle block launch of the serving fabric)."""
    slot: int                 # slot the request rode
    queued_block: int         # server block clock at submit()
    admitted_block: int       # ... at slot admission
    finished_block: int       # ... at harvest
    queue_wait_blocks: int    # admitted - queued (time spent queued)
    residency_blocks: int     # block launches while resident
    residency_cycles: int     # fabric cycles the request ran
    tokens_out: int           # tokens drained across all output arcs
    truncated: bool = False   # hit its cycle cap (engine max_cycles or
    #                           Request.max_cycles) before quiescing —
    #                           the slot was force-harvested, results
    #                           are partial
    expired: bool = False     # Request.deadline_blocks elapsed before
    #                           quiescence; harvested exactly like
    #                           truncation (partial results), or never
    #                           admitted at all (slot == -1)
    wedged: bool = False      # the stall watchdog force-harvested the
    #                           slot: token/firing counts stopped
    #                           changing for wedge_timeout_blocks
    #                           without the quiescence signal arriving
    retries: int = 0          # dispatch retries ridden while resident
    backend: str = ""         # backend that produced the final result


@dataclasses.dataclass
class Result:
    """What a serving engine hands back for one request.

    LM path fields: ``tokens`` / ``prompt_len``.
    Dataflow path fields: ``engine`` (the full
    :class:`~repro_torch.core.engine.EngineResult`, bit-identical to a
    solo run) and ``metrics``."""
    uid: int
    tokens: np.ndarray | None = None    # generated ids (LM)
    prompt_len: int = 0
    engine: EngineResult | None = None  # fabric result (dataflow)
    metrics: RequestMetrics | None = None
    error: Exception | None = None      # typed failure: the request was
    #                                     answered, not computed (queue
    #                                     drop, a dispatch that failed
    #                                     past its retries)

    @property
    def status(self) -> str:
        """One-word disposition: ``ok`` | ``truncated`` | ``expired`` |
        ``wedged`` | ``error`` — the exits of the slot lifecycle."""
        if self.error is not None:
            return "error"
        m = self.metrics
        if m is not None:
            if m.expired:
                return "expired"
            if m.wedged:
                return "wedged"
            if m.truncated:
                return "truncated"
        return "ok"
