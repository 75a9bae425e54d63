"""Observability of the port, from device to host.

- ``profile``  : the fabric counters of a profiled run
  (:class:`FabricProfile`).
- ``trace``    : :class:`TraceRecorder`, a block-clock event log of the
  server's slot lifecycle, exportable as Chrome trace-event JSON that
  Perfetto loads.
- ``metrics``  : :class:`MetricsRegistry`, process-local counters /
  gauges / histograms with a JSON snapshot.

The same names as the JAX package's ``repro.obs``.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, validate_snapshot)
from repro_torch.obs.profile import FabricProfile
from repro_torch.obs.trace import (TraceInvariantError, TraceRecorder,
                                   load_chrome, validate_chrome)

__all__ = [
    "Counter",
    "FabricProfile",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TraceInvariantError",
    "TraceRecorder",
    "load_chrome",
    "validate_chrome",
    "validate_snapshot",
]
