"""Process-local metrics registry: counters, gauges, histograms.

Deliberately tiny and dependency-free (no torch, no threads): the server
updates metrics from its host loop, and ``snapshot()`` renders
everything to a JSON-safe dict.  Metrics are keyed by ``(name, sorted
labels)`` -- requesting the same name+labels twice returns the same
instrument, so call sites never cache handles.

The JAX package's ``repro.obs.metrics`` with the same bucket bounds and
snapshot keys (``name{label=value}``), so a snapshot of either package's
server compares with ``==``.
"""
from __future__ import annotations

import json
import math


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    """A point-in-time value, with its high-water mark since creation."""

    __slots__ = ("value", "high_water")

    def __init__(self) -> None:
        self.value = 0
        self.high_water = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.high_water:
            self.high_water = v


# Upper bucket bounds for block/cycle-scale quantities: exponential so
# one layout serves queue waits (~1-100 blocks) and residencies
# (~10-1e5 cycles) alike.
DEFAULT_BUCKETS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000,
                   2500, 5000, 10000, 100000)


class Histogram:
    """Fixed-bucket histogram with sum/count/min/max."""

    __slots__ = ("buckets", "bucket_counts", "count", "total", "min", "max")

    def __init__(self, buckets=DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +inf overflow
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Registry of named, labeled instruments with a JSON snapshot."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # ----------------------------------------------------------- instruments
    def counter(self, name: str, **labels) -> Counter:
        return self._counters.setdefault(_key(name, labels), Counter())

    def gauge(self, name: str, **labels) -> Gauge:
        return self._gauges.setdefault(_key(name, labels), Gauge())

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
        return self._histograms.setdefault(_key(name, labels), Histogram(buckets))

    # ---------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-safe dump of every instrument, sorted by key."""
        out = {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {
                k: {"value": g.value, "high_water": g.high_water}
                for k, g in sorted(self._gauges.items())
            },
            "histograms": {
                k: {
                    "count": h.count,
                    "sum": h.total,
                    "mean": h.mean,
                    "min": h.min if h.count else None,
                    "max": h.max if h.count else None,
                    "buckets": {
                        (str(le) if i < len(h.buckets) else "+inf"): n
                        for i, (le, n) in enumerate(
                            zip(list(h.buckets) + ["+inf"], h.bucket_counts))
                    },
                }
                for k, h in sorted(self._histograms.items())
            },
        }
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.snapshot(), fh, indent=1)


def validate_snapshot(snap: dict) -> None:
    """Schema check for a ``MetricsRegistry.snapshot()`` dump.

    Raises ``ValueError`` on the first violation.
    """
    for section in ("counters", "gauges", "histograms"):
        if section not in snap or not isinstance(snap[section], dict):
            raise ValueError(f"metrics snapshot missing section {section!r}")
    for k, v in snap["counters"].items():
        if not isinstance(v, int) or v < 0:
            raise ValueError(f"counter {k!r} is not a non-negative int: {v!r}")
    for k, g in snap["gauges"].items():
        if not {"value", "high_water"} <= set(g):
            raise ValueError(f"gauge {k!r} missing value/high_water")
    for k, h in snap["histograms"].items():
        if h["count"] != sum(h["buckets"].values()):
            raise ValueError(f"histogram {k!r}: bucket counts do not sum to count")
