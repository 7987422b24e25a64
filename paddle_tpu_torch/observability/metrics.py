"""Metric primitives: counters, gauges, histograms, tables and timers
(counterpart of paddle_tpu/observability/metrics.py).

The registry is process-global and thread-safe (one lock; every public
entry point is a handful of dict ops under it). It is on by default;
``PADDLE_TPU_MONITOR=0`` in the environment turns every hook into an
early-return no-op (``set_enabled`` flips it at run time, and
``set_enabled(None)`` reads the environment again).

Histograms follow the Prometheus model: fixed upper-bound buckets plus
count and sum, with min and max. Bucket edges are inclusive (``value <=
le`` lands in the ``le`` bucket); a read gives cumulative bucket counts.
Tables are plain-JSON dicts, last value wins: the executor publishes its
per-op cost attribution as ``perf.cost_table``. The JAX package's
windowed quantiles come with the rest of the observability layer
(ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import bisect
import os
import threading
import time

# latency-oriented default edges, in seconds
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _env_enabled() -> bool:
    return os.environ.get("PADDLE_TPU_MONITOR", "1").lower() not in (
        "0", "false", "off",
    )


_enabled = _env_enabled()
_lock = threading.Lock()
_counters: dict[str, int] = {}
_gauges: dict[str, float] = {}
_histograms: dict[str, "_Histogram"] = {}
# structured tables (plain-JSON dicts, last value wins): what a scalar
# cannot carry, such as the executor's per-op cost table
_tables: dict[str, dict] = {}


def enabled() -> bool:
    return _enabled


def set_enabled(flag: bool | None) -> None:
    """Toggle the whole registry; ``None`` re-reads PADDLE_TPU_MONITOR."""
    global _enabled
    _enabled = _env_enabled() if flag is None else bool(flag)


class _Histogram:
    __slots__ = ("bounds", "bucket_counts", "count", "total", "min", "max")

    def __init__(self, buckets):
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +1 = +Inf
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        self.bucket_counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def to_dict(self) -> dict:
        cum, buckets = 0, []
        for le, c in zip(self.bounds, self.bucket_counts):
            cum += c
            buckets.append([le, cum])
        buckets.append(["+Inf", self.count])
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "buckets": buckets,
        }


# -- write side -------------------------------------------------------------
def add(name: str, value: int = 1) -> None:
    """Bump the monotonic counter `name`."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(value)


def set_gauge(name: str, value: float) -> None:
    """Write the gauge `name` (last value wins)."""
    if not _enabled:
        return
    with _lock:
        _gauges[name] = float(value)


def observe(name: str, value: float, buckets=None) -> None:
    """Record `value` into the histogram `name` (created on first use;
    `buckets` only takes effect at creation)."""
    if not _enabled:
        return
    with _lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = _Histogram(buckets or DEFAULT_BUCKETS)
        h.observe(float(value))


def drop_gauges(prefix: str) -> None:
    """Remove every gauge whose name starts with `prefix`. For publishers
    whose gauge set varies with the source (the executor's per-op-family
    ``perf.family_time.*``): dropping before publishing again keeps the
    gauges of a previous plan from surviving as stale."""
    with _lock:
        for k in [k for k in _gauges if k.startswith(prefix)]:
            del _gauges[k]


def set_table(name: str, table: dict) -> None:
    """Publish the structured table `name` (plain JSON types; last value
    wins; snapshots carry it under "tables")."""
    if not _enabled:
        return
    with _lock:
        _tables[name] = table


def drop_tables(prefix: str) -> None:
    """Remove every table whose name starts with `prefix`, the table
    analogue of :func:`drop_gauges`."""
    with _lock:
        for k in [k for k in _tables if k.startswith(prefix)]:
            del _tables[k]


class _Timed:
    """Context manager: wall time -> histogram `name`."""

    __slots__ = ("name", "buckets", "_t0")

    def __init__(self, name, buckets=None):
        self.name = name
        self.buckets = buckets
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter() if _enabled else None
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            observe(self.name, time.perf_counter() - self._t0, self.buckets)
        return False


def timed(name: str, buckets=None) -> _Timed:
    """``with timed("analysis.verify_latency"): ...``"""
    return _Timed(name, buckets)


# -- read side --------------------------------------------------------------
def get_counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def get_gauges() -> dict[str, float]:
    with _lock:
        return dict(_gauges)


def get_histograms() -> dict[str, dict]:
    with _lock:
        return {k: h.to_dict() for k, h in _histograms.items()}


def get_tables() -> dict[str, dict]:
    with _lock:
        return dict(_tables)


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _tables.clear()
