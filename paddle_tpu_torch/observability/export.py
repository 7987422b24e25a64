"""The structured read of the registry (counterpart of
paddle_tpu/observability/export.py): ``snapshot()`` gives every counter,
gauge, histogram and table and the span-buffer depth in plain JSON types.
The JAX package's ``dump`` and Prometheus text exposition come with the
rest of the observability layer (ROADMAP Queue 1 item 8)."""

from __future__ import annotations

from . import metrics, spans


def snapshot() -> dict:
    """{"counters", "gauges", "histograms", "span_count"}, and "tables"
    when something published one."""
    snap = {
        "counters": metrics.get_counters(),
        "gauges": metrics.get_gauges(),
        "histograms": metrics.get_histograms(),
        "span_count": spans.span_count(),
    }
    tables = metrics.get_tables()
    if tables:  # only present when something published one
        snap["tables"] = tables
    return snap
