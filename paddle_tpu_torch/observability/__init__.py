"""Runtime observability, as far as the embedding engine and the
executor's perf telemetry need it (counterpart of
paddle_tpu/observability): counters, gauges, histograms, tables and
timers (metrics.py), host spans (spans.py) and the structured snapshot
(export.py).

Kill-switch: ``PADDLE_TPU_MONITOR=0`` in the environment makes every hook
a no-op (``set_enabled`` flips it at run time). The file and Prometheus
exporters, flight recorder, telemetry timeline, causal traces and
watcher are ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

from . import export, metrics, spans  # noqa: F401
from .export import snapshot  # noqa: F401
from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    add,
    drop_gauges,
    drop_tables,
    enabled,
    get_counters,
    get_gauges,
    get_histograms,
    get_tables,
    observe,
    set_enabled,
    set_gauge,
    set_table,
    timed,
)
from .spans import get_spans, span, span_count  # noqa: F401


def reset() -> None:
    """Clear every counter, gauge, histogram and table and the span
    buffer."""
    metrics.reset()
    spans.reset()
