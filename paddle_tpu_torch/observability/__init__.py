"""Runtime observability, as far as the embedding engine needs it
(counterpart of paddle_tpu/observability): counters, gauges and
histograms (metrics.py) and host spans (spans.py).

Kill-switch: ``PADDLE_TPU_MONITOR=0`` in the environment makes every hook
a no-op (``set_enabled`` flips it at run time). The exporters, flight
recorder, telemetry timeline, causal traces and watcher are ROADMAP
Queue 1 item 8.
"""

from __future__ import annotations

from . import metrics, spans  # noqa: F401
from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    add,
    enabled,
    get_counters,
    get_gauges,
    get_histograms,
    observe,
    set_enabled,
    set_gauge,
)
from .spans import get_spans, span  # noqa: F401


def reset() -> None:
    """Clear every counter, gauge and histogram and the span buffer."""
    metrics.reset()
    spans.reset()
