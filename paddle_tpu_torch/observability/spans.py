"""Host spans: named wall-clock regions in a bounded ring buffer
(counterpart of paddle_tpu/observability/spans.py).

``span("name")`` records, unless the monitor switch is off, into a deque
capped at 4096 entries: old spans fall off, so a long-running trainer
never grows memory. The switch is the one of metrics.py. The JAX package's causal trace ids and Chrome-trace export
come with the rest of the observability layer (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import collections
import threading
import time

from . import metrics

_MAX_SPANS = 4096
_lock = threading.Lock()
_spans: collections.deque = collections.deque(maxlen=_MAX_SPANS)


class _Span:
    """Context manager recording one ring-buffer span."""

    __slots__ = ("name", "category", "args", "_wall_us", "_t0")

    def __init__(self, name, category="host", args=None):
        self.name = name
        self.category = category
        self.args = args or {}
        self._t0 = None

    def __enter__(self):
        self._t0 = None
        if metrics.enabled():
            self._wall_us = time.time_ns() / 1e3
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            rec = {
                "name": self.name,
                "cat": self.category,
                "ts": self._wall_us,
                "dur": (time.perf_counter_ns() - self._t0) / 1e3,
                "tid": threading.get_ident(),
                "args": self.args,
            }
            with _lock:
                _spans.append(rec)
        return False


def span(name: str, category: str = "host", **args) -> _Span:
    """``with span("executor.step", step=i): ...``"""
    return _Span(name, category, args)


def get_spans() -> list[dict]:
    with _lock:
        return list(_spans)


def span_count() -> int:
    with _lock:
        return len(_spans)


def reset() -> None:
    with _lock:
        _spans.clear()
