"""Async prefetch: stage the next batch's cold rows while this step runs
(counterpart of paddle_tpu/embedding/prefetch.py).

The reference overlapped pserver pulls with compute via the communicator's
send/recv threads (communicator.cc); here the host-side half of a cached
lookup (id extraction, batch-unique, cold-row gather from the host store)
runs on a worker thread one (or more) batches ahead, so by the time the
step loop asks for batch k+1 its rows are already in a staged payload and
the only on-thread work is the slot install (a plain host-to-device copy)
and the id translation.

Works over any iterable of feed dicts. Telemetry:
``embedding.prefetch_overlap`` histogram (fraction of each batch's staging
time hidden behind compute: 1.0 = fully overlapped),
``embedding.prefetch_batches`` counter, ``embedding.prefetch_plan`` spans.
"""

from __future__ import annotations

import queue
import threading
import time

from .cache import RATIO_BUCKETS


class Prefetcher:
    """Iterate ``feeds``, returning feeds whose cached-table ids are
    already resident and translated to hot slots.

    depth: staged batches the worker may run ahead (>= 1). The worker only
    does plan() (host reads, thread-safe vs the residency lock); apply()
    (device slot writes + translation) happens on the consuming thread at
    ``__next__`` so it is serialized with the step loop.
    """

    def __init__(self, engine, feeds, scope, depth=2):
        if depth < 1:
            raise ValueError(f"Prefetcher depth must be >= 1, got {depth}")
        self.engine = engine
        self.scope = scope
        self._q = queue.Queue(maxsize=int(depth))
        self._src = iter(feeds)
        self._done = object()
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, name="embedding-prefetch", daemon=True
        )
        self._thread.start()

    def _put(self, item):
        """put() that yields to the stop flag so close() cannot leave the
        worker blocked on a full queue (and then silently iterating the
        rest of the feed source)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        from .. import observability as _obs

        try:
            for feed in self._src:
                if self._stop.is_set():
                    break
                t0 = time.perf_counter()
                with _obs.span("embedding.prefetch_plan",
                               category="embedding"):
                    plans = self.engine.plan(feed)
                prep = time.perf_counter() - t0
                if not self._put((feed, plans, prep)):
                    break
            self._put(self._done)
        except BaseException as e:  # surfaced on the consumer thread
            self._err = e
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        from .. import observability as _obs

        t_req = time.perf_counter()
        item = self._q.get()
        if item is self._done:
            # keep the sentinel visible: a second next() (or close())
            # after exhaustion/error must not block forever
            self._stop.set()
            try:
                self._q.put_nowait(self._done)
            except queue.Full:
                pass
            self._thread.join(timeout=5)
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        feed, plans, prep = item
        waited = max(0.0, time.perf_counter() - t_req)
        if prep > 0:
            # the slice of staging time the consumer actually waited for is
            # the non-overlapped part; everything else ran behind compute
            overlap = max(0.0, 1.0 - min(waited, prep) / prep)
            _obs.observe("embedding.prefetch_overlap", overlap,
                         RATIO_BUCKETS)
        _obs.add("embedding.prefetch_batches")
        return self.engine.apply(plans, feed, self.scope)

    def close(self):
        """Stop the worker and drain the queue (for early exit from the
        consuming loop): the stop flag halts both the feed iteration and
        any put() in flight, so no further feeds are consumed."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
        # leave nothing stranded for a consumer still holding the iterator
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
