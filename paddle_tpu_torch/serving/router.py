"""Request router with dynamic batching over bucketed shapes (counterpart
of paddle_tpu/serving/router.py).

One request = one sample (feed arrays WITHOUT the leading batch axis). A
scheduler thread per endpoint forms batches: it waits until enough
requests queue to fill the largest bucket or the OLDEST queued request
has waited `max_wait_ms`, pads the batch with zero rows up to the
smallest bucket that fits, and runs it as ONE program run. Each request's
Future resolves with its own rows of the fetches.

The JAX package's deadlines, priority classes and shedding, brownout,
replica sets, fault seams, spans and memory-plan warmup gate come with a
later slice.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from ..core.dtypes import to_numpy_dtype
from ..errors import InvalidArgumentError, PreconditionNotMetError


class ServerDrainingError(PreconditionNotMetError):
    """Admission refused: the server is draining or stopped."""


class EndpointConfig:
    """Batching knobs for one endpoint.

    * ``buckets`` — allowed batch sizes; a formed batch pads up to the
      smallest bucket that fits (the largest bucket caps batch size).
    * ``max_wait_ms`` — how long the OLDEST queued request may wait for
      co-batching before a partial batch is dispatched.
    * ``max_queue`` — admission bound; beyond it submits are refused.
    """

    def __init__(self, buckets=(1, 2, 4, 8), max_wait_ms=5.0, max_queue=1024):
        sizes = sorted(int(b) for b in buckets)
        if not sizes or sizes[0] <= 0:
            raise InvalidArgumentError(
                f"endpoint buckets must be positive, got {sizes}"
            )
        self.buckets = tuple(sizes)
        self.max_wait = float(max_wait_ms) / 1000.0
        self.max_queue = int(max_queue)


class _Request:
    __slots__ = ("feeds", "future", "t_enqueue")

    def __init__(self, feeds):
        self.feeds = feeds
        self.future = Future()
        self.t_enqueue = time.perf_counter()


class FrozenRunner:
    """Default runner: a FrozenModel executed through an Executor/Scope.

    Feed variables must be declared batch-leading (-1 first dim); fetches
    are batch-leading tensors."""

    def __init__(self, frozen, executor=None, scope=None):
        from ..framework.executor import Executor
        from ..framework.scope import global_scope

        self.frozen = frozen
        self.executor = executor or Executor()
        self.scope = scope or global_scope()
        self.feed_names = tuple(frozen.feed_names)
        self.fetch_names = tuple(frozen.fetch_names)
        self._sample_specs = {}
        blk = frozen.program.global_block
        for n in self.feed_names:
            v = blk.var(n)
            shape = tuple(v.shape or ())
            if not shape or shape[0] not in (-1, None):
                raise InvalidArgumentError(
                    f"serving feed {n!r} must be declared batch-leading "
                    f"(-1 first dim), got {shape}"
                )
            self._sample_specs[n] = (tuple(shape[1:]), v.dtype)

    def sample_spec(self, name):
        """(per-sample shape, dtype) for feed `name`."""
        return self._sample_specs[name]

    def run(self, feed):
        """Run one padded bucket batch; returns batch-leading outputs."""
        return self.executor.run(
            self.frozen.program, feed=feed,
            fetch_list=list(self.fetch_names), scope=self.scope,
        )


class Endpoint:
    """One servable model: queue + scheduler thread + bucketed dispatch."""

    def __init__(self, name, runner, config=None):
        self.name = name
        self.runner = runner
        self.config = config or EndpointConfig()
        # runners with static shape constraints (the GPT generator's cache
        # batch) veto incompatible bucket configs up front
        validate = getattr(runner, "validate_config", None)
        if validate is not None:
            validate(self.config)
        self._queue = deque()
        self._cond = threading.Condition()
        # serializes runner.run between the scheduler thread and warmup()
        self._run_lock = threading.Lock()
        self._stopped = False
        # (bucket, real rows) of every dispatched batch, in order
        self.batches = []
        self._thread = threading.Thread(
            target=self._schedule_loop, daemon=True, name=f"serving-{name}"
        )
        self._thread.start()

    def submit(self, feeds):
        """Admit one single-sample request; returns its Future."""
        feeds = {n: np.asarray(feeds[n]) for n in self.runner.feed_names}
        req = _Request(feeds)
        with self._cond:
            if self._stopped:
                raise ServerDrainingError(
                    f"endpoint {self.name!r} is draining; request refused"
                )
            if len(self._queue) >= self.config.max_queue:
                raise PreconditionNotMetError(
                    f"endpoint {self.name!r} queue full "
                    f"({self.config.max_queue}); back off or add capacity"
                )
            self._queue.append(req)
            self._cond.notify_all()
        return req.future

    def _schedule_loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait(0.05)
                if self._stopped and not self._queue:
                    break
                max_bucket = self.config.buckets[-1]
                # admit late arrivals until the largest bucket fills or the
                # oldest request's max-wait expires (draining flushes now)
                while len(self._queue) < max_bucket and not self._stopped:
                    remaining = (self._queue[0].t_enqueue
                                 + self.config.max_wait - time.perf_counter())
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                n = min(len(self._queue), max_bucket)
                batch = [self._queue.popleft() for _ in range(n)]
            self._run_batch(batch, self._bucket_for(n))

    def _bucket_for(self, n):
        for b in self.config.buckets:
            if b >= n:
                return b
        return self.config.buckets[-1]

    def _run_batch(self, batch, bucket):
        n = len(batch)
        try:
            feed = {}
            for name in self.runner.feed_names:
                rows = np.stack([r.feeds[name] for r in batch])
                if n < bucket:
                    pad = np.zeros((bucket - n,) + rows.shape[1:], rows.dtype)
                    rows = np.concatenate([rows, pad], axis=0)
                feed[name] = rows
            with self._run_lock:
                outs = [np.asarray(o) for o in self.runner.run(feed)]
        except Exception as exc:  # the batch's futures carry the failure
            for r in batch:
                r.future.set_exception(exc)
            return
        self.batches.append((bucket, n))
        for i, r in enumerate(batch):
            r.future.set_result([o[i] for o in outs])

    def warmup(self):
        """One zero-feed run per bucket through the scheduler's own entry,
        so the first requests pay no first-use cost (kernel build, cuBLAS
        handles, allocator growth)."""
        for b in self.config.buckets:
            feed = {}
            for name in self.runner.feed_names:
                shape, dtype = self.runner.sample_spec(name)
                feed[name] = np.zeros((b,) + shape, to_numpy_dtype(dtype))
            with self._run_lock:
                self.runner.run(feed)
        return len(self.config.buckets)

    def pending(self):
        with self._cond:
            return len(self._queue)

    def drain(self, timeout=None):
        """Stop admitting, flush the queue through the scheduler, stop the
        thread. True when everything in flight completed."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout)
        return not self._thread.is_alive() and not self.pending()


class Server:
    """A set of endpoints behind one admission/drain lifecycle."""

    def __init__(self):
        self._endpoints = {}
        self._lock = threading.Lock()
        self._draining = False

    def add_endpoint(self, name, runner=None, config=None, frozen=None,
                     executor=None, scope=None):
        """Register (and start) an endpoint. Pass a ``runner`` with the
        FrozenRunner interface, or ``frozen=`` to wrap a FrozenModel."""
        if frozen is not None:
            runner = FrozenRunner(frozen, executor=executor, scope=scope)
        if runner is None:
            raise InvalidArgumentError("add_endpoint needs runner= or frozen=")
        with self._lock:
            if self._draining:
                raise ServerDrainingError("server is draining")
            if name in self._endpoints:
                raise InvalidArgumentError(
                    f"endpoint {name!r} already registered"
                )
            ep = Endpoint(name, runner, config)
            self._endpoints[name] = ep
        return ep

    def __getitem__(self, name):
        return self._endpoints[name]

    def submit(self, endpoint, feeds):
        if self._draining:
            raise ServerDrainingError("server is draining")
        return self._endpoints[endpoint].submit(feeds)

    def warmup(self):
        """Warm every endpoint's buckets; returns the number of runs."""
        return sum(ep.warmup() for ep in self._endpoints.values())

    def drain(self, timeout=None):
        """Stop admission and complete every admitted request; `timeout`
        bounds the whole drain. True when fully drained."""
        with self._lock:
            self._draining = True
            eps = list(self._endpoints.values())
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        for ep in eps:
            remaining = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            ok = ep.drain(remaining) and ok
        return ok

    close = drain
