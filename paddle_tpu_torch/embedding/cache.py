"""Host-cold / device-hot cache tiers for sparse tables (counterpart of
paddle_tpu/embedding/cache.py).

The capability target is the reference's pslib/BoxPS cache hierarchy
(fleet_wrapper.h:86: pull_sparse into a device cache, push back on
eviction): the program only ever gathers from a fixed-shape
device-resident hot tier ([hot_rows, D], a plain persistable parameter),
and every id the host feeds is translated to a hot slot first. The cold
store is host memory (numpy), so table capacity is bounded by host RAM,
not device memory.

A :class:`CachedGroup` is one id space shared by one or more tables (e.g.
DeepFM's first-order [V, 1] and factor [V, D] tables both keyed by
``feat_ids``): one slot map + one access-count array serve every table in
the group, so a single host-side translation covers all of them and their
rows stay slot-aligned across tiers.

Eviction is by access count (coldest resident row first), never evicting a
row the incoming batch needs; evicted rows (and their optimizer-state rows)
write back to the host store so training state survives the round trip.
The two host-device transfers are the design's: installing a plan's rows
(an indexed copy into the scope's device tensor) and reading evicted rows
back (``embedding.device_reads`` counts those reads). Telemetry:
``embedding.cache_{hits,misses,evictions,writebacks}`` counters,
``embedding.hot_hit_rate.<group>`` gauge, ``embedding.host_fetch_latency``
histogram.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..errors import InvalidArgumentError, PreconditionNotMetError

#: fraction buckets for ratio-valued histograms (hit rates, overlap)
RATIO_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                 0.95, 1.0)
#: count buckets for per-batch id histograms
COUNT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                 16384, 65536)


class _Plan:
    """Host-side prep for one batch of one group (prefetch-safe): the
    unique global ids, the ids missing at plan time, and their host row
    payloads per table."""

    __slots__ = ("group", "unique", "counts", "miss_ids", "payload",
                 "prep_seconds", "tick")

    def __init__(self, group, unique, counts, miss_ids, payload,
                 prep_seconds, tick):
        self.group = group
        self.unique = unique
        self.counts = counts
        self.miss_ids = miss_ids
        self.payload = payload  # {var_name: rows [len(miss_ids), ...]}
        self.prep_seconds = prep_seconds
        self.tick = tick  # write-back clock at plan time (staleness check)


class CachedGroup:
    def __init__(self, table_names, vocab, hot_rows, feeds):
        if hot_rows <= 0 or hot_rows > vocab:
            raise InvalidArgumentError(
                f"CachedGroup({table_names}): hot_rows must be in "
                f"(0, vocab={vocab}], got {hot_rows}"
            )
        self.table_names = list(table_names)
        self.name = self.table_names[0]
        self.vocab = int(vocab)
        self.hot_rows = int(hot_rows)
        self.feeds = list(feeds)
        self.host = {}  # var name -> np [vocab, ...] cold store
        self.accums = {}  # table -> [(accum var name, fill value), ...]
        # residency: global row -> slot (-1 = cold), slot -> global row
        self.slot_of = np.full(self.vocab, -1, np.int64)
        self.row_of = np.full(self.hot_rows, -1, np.int64)
        self.counts = np.zeros(self.vocab, np.int64)
        # per-row write-back clock: a prefetched payload row is stale when
        # the row was written back AFTER the plan snapshotted it (install ->
        # train -> evict all inside the prefetch window)
        self._tick = 0
        self._wb_tick = np.zeros(self.vocab, np.int64)
        # per-consumer delta cursors: the checkpointer and the model
        # publisher each track their own committed tick, so one
        # consumer's publish can never swallow rows from the other's
        # next delta (the shared-mark bug)
        self._cursors = {}
        from collections import deque

        self._free = deque(range(self.hot_rows))
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    # -- wiring ------------------------------------------------------------
    def attach(self, scope, main, accums, init_specs=None):
        """Seed the host cold stores: table values from a deterministic
        host-side replay of the table's DECLARED initializer — the full-
        shape startup-op spec the engine captured before shrinking it
        (the device startup only initialized the hot tier, whose values
        are never-read placeholders) — accumulators from their startup
        fill value."""
        blk = main.global_block
        self.accums = dict(accums)
        for t in self.table_names:
            v = blk.var(t)
            tail = tuple(v.shape[1:])
            dtype = v.dtype or "float32"
            seed = (zlib_crc(t) ^ (main.random_seed or 0)) & 0x7FFFFFFF
            self.host[t] = _replay_init(
                (init_specs or {}).get(t), (self.vocab,) + tail, dtype,
                seed, t,
            )
            for aname, fill in self.accums.get(t, ()):
                av = blk.var(aname)
                self.host[aname] = np.full(
                    (self.vocab,) + tuple(av.shape[1:]), fill,
                    av.dtype or "float32",
                )
        self.reset_residency()

    def reset_residency(self):
        from collections import deque

        with self._lock:
            self.slot_of[:] = -1
            self.row_of[:] = -1
            self._free = deque(range(self.hot_rows))

    def restore_residency(self, row_of, scope):
        """Re-pin a checkpointed slot map (engine.load_state_dict) and
        re-install every resident row's tiers from the host store — the
        host is authoritative after a flush, so this is bitwise-correct
        whether or not the device arrays were also restored."""
        from collections import deque

        with self._lock:
            self.row_of[:] = row_of
            self.slot_of[:] = -1
            slots = np.nonzero(self.row_of >= 0)[0]
            rows = self.row_of[slots]
            self.slot_of[rows] = slots
            self._free = deque(
                int(s) for s in np.nonzero(self.row_of < 0)[0]
            )
            if slots.size:
                for vname in self.host:
                    self._install(
                        scope, vname, slots, self.host[vname][rows]
                    )

    def host_bytes(self):
        return int(sum(a.nbytes for a in self.host.values()))

    def device_bytes(self):
        total = 0
        for t in self.table_names:
            row = self.host[t][0]
            total += self.hot_rows * row.nbytes
            for aname, _f in self.accums.get(t, ()):
                total += self.hot_rows * self.host[aname][0].nbytes
        return int(total)

    # -- per-batch ---------------------------------------------------------
    def plan(self, ids):
        """Host-side prep (thread-safe vs apply): unique the batch's ids,
        snapshot the current miss set and gather its host rows. Rows in
        the payload are non-resident at plan time and the host store only
        changes for RESIDENT rows (write-back), so the payload stays fresh
        until :meth:`apply` re-checks residency."""
        from .. import observability as _obs

        t0 = time.perf_counter()
        flat = np.asarray(ids).reshape(-1)
        if flat.size and (flat.min() < 0 or flat.max() >= self.vocab):
            raise InvalidArgumentError(
                f"CachedGroup {self.name!r}: batch ids outside "
                f"[0, {self.vocab}) (got min {flat.min()}, max "
                f"{flat.max()})"
            )
        unique, occ = np.unique(flat, return_counts=True)
        if unique.size > self.hot_rows:
            raise PreconditionNotMetError(
                f"CachedGroup {self.name!r}: batch has {unique.size} "
                f"unique ids but the hot tier holds {self.hot_rows} rows; "
                "raise hot_rows above the max unique ids per batch"
            )
        with self._lock:
            miss = unique[self.slot_of[unique] < 0]
            tick = self._tick
        payload = {}
        for t in self.table_names:
            payload[t] = self.host[t][miss]
            for aname, _f in self.accums.get(t, ()):
                payload[aname] = self.host[aname][miss]
        prep = time.perf_counter() - t0
        _obs.observe("embedding.unique_ids_per_batch", unique.size,
                     COUNT_BUCKETS)
        if flat.size:
            _obs.observe("embedding.dedup_ratio", unique.size / flat.size,
                         RATIO_BUCKETS)
        return _Plan(self, unique, occ, miss, payload, prep, tick)

    def apply(self, plan, scope):
        """Make every id of the plan resident (write-back + install under
        the residency lock, on the step thread), then bump access counts.
        Misses that appeared since plan time (rows another batch evicted)
        fetch synchronously; rows that BECAME resident skip their stale
        payload."""
        from .. import observability as _obs

        t0 = time.perf_counter()
        with self._lock:
            still_miss = plan.unique[self.slot_of[plan.unique] < 0]
            hits = plan.unique.size - still_miss.size
            self._hits += hits
            self._misses += still_miss.size
            if still_miss.size:
                slots = self._take_slots(still_miss, plan.unique, scope)
                # both arrays are sorted-unique (np.unique output and a
                # mask of it): searchsorted maps each still-missing row to
                # its payload position, no per-element Python on the step
                # thread
                if plan.miss_ids.size:
                    pick = np.clip(
                        np.searchsorted(plan.miss_ids, still_miss),
                        0, plan.miss_ids.size - 1,
                    )
                    planned = plan.miss_ids[pick] == still_miss
                else:
                    pick = np.zeros(still_miss.shape, np.int64)
                    planned = np.zeros(still_miss.shape, bool)
                # a row written back since the plan snapshot carries newer
                # trained state than the prefetched payload — refetch it
                planned &= self._wb_tick[still_miss] <= plan.tick
                for vname in plan.payload:
                    if planned.all():
                        rows = plan.payload[vname][pick]
                    else:
                        # late misses (rows another batch evicted since
                        # plan time): their payload rows are stale or
                        # absent — refetch from the host store
                        rows = self.host[vname][still_miss].copy()
                        if planned.any():
                            rows[planned] = plan.payload[vname][
                                pick[planned]
                            ]
                    self._install(scope, vname, slots, rows)
                self.slot_of[still_miss] = slots
                self.row_of[slots] = still_miss
            self.counts[plan.unique] += plan.counts
        _obs.add("embedding.cache_hits", int(hits))
        _obs.add("embedding.cache_misses", int(still_miss.size))
        if still_miss.size:
            _obs.observe(
                "embedding.host_fetch_latency", time.perf_counter() - t0
            )
        total = self._hits + self._misses
        if total:
            _obs.set_gauge(
                f"embedding.hot_hit_rate.{self.name}", self._hits / total
            )

    def translate(self, ids):
        """Global ids -> hot slot ids (same shape/dtype). Every id must be
        resident (apply() ran for this batch)."""
        arr = np.asarray(ids)
        slots = self.slot_of[arr.reshape(-1)]
        if slots.size and slots.min() < 0:
            raise PreconditionNotMetError(
                f"CachedGroup {self.name!r}: translate() saw a non-resident "
                "id; call apply()/prepare_feed() for this exact batch first"
            )
        return slots.reshape(arr.shape).astype(arr.dtype)

    # -- internals (residency lock held) -----------------------------------
    def _take_slots(self, need, protect, scope):
        """Free or evict len(need) slots; never evicts a row in `protect`
        (the incoming batch). Eviction order: lowest access count."""
        from .. import observability as _obs

        n = need.size
        slots = []
        while self._free and len(slots) < n:
            slots.append(self._free.popleft())
        short = n - len(slots)
        if short > 0:
            resident = self.row_of[self.row_of >= 0]
            evictable = resident[~np.isin(resident, protect,
                                          assume_unique=True)]
            if evictable.size < short:
                raise PreconditionNotMetError(
                    f"CachedGroup {self.name!r}: cannot free {short} slots "
                    f"({evictable.size} evictable rows); raise hot_rows"
                )
            victims = evictable[
                np.argsort(self.counts[evictable], kind="stable")[:short]
            ]
            vslots = self.slot_of[victims]
            self._writeback(scope, victims, vslots)
            self.slot_of[victims] = -1
            self.row_of[vslots] = -1
            slots.extend(int(s) for s in vslots)
            _obs.add("embedding.cache_evictions", int(short))
        return np.asarray(slots[:n], np.int64)

    def _writeback(self, scope, rows, slots):
        """Pull trained slot rows (+ optimizer state) device->host."""
        from .. import observability as _obs

        self._tick += 1
        self._wb_tick[rows] = self._tick
        for t in self.table_names:
            names = [t] + [a for a, _f in self.accums.get(t, ())]
            for vname in names:
                arr = scope.find_var(vname)
                if arr is None:
                    continue
                idx = torch.as_tensor(slots, device=arr.device)
                # the design's device -> host read (waits for the card)
                self.host[vname][rows] = (
                    arr.index_select(0, idx).cpu().numpy())
                _obs.add("embedding.device_reads")
        _obs.add("embedding.cache_writebacks", int(rows.size))

    def _install(self, scope, vname, slots, rows):
        arr = scope.find_var(vname)
        if arr is None:
            raise PreconditionNotMetError(
                f"cached var {vname!r} is not initialized in the scope; "
                "run the startup program before engine.attach"
            )
        # an indexed copy into the scope's tensor: the rows cross to the
        # card once, and the rest of the hot tier stays where it is
        idx = torch.as_tensor(np.asarray(slots), device=arr.device)
        src = torch.as_tensor(np.ascontiguousarray(rows)).to(
            device=arr.device, dtype=arr.dtype)
        arr.index_copy_(0, idx, src)

    def flush(self, scope):
        with self._lock:
            resident_slots = np.nonzero(self.row_of >= 0)[0]
            if not resident_slots.size:
                return
            rows = self.row_of[resident_slots]
            self._writeback(scope, rows, resident_slots)

    # -- tiered-checkpoint delta hooks ---------------------------------------
    def delta_tick(self):
        """Current write-back clock value — the mark a delta checkpoint
        records so the next save can name exactly the host rows that
        changed since (host stores mutate ONLY through write-back, so
        rows at or below a recorded tick are bitwise unchanged)."""
        with self._lock:
            return int(self._tick)

    def dirty_rows_since(self, tick):
        """Global row indices written back after `tick` — the row-level
        delta payload for every host store of this group."""
        with self._lock:
            return np.nonzero(self._wb_tick > int(tick))[0]

    def consumer_mark(self, consumer):
        """The tick `consumer` (e.g. "checkpoint", "publish") last
        committed, or None before its first full payload."""
        with self._lock:
            return self._cursors.get(consumer)

    def commit_consumer_mark(self, consumer, mark):
        """Advance `consumer`'s committed cursor — call ONLY after the
        payload covering rows up to `mark` durably landed; marks never
        regress, so a stale late commit cannot re-expose rows."""
        with self._lock:
            cur = self._cursors.get(consumer)
            if cur is None or int(mark) > cur:
                self._cursors[consumer] = int(mark)


def zlib_crc(s: str) -> int:
    import zlib

    return zlib.crc32(s.encode())


def _replay_init(spec, shape, dtype, seed, name):
    """Host-side replay of a table's startup init op at the FULL vocab
    shape. The distribution honors the user's declared initializer (the
    attrs carry the concrete bounds Xavier/Uniform/Normal computed at
    build time from the full shape); the draw itself is a deterministic
    numpy stream — device and host PRNGs can never agree bitwise, and the
    cold store is the authoritative init for a cached table."""
    rng = np.random.RandomState(seed)
    op_type, attrs = spec if spec else (None, {})
    if op_type == "fill_constant":
        return np.full(shape, float(attrs.get("value", 0.0)), dtype)
    if op_type == "uniform_random":
        return rng.uniform(
            float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0)),
            shape,
        ).astype(dtype)
    if op_type in ("gaussian_random", "truncated_gaussian_random"):
        std = float(attrs.get("std", 1.0))
        out = rng.normal(float(attrs.get("mean", 0.0)), std, shape)
        if op_type == "truncated_gaussian_random":
            mean = float(attrs.get("mean", 0.0))
            out = np.clip(out, mean - 2 * std, mean + 2 * std)
        return out.astype(dtype)
    import warnings

    warnings.warn(
        f"CachedGroup: no host replay for init op {op_type!r} of table "
        f"{name!r}; falling back to Xavier-uniform over the full shape",
        stacklevel=2,
    )
    fan = shape[0] + (shape[1] if len(shape) > 1 else 1)
    limit = np.sqrt(6.0 / fan)
    return rng.uniform(-limit, limit, shape).astype(dtype)
