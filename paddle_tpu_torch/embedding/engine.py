"""Embedding engine: the fused-lookup transform + the cache orchestrator
(counterpart of paddle_tpu/embedding/engine.py).

``fuse_lookups`` is a pure Program transform (run it on the forward graph
BEFORE ``optimizer.minimize`` so the fused op is what append_backward
differentiates). ``EmbeddingEngine`` owns the host-cold/device-hot cache
tiers (cache.py) and the feed translation that makes them invisible to the
program: the device only ever sees hot-slot ids.
"""

from __future__ import annotations

import numpy as np

from ..errors import InvalidArgumentError
from ..parallel.sparse import LOOKUP_OPS

# ops a lookup's id input may be derived through when walking back to the
# feed that produced it (slice a [B, F] feature block per slot, reshape,
# cast — the host-side translation then rewrites that FEED once)
_ID_CHAIN_OPS = frozenset({
    "slice", "strided_slice", "reshape", "reshape2", "squeeze", "squeeze2",
    "unsqueeze", "unsqueeze2", "cast", "assign", "split", "concat", "stack",
})


def fuse_lookups(program, min_group=2):
    """Coalesce same-width ``distributed_lookup_table`` ops in the global
    block into ``fused_lookup_table`` ops.

    Grouping key: (embed dim, table dtype, axis_name, partition, dedup,
    quant) — every member of a group gathers from the same concatenated
    key space in ONE op; the original output var names are preserved so
    downstream consumers (and the backward pass appended later) are
    untouched. The fused op lands at the LAST member's position (every
    member's ids are produced before it by construction), so interleaved
    slice/lookup chains fuse too; a group closes early when an op between
    members reads one of its outputs (that consumer would otherwise see
    its input produced later).

    Run BEFORE ``optimizer.minimize``: append_backward differentiates the
    fused op into one segment-sum scatter per table. Returns the number of
    fused sites created.
    """
    blk = program.global_block

    groups = []  # [[op_index, ...], ...] in program order
    open_groups = {}  # key -> (groups index, set of member output names)
    for i, op in enumerate(blk.ops):
        if op.type != "distributed_lookup_table":
            # an intermediate reader of a group output pins that group:
            # its members can no longer move past this op
            reads = set(op.input_names())
            for key, (gi, outs) in list(open_groups.items()):
                if reads & outs:
                    del open_groups[key]
            continue
        w = (op.inputs.get("W") or [""])[0]
        ids = (op.inputs.get("Ids") or [""])[0]
        out = (op.outputs.get("Out") or [""])[0]
        if not w or not ids or not out:
            continue
        wv = blk._find_var_recursive(w)
        if wv is None or not wv.shape or len(wv.shape) != 2:
            continue
        key = (
            int(wv.shape[1]), wv.dtype, op.attr("axis_name", "ps"),
            op.attr("partition", "row"), bool(op.attr("dedup", True)),
            op.attr("quant", "none") or "none",
            int(op.attr("quant_block", 256) or 256),
        )
        if key in open_groups:
            gi, outs = open_groups[key]
            groups[gi].append(i)
            outs.add(out)
        else:
            groups.append([i])
            open_groups[key] = (len(groups) - 1, {out})

    fused = 0
    drop = set()
    for members in groups:
        if len(members) < max(int(min_group), 2):
            continue
        ops = [blk.ops[i] for i in members]
        first = ops[0]
        # slots sharing one table (DeepFM per_slot: every slot reads the
        # same shared table) must share ONE key-space segment, or the same
        # id in two slots would get two distinct keys (no cross-slot
        # dedup) and the gather operand would concatenate F aliases of
        # one table: the W slot carries each table ONCE, and
        # slot_table_idx maps every ids slot to its table segment
        uniq, slot_idx = [], []
        for o in ops:
            w = o.inputs["W"][0]
            if w not in uniq:
                uniq.append(w)
            slot_idx.append(uniq.index(w))
        blk.ops[members[-1]] = type(first)(
            blk, "fused_lookup_table",
            inputs={
                "Ids": [o.inputs["Ids"][0] for o in ops],
                "W": uniq,
            },
            outputs={"Out": [o.outputs["Out"][0] for o in ops]},
            attrs={
                "axis_name": first.attr("axis_name", "ps"),
                "partition": first.attr("partition", "row"),
                "dedup": bool(first.attr("dedup", True)),
                "quant": first.attr("quant", "none") or "none",
                "quant_block": int(first.attr("quant_block", 256) or 256),
                "slot_table_idx": slot_idx,
                "__loc__": first.attr("__loc__", ""),
            },
        )
        drop.update(members[:-1])
        fused += 1
    if drop:
        blk.ops = [op for i, op in enumerate(blk.ops) if i not in drop]
    program._bump()
    from .. import observability as _obs

    if fused:
        _obs.add("embedding.fuse_transforms", fused)
    return fused


def _feed_sources(program, name, depth=0):
    """Walk a lookup id input back through slice/reshape-style producers to
    the data (feed) vars it derives from."""
    blk = program.global_block
    v = blk._find_var_recursive(name)
    if v is not None and v.is_data:
        return {name}
    if depth > 8:
        return set()
    out = set()
    for op in blk.ops:
        if name not in op.output_names():
            continue
        if op.type not in _ID_CHAIN_OPS:
            return set()  # unsupported derivation (e.g. computed ids)
        for n in op.input_names():
            if n:
                out |= _feed_sources(program, n, depth + 1)
        break
    return out


class EmbeddingEngine:
    """Host-cold / device-hot tiering for sparse tables.

    Usage (order matters — the hot tier must exist before minimize so the
    optimizer's accumulators are hot-sized too)::

        loss, pred = deepfm(ids, label, cfg, per_slot=True)
        fuse_lookups(main)
        engine = EmbeddingEngine(main, startup,
                                 hot_rows={"deepfm_emb": 4096,
                                           "deepfm_w1": 4096})
        optimizer.SGD(lr).minimize(loss)
        engine.attach(scope)          # after exe.run(startup)
        for feed in Prefetcher(engine, feeds, scope):
            exe.run(main, feed=feed, ...)

    Tables sharing an id feed (DeepFM's first-order + factor tables both
    read ``feat_ids``) form one :class:`~.cache.CachedGroup`
    with a shared slot map, so one translation serves both. ``hot_rows``
    may be an int (every table) or {table: rows}. Parity contract: with a
    stateless update rule (SGD) the cached run is bitwise-identical to the
    full-table run; stateful rules (Adam) get the reference's lazy sparse
    semantics (absent rows' moments do not decay).
    """

    def __init__(self, main, startup, hot_rows, tables=None):
        from ..parallel.sparse import sparse_table_names

        self.main = main
        self.startup = startup
        all_tables = sparse_table_names(main)
        if tables is None:
            tables = (
                sorted(hot_rows) if isinstance(hot_rows, dict) else all_tables
            )
        unknown = [t for t in tables if t not in all_tables]
        if unknown:
            raise InvalidArgumentError(
                f"EmbeddingEngine: {unknown} are not sparse tables of this "
                f"program (tables: {all_tables})"
            )
        self._hot = {
            t: int(hot_rows[t] if isinstance(hot_rows, dict) else hot_rows)
            for t in tables
        }
        self.groups = []
        self._feed_to_group = {}
        self._build_groups()
        self._convert()
        self._attached = False

    # -- program rewrite ---------------------------------------------------
    def _build_groups(self):
        from .cache import CachedGroup

        feed_sets = {}  # table -> frozenset of feeds
        for blk in self.main.blocks:
            for op in blk.ops:
                if op.type not in LOOKUP_OPS:
                    continue
                ids_list = op.inputs.get("Ids", ())
                w_list = op.inputs.get("W", ())
                # slot -> table via the fused op's slot_table_idx (the W
                # slot carries each table once; a plain zip would pair
                # only the first len(W) id slots and silently drop the
                # rest of the feeds from the group)
                slot_idx = op.attr("slot_table_idx")
                if slot_idx is None:
                    slot_idx = (
                        [0] * len(ids_list) if len(w_list) == 1
                        else list(range(len(ids_list)))
                    )
                for i, ids in enumerate(ids_list):
                    w = w_list[slot_idx[i]]
                    if w not in self._hot:
                        continue
                    srcs = _feed_sources(self.main, ids)
                    if not srcs:
                        raise InvalidArgumentError(
                            f"EmbeddingEngine: cannot trace the ids of "
                            f"cached table {w!r} back to a feed variable "
                            f"(id input {ids!r} is computed in-graph); the "
                            "host-side id translation needs feed-level ids"
                        )
                    feed_sets.setdefault(w, set()).update(srcs)
        missing = [t for t in self._hot if t not in feed_sets]
        if missing:
            raise InvalidArgumentError(
                f"EmbeddingEngine: no lookup op consumes tables {missing}"
            )
        by_feeds = {}
        for t, feeds in feed_sets.items():
            by_feeds.setdefault(frozenset(feeds), []).append(t)
        blk = self.main.global_block
        for feeds, tabs in sorted(by_feeds.items(), key=lambda kv: kv[1]):
            vocabs = {int(blk.var(t).shape[0]) for t in tabs}
            if len(vocabs) != 1:
                raise InvalidArgumentError(
                    f"EmbeddingEngine: tables {sorted(tabs)} share id feed "
                    f"{sorted(feeds)} but have different (padded) vocabs "
                    f"{sorted(vocabs)}; they cannot share one slot map"
                )
            hots = {self._hot[t] for t in tabs}
            if len(hots) != 1:
                raise InvalidArgumentError(
                    f"EmbeddingEngine: tables {sorted(tabs)} share one slot "
                    f"map and must share hot_rows, got {sorted(hots)}"
                )
            group = CachedGroup(
                sorted(tabs), vocab=vocabs.pop(), hot_rows=hots.pop(),
                feeds=sorted(feeds),
            )
            self.groups.append(group)
            for f in feeds:
                if f in self._feed_to_group:
                    raise InvalidArgumentError(
                        f"EmbeddingEngine: feed {f!r} feeds cached tables "
                        "in two different groups; merge their vocab spaces"
                    )
                self._feed_to_group[f] = group

    def _convert(self):
        """Shrink every cached table (and later its accumulators/grads,
        which minimize will create at the already-shrunk shape) to the
        hot-tier row count, in main + startup, including the startup init
        op — the full [V, D] tensor never materializes on device. The
        init op's ORIGINAL full-shape spec is captured first: it is the
        table's real initialization, replayed host-side into the cold
        store (the shrunk device init is a never-read placeholder)."""
        self._init_specs = {}
        for g in self.groups:
            for t in g.table_names:
                for prog in (self.main, self.startup):
                    v = prog.global_block.vars.get(t)
                    if v is None:
                        continue
                    if v.shape[0] != g.vocab:
                        raise InvalidArgumentError(
                            f"EmbeddingEngine: table {t!r} already has "
                            f"{v.shape[0]} rows (expected {g.vocab}); "
                            "construct the engine before minimize and "
                            "only once"
                        )
                    v.shape = (g.hot_rows,) + tuple(v.shape[1:])
                for op in self.startup.global_block.ops:
                    if t in op.output_names() and "shape" in op.attrs:
                        self._init_specs[t] = (op.type, dict(op.attrs))
                        shape = list(op.attrs["shape"])
                        shape[0] = g.hot_rows
                        op.attrs["shape"] = shape
        self.main._bump()
        self.startup._bump()

    # -- runtime -----------------------------------------------------------
    def attach(self, scope):
        """Bind the engine to a scope AFTER ``exe.run(startup)``: discover
        the (hot-sized) optimizer accumulators, seed the host cold stores,
        and mark every hot slot empty (the startup-initialized hot values
        are placeholders; first-touch misses install the real rows)."""
        blk = self.main.global_block
        for g in self.groups:
            accums = {}
            for name, v in blk.vars.items():
                parent = getattr(v, "_accum_of", None)
                if (
                    parent in g.table_names
                    and v.shape
                    and v.shape[0] == g.hot_rows
                ):
                    accums.setdefault(parent, []).append(
                        (name, self._startup_fill(name))
                    )
            g.attach(scope, self.main, accums,
                     init_specs=self._init_specs)
        self._attached = True
        from .. import observability as _obs

        for g in self.groups:
            _obs.set_gauge(f"embedding.hot_rows.{g.name}", g.hot_rows)
            _obs.set_gauge(f"embedding.vocab_rows.{g.name}", g.vocab)
            _obs.set_gauge(f"embedding.host_bytes.{g.name}", g.host_bytes())
            _obs.set_gauge(
                f"embedding.device_bytes.{g.name}", g.device_bytes()
            )

    def _startup_fill(self, name):
        """Constant fill value of an accumulator's startup init (its host
        mirror must cold-start absent rows at the same value)."""
        for op in self.startup.global_block.ops:
            if name in op.output_names():
                return float(op.attr("value", 0.0) or 0.0)
        return 0.0

    def plan(self, feed):
        """Host-side prep for one batch (safe off-thread): ONE plan per
        group, covering every id feed of the group present in this batch
        (a multi-feed group must see its ids together — per-feed plans
        would translate the same feed twice in apply). Returns an opaque
        plan list for :meth:`apply`."""
        self._check_attached()
        plans = []
        for g in self.groups:
            present = [f for f in g.feeds if f in feed]
            if not present:
                continue
            ids = np.concatenate(
                [np.asarray(feed[f]).reshape(-1) for f in present]
            )
            plans.append(g.plan(ids))
        return plans

    def apply(self, plans, feed, scope):
        """Install a plan's rows (miss fetch + eviction write-back), then
        translate the id feeds to hot-slot ids. Returns the translated
        feed (a shallow copy; untouched entries shared)."""
        self._check_attached()
        out = dict(feed)
        for p in plans:
            g = p.group
            g.apply(p, scope)
            for fname in g.feeds:
                if fname in out:
                    out[fname] = g.translate(np.asarray(out[fname]))
        return out

    def prepare_feed(self, feed, scope):
        """plan + apply in one synchronous call (the no-prefetch path)."""
        return self.apply(self.plan(feed), feed, scope)

    def flush(self, scope):
        """Write every resident row (and its optimizer state) back to the
        host cold store — call before checkpointing or reading
        :meth:`state_dict`."""
        self._check_attached()
        for g in self.groups:
            g.flush(scope)

    # -- checkpoint --------------------------------------------------------
    def state_dict(self, scope):
        """Flushed host stores + access counts + the residency map, keyed
        for np.savez. Residency IS training state: with a stateful update
        rule (momentum/adam, lazy semantics) resident-but-unused rows keep
        evolving on device, so an exact resume must re-pin the same rows
        to the same slots."""
        self.flush(scope)
        out = {}
        for g in self.groups:
            out[f"{g.name}::counts"] = g.counts.copy()
            out[f"{g.name}::row_of"] = g.row_of.copy()
            for t in g.table_names:
                out[f"{g.name}::host::{t}"] = g.host[t].copy()
                for aname, _fill in g.accums.get(t, ()):
                    out[f"{g.name}::host::{aname}"] = g.host[aname].copy()
        return out

    def delta_row_oracles(self, consumer=None):
        """Row oracles for tiered checkpointing, keyed by the
        :meth:`state_dict` host-store names: ``oracle(last_mark) ->
        (dirty_rows, new_mark)`` backed by each group's write-back tick
        — a delta save then carries only the host rows written back
        since the last published save instead of the full ``[V, ...]``
        stores (``fleet.AsyncCheckpointer(row_oracles=...)``). With
        ``last_mark=None`` (no published base yet) rows is None, which
        tells the checkpointer to store the array in full.

        `consumer` names an independent group-side cursor ("checkpoint",
        "publish", ...): with it, an ``oracle(None)`` falls back to the
        consumer's last COMMITTED mark (:meth:`commit_row_marks`) instead
        of "no base", so two delta chains — a checkpoint save landing
        between two model publishes, say — each see every row dirtied
        since their OWN last payload; without per-consumer cursors one
        chain's publish would silently swallow the other's rows."""

        def _make(group):
            def oracle(last_mark):
                mark = group.delta_tick()
                last = last_mark
                if last is None and consumer is not None:
                    last = group.consumer_mark(consumer)
                if last is None:
                    return None, mark
                return group.dirty_rows_since(last), mark

            return oracle

        out = {}
        for g in self.groups:
            oracle = _make(g)
            for t in g.table_names:
                out[f"{g.name}::host::{t}"] = oracle
                for aname, _fill in g.accums.get(t, ()):
                    out[f"{g.name}::host::{aname}"] = oracle
        return out

    def commit_row_marks(self, consumer, marks):
        """Durably advance `consumer`'s cursors after its payload
        committed. `marks` is the ``{oracle key: mark}`` dict built from
        the oracles' returned marks; keys map back to groups by their
        ``{group}::host::`` prefix."""
        for g in self.groups:
            prefix = f"{g.name}::host::"
            group_marks = [
                m for k, m in marks.items() if k.startswith(prefix)
            ]
            if group_marks:
                g.commit_consumer_mark(consumer, max(group_marks))

    def load_state_dict(self, state, scope):
        """Restore :meth:`state_dict` output. The hot-tier DEVICE arrays
        are ordinary persistables restored by the checkpoint load
        (io.load_persistables) — call this AFTER it; this call re-pins the
        saved slot map over them (flush() made host and device agree for
        resident rows, so either source is bitwise-correct)."""
        self._check_attached()
        for g in self.groups:
            g.counts[:] = state[f"{g.name}::counts"]
            for t in list(g.host):
                key = f"{g.name}::host::{t}"
                if key in state:
                    g.host[t][:] = state[key]
            row_of = state.get(f"{g.name}::row_of")
            if row_of is None:
                g.reset_residency()
            else:
                g.restore_residency(np.asarray(row_of), scope)

    def _check_attached(self):
        if not self._attached:
            from ..errors import PreconditionNotMetError

            raise PreconditionNotMetError(
                "EmbeddingEngine is not attached; run the startup program "
                "and call engine.attach(scope) first"
            )
