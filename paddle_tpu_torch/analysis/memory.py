"""Static peak-HBM planner + donation/liveness verifier — the memory
analysis family (counterpart of paddle_tpu/analysis/memory.py).

The planner answers *will this Program fit in HBM?* before it runs: a
per-op live-interval simulation over the IR, with shapes resolved the
same way the cost walker resolves them (declared Variable shapes, -1
batch dims pinned by ``feed_shapes`` / the batch hint). Its rules are the
JAX package's, so one program gives one plan in both packages. It plans
the buffers a whole-block compiler would assign (XLA's, in the JAX
package); the port's eager executor keeps every intermediate of a step
in its environment until the step ends, so the peak measured on the card
(``Executor.memory_analysis``: ``torch.cuda.max_memory_allocated``) is
set beside this plan, not held to it.

Accounting model:

* **resident** — every *persistable* the program references (parameters,
  optimizer state, KV caches), counted once, sharding-aware: a var whose
  ``program._sharding`` spec names mesh axes is divided by those axis
  sizes (ZeRO ``[pad]`` shards, row/col-partitioned embedding tables);
  hot-tier-shrunk tables need no special case because the embedding
  engine rewrites the *declared* shape in place.
* **feeds** — input buffers, live for the whole step.
* **transients** — everything else lives from first def to last use; the
  peak of ``resident + feeds + live transient set`` over the op walk is
  ``peak_bytes``, and the op where it happens is the **watermark**
  (anchored to its ``__loc__`` source frame).
* ``recompute_segment`` interiors die at the segment boundary (that is
  the point of checkpointing) and are re-materialized as the backward
  op's working set; a segment whose interior set is empty saves nothing
  → ``recompute-no-savings`` INFO.
* ``pipeline_block`` stage sub-blocks report per-stage transient peaks
  (each stage's activations live on its own device).
* ``cond`` branches charge the branch with the larger transient peak;
  loop bodies are walked once (one iteration's live set — double
  buffering is not modeled; recorded in assumptions).

On top of the intervals, the donation verifier: an op whose
:class:`~paddle_tpu_torch.framework.registry.OpDef` declares ``mutates``
aliases an output over an input buffer (``kv_cache_write``, the
optimizer write-backs). Reading the donated input *after* the donating
write observes a dead buffer under the executor's donation contract →
``use-after-donate`` ERROR. The inverse — a persistable whose last read
feeds a same-shape/dtype write through a non-mutating op — is a missed
aliasing opportunity → ``missed-donation`` INFO.

``oom-risk`` (WARNING, escalated to an error under strict verify) fires
when ``peak_bytes`` exceeds ``PADDLE_TPU_HBM_BYTES`` (plain bytes, or
``"16G"``-style binary suffixes).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .cost import _SKIP_OPS, family_of, itemsize
from .findings import (
    MISSED_DONATION,
    OOM_RISK,
    RECOMPUTE_NO_SAVINGS,
    USE_AFTER_DONATE,
    Finding,
    Severity,
)

_SUFFIXES = {"k": 2 ** 10, "m": 2 ** 20, "g": 2 ** 30, "t": 2 ** 40}

# missed-donation only surfaces buffers worth aliasing; scalar
# bookkeeping (learning rate, beta pows) is noise below this
_MISSED_DONATION_MIN_BYTES = 64 * 2 ** 10


def hbm_budget():
    """Per-device HBM budget in bytes from ``PADDLE_TPU_HBM_BYTES``
    (plain float bytes, or a ``K``/``M``/``G``/``T`` binary suffix:
    ``"16G"`` = 16 GiB). ``None`` when unset or unparseable."""
    raw = os.environ.get("PADDLE_TPU_HBM_BYTES", "").strip().lower()
    if not raw:
        return None
    mult = 1.0
    if raw[-1] in _SUFFIXES:
        mult = _SUFFIXES[raw[-1]]
        raw = raw[:-1]
    try:
        val = float(raw) * mult
    except ValueError:
        return None
    return val if val > 0 else None


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit, size in (("GiB", 2 ** 30), ("MiB", 2 ** 20), ("KiB", 2 ** 10)):
        if n >= size:
            return f"{n / size:.2f} {unit}"
    return f"{n:.0f} B"


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@dataclass
class MemoryTable:
    """The planner's output: byte totals, the watermark op, the per-op
    live-set timeline, per-pipeline-stage peaks, and the memory-family
    findings the walk produced."""

    resident_bytes: float = 0.0
    feed_bytes: float = 0.0
    transient_peak_bytes: float = 0.0
    peak_bytes: float = 0.0
    budget_bytes: float | None = None
    watermark: dict | None = None
    timeline: list = field(default_factory=list)
    stage_peaks: dict = field(default_factory=dict)
    residents: list = field(default_factory=list)  # (name, bytes) desc
    assumptions: list = field(default_factory=list)
    findings: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "resident_bytes": float(self.resident_bytes),
            "feed_bytes": float(self.feed_bytes),
            "transient_peak_bytes": float(self.transient_peak_bytes),
            "peak_bytes": float(self.peak_bytes),
            "budget_bytes": (
                float(self.budget_bytes)
                if self.budget_bytes is not None else None
            ),
            "watermark": dict(self.watermark) if self.watermark else None,
            "stage_peaks": {
                int(k): float(v) for k, v in sorted(self.stage_peaks.items())
            },
            "top_residents": [
                {"name": n, "bytes": float(b)} for n, b in self.residents[:10]
            ],
            "timeline_ops": len(self.timeline),
            "assumptions": list(self.assumptions),
            "findings": [
                {"severity": f.severity.name, "category": f.category}
                for f in self.findings
            ],
        }

    def format(self, top: int = 5) -> str:
        lines = [
            "static memory: resident "
            f"{_fmt_bytes(self.resident_bytes)} + feeds "
            f"{_fmt_bytes(self.feed_bytes)} + transient peak "
            f"{_fmt_bytes(self.transient_peak_bytes)} = peak "
            f"{_fmt_bytes(self.peak_bytes)}"
        ]
        if self.budget_bytes is not None:
            verdict = "OVER" if self.peak_bytes > self.budget_bytes else "ok"
            lines.append(
                f"  budget {_fmt_bytes(self.budget_bytes)} "
                f"(PADDLE_TPU_HBM_BYTES): {verdict}"
            )
        wm = self.watermark
        if wm:
            where = f"op #{wm['op_index']} {wm['op_type']!r}"
            if wm.get("block_idx"):
                where += f" block {wm['block_idx']}"
            if wm.get("loc"):
                where += f", created at {wm['loc']}"
            lines.append(
                f"  watermark: {where}  "
                f"live {_fmt_bytes(wm['live_bytes'])}"
            )
            for name, b in (wm.get("top_live") or [])[:top]:
                lines.append(f"    live: {name}  {_fmt_bytes(b)}")
        for s, b in sorted(self.stage_peaks.items()):
            lines.append(
                f"  pipeline stage {s}: transient peak {_fmt_bytes(b)}"
            )
        for a in self.assumptions:
            lines.append(f"  assuming: {a}")
        return "\n".join(lines)


class _Event:
    """One flattened walk step: the names it reads/writes, where it came
    from, its donation pairs, and any op-local working set (bytes that are
    live only while the op runs — the recompute-backward rematerialized
    interiors)."""

    __slots__ = ("op_type", "reads", "writes", "block_idx", "op_index",
                 "loc", "stage", "extra_bytes", "donations", "reuse")

    def __init__(self, op_type, reads, writes, block_idx, op_index, loc,
                 stage=None, extra_bytes=0.0, donations=(), reuse=False):
        self.op_type = op_type
        self.reads = reads
        self.writes = writes
        self.block_idx = block_idx
        self.op_index = op_index
        self.loc = loc
        self.stage = stage
        self.extra_bytes = extra_bytes
        self.donations = donations
        self.reuse = reuse


class _VarInfo:
    __slots__ = ("nbytes", "shape", "dtype", "persistable", "is_data")

    def __init__(self, nbytes, shape, dtype, persistable, is_data):
        self.nbytes = nbytes
        self.shape = shape
        self.dtype = dtype
        self.persistable = persistable
        self.is_data = is_data


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


class _MemoryPlanner:
    def __init__(self, program, feed_names, fetch_names, feed_shapes):
        self.program = program
        self.feed_shapes = {
            k: tuple(int(d) for d in v)
            for k, v in (feed_shapes or {}).items()
        }
        self.batch_hint = next(
            (s[0] for s in self.feed_shapes.values() if s), 1
        )
        self.fetch_names = tuple(fetch_names or ())
        if feed_names:
            self.feed_names = tuple(feed_names)
        else:
            self.feed_names = tuple(
                v.name
                for v in program.global_block.vars.values()
                if getattr(v, "is_data", False)
            )
        mesh = getattr(program, "_mesh", None)
        self.axis_sizes = dict(mesh.shape) if mesh is not None else {}
        self.sharding = dict(getattr(program, "_sharding", None) or {})
        self.events = []
        self.vars = {}  # name -> _VarInfo (first block that resolved it)
        self.pinned = set()
        self.assumptions = []
        self.findings = []
        self.segments = []  # (op, block_idx, op_index, interior_bytes, n_sub)
        self.saw_backward = False

    # -- shape / byte resolution -------------------------------------------
    def _info(self, block, name):
        info = self.vars.get(name)
        if info is not None:
            return info
        v = block._find_var_recursive(name)
        if name in self.feed_shapes:
            shape = self.feed_shapes[name]
            dtype = (v.dtype if v is not None and v.dtype else "float32")
        elif v is None or v.shape is None:
            return None
        else:
            shape = []
            for di, d in enumerate(v.shape):
                if d in (-1, None):
                    shape.append(self.batch_hint)
                    self.pinned.add((name, di))
                else:
                    shape.append(int(d))
            shape = tuple(shape)
            dtype = v.dtype or "float32"
        elems = 1.0
        spec = self.sharding.get(name)
        for di, d in enumerate(shape):
            d = float(max(int(d), 0))
            if spec is not None and di < len(spec) and spec[di]:
                axes = spec[di]
                if not isinstance(axes, (tuple, list)):
                    axes = (axes,)
                for ax in axes:
                    size = self.axis_sizes.get(ax)
                    if size:
                        d = float(-(-int(d) // int(size)))  # ceil shard
            elems *= d
        info = _VarInfo(
            nbytes=elems * itemsize(dtype),
            shape=shape,
            dtype=str(dtype),
            persistable=bool(v is not None and v.persistable),
            is_data=bool(v is not None and getattr(v, "is_data", False)),
        )
        self.vars[name] = info
        return info

    def _bytes(self, block, name):
        info = self._info(block, name)
        return info.nbytes if info is not None else 0.0

    # -- flattening --------------------------------------------------------
    def _names(self, slot_names):
        return tuple(
            n for names in (slot_names or {}).values() for n in names if n
        )

    def _donations(self, op_type, op_ins, op_outs):
        from ..framework.registry import _REGISTRY

        op_def = _REGISTRY.get(op_type)
        if op_def is None or not op_def.mutates:
            return ()
        pairs = []
        for out_slot, in_slot in op_def.mutates:
            onames = (op_outs or {}).get(out_slot) or []
            inames = (op_ins or {}).get(in_slot) or []
            for iname, oname in zip(inames, onames):
                if iname and oname and iname != oname:
                    pairs.append((iname, oname))
        return tuple(pairs)

    def _emit(self, block, op_type, op_ins, op_outs, block_idx, op_index,
              loc, stage, extra_bytes=0.0, fwd_type=None):
        reads = self._names(op_ins)
        writes = self._names(op_outs)
        for n in reads + writes:
            self._info(block, n)  # resolve byte sizes eagerly
        # a compiler's buffer assignment lets an elementwise(-fused) op
        # write over an input buffer that dies at that op, so input and
        # output are never both live — model that reuse for the during-op
        # window.
        # data_movement qualifies too: assign/reshape/cast outputs alias
        # (or copy-elide onto) an input that dies at the op, the pattern
        # autodiff's grad-accumulation renames produce in bulk
        reuse = family_of(fwd_type or op_type) in (
            "elementwise", "normalization", "data_movement"
        )
        self.events.append(_Event(
            op_type, reads, writes, block_idx, op_index, loc, stage,
            extra_bytes, self._donations(op_type, op_ins, op_outs), reuse,
        ))

    def walk_block(self, block, depth=0, stage=None):
        if depth > 16:
            return
        for i, op in enumerate(block.ops):
            self.visit(op, block, i, depth, stage)

    def visit(self, op, block, op_index, depth, stage):
        t = op.type
        if t in _SKIP_OPS:
            return
        loc = str(op.attr("__loc__", "") or "")
        if t == "__vjp__":
            self._visit_vjp(op, block, op_index, stage, loc)
            return
        if t in ("pipeline_block", "pipeline_uniform"):
            self._visit_pipeline(op, block, depth)
            return
        if t == "recompute_segment":
            self._visit_recompute(op, block, op_index, depth, stage, loc)
            return
        if t in ("cond", "conditional_block", "conditional_block_infer"):
            self._visit_branch(op, block, op_index, depth, stage)
            return
        sub = op.attr("sub_block")
        if sub is not None and t in ("while", "scan_block", "bounded_while"):
            self.assumptions.append(
                f"loop body of {t!r} (block {sub}) walked once — one "
                "iteration's live set (double buffering not modeled)"
            )
            self.walk_block(self.program.blocks[sub], depth + 1, stage)
            return
        self._emit(block, t, op.inputs, op.outputs, block.idx, op_index,
                   loc, stage)

    def _visit_vjp(self, op, block, op_index, stage, loc):
        self.saw_backward = True
        extra = 0.0
        if op.attr("fwd_type") == "recompute_segment":
            # the backward re-runs the segment: its interiors
            # re-materialize as this op's working set
            fwd_attrs = op.attr("fwd_attrs") or {}
            extra = self._segment_interior_bytes(
                block, fwd_attrs.get("sub_ops", ()),
                fwd_attrs.get("out_names", ()),
            )[0]
        self._emit(block, "__vjp__", op.inputs, op.outputs, block.idx,
                   op_index, loc, stage, extra_bytes=extra,
                   fwd_type=op.attr("fwd_type"))

    def _segment_interior_bytes(self, block, sub_ops, out_names):
        outs = set(out_names or ())
        interior, seen = 0.0, set()
        for _ot, _oins, oouts, _oattrs in sub_ops or ():
            for names in (oouts or {}).values():
                for n in names:
                    if n and n not in outs and n not in seen:
                        seen.add(n)
                        interior += self._bytes(block, n)
        return interior, len(seen)

    def _visit_recompute(self, op, block, op_index, depth, stage, loc):
        sub_ops = op.attr("sub_ops", ())
        out_names = op.attr("out_names", ())
        for ot, oins, oouts, oattrs in sub_ops:
            self._emit(block, ot, oins, oouts, block.idx, op_index, loc,
                       stage)
        # interiors die here — only segment outputs (and persistables)
        # survive the boundary; the backward re-makes the rest. A later
        # read of an interior would make it a segment output by
        # construction (_segment_io), so intervals need no cap, but
        # record the segment so the savings check can run post-walk.
        interior, n_interior = self._segment_interior_bytes(
            block, sub_ops, out_names
        )
        self.segments.append((op, block.idx, op_index, interior, n_interior,
                              len(tuple(sub_ops)), loc))

    def _visit_pipeline(self, op, block, depth):
        if op.type == "pipeline_uniform":
            body = op.attr("stage_block")
            if body is not None:
                self.walk_block(self.program.blocks[body], depth + 1,
                                stage=0)
            return
        for si, bi in enumerate(op.attr("stage_blocks") or ()):
            self.walk_block(self.program.blocks[bi], depth + 1, stage=si)

    def _visit_branch(self, op, block, op_index, depth, stage):
        # both branches are traced but one executes: charge the one with
        # the larger transient footprint
        best, best_events = -1.0, None
        for attr in ("true_block", "false_block", "sub_block"):
            bi = op.attr(attr)
            if bi is None:
                continue
            saved, self.events = self.events, []
            self.walk_block(self.program.blocks[bi], depth + 1, stage)
            captured, self.events = self.events, saved
            peak = _simulate(captured, self, base=0.0)[0]
            if peak > best:
                best, best_events = peak, captured
        if best_events:
            self.events.extend(best_events)
            self.assumptions.append(
                f"cond at block {block.idx} op #{op_index}: charged the "
                "branch with the larger transient peak"
            )

    # -- verification passes ----------------------------------------------
    def _verify_donations(self):
        donated = {}  # name -> (event idx, donor event)
        for i, ev in enumerate(self.events):
            for r in ev.reads:
                hit = donated.get(r)
                if hit is not None and hit[0] < i:
                    donor = hit[1]
                    self.findings.append(Finding(
                        severity=Severity.ERROR,
                        category=USE_AFTER_DONATE,
                        message=(
                            f"'{r}' is read after op "
                            f"#{donor.op_index} {donor.op_type!r} donated "
                            "its buffer (the output aliases it in-place); "
                            "the read observes a dead buffer under the "
                            "executor's donation contract"
                        ),
                        block_idx=ev.block_idx,
                        op_index=ev.op_index,
                        op_type=ev.op_type,
                        names=(r,),
                        loc=ev.loc or None,
                    ))
            for w in ev.writes:
                donated.pop(w, None)  # redefined: a fresh buffer
            for iname, _oname in ev.donations:
                donated[iname] = (i, ev)

    def _verify_missed_donations(self, last_read):
        from ..framework.registry import _REGISTRY

        for i, ev in enumerate(self.events):
            if ev.donations or ev.op_type == "__vjp__":
                continue
            op_def = _REGISTRY.get(ev.op_type)
            if op_def is None or op_def.mutates:
                continue
            for r in ev.reads:
                info = self.vars.get(r)
                if (info is None or not info.persistable
                        or info.nbytes < _MISSED_DONATION_MIN_BYTES
                        or r in self.feed_names or last_read.get(r) != i
                        # a same-name write IS the in-place update — the
                        # executor's write-back donation already aliases it
                        or r in ev.writes):
                    continue
                for w in ev.writes:
                    if w == r:
                        continue
                    winfo = self.vars.get(w)
                    if (winfo is not None and winfo.shape == info.shape
                            and winfo.dtype == info.dtype):
                        self.findings.append(Finding(
                            severity=Severity.INFO,
                            category=MISSED_DONATION,
                            message=(
                                f"last read of persistable '{r}' feeds a "
                                f"same-shape/dtype write '{w}' — the "
                                "buffer could alias (register the op "
                                "with mutates=(), or reuse the name) to "
                                f"save {_fmt_bytes(info.nbytes)}"
                            ),
                            block_idx=ev.block_idx,
                            op_index=ev.op_index,
                            op_type=ev.op_type,
                            names=(r, w),
                            loc=ev.loc or None,
                        ))
                        break

    def _verify_recompute(self):
        for op, block_idx, op_index, interior, n_interior, n_sub, loc in (
                self.segments):
            if interior > 0 and self.saw_backward:
                continue
            if not self.saw_backward:
                why = (
                    "no backward consumes it — checkpointing only adds "
                    "recompute cost in a forward-only program"
                )
            else:
                why = (
                    f"every one of its {n_sub} folded op(s)' outputs is a "
                    "segment output, so nothing is freed at the boundary"
                )
            self.findings.append(Finding(
                severity=Severity.INFO,
                category=RECOMPUTE_NO_SAVINGS,
                message=f"recompute segment saves no liveness: {why}",
                block_idx=block_idx,
                op_index=op_index,
                op_type="recompute_segment",
                loc=loc or None,
            ))


def _simulate(events, planner, base=0.0, fetch_names=(), track=False):
    """Live-interval simulation over flattened events. Returns
    ``(transient_peak, watermark, timeline, stage_peaks)`` — watermark /
    timeline / stage_peaks only populated when ``track``."""
    vars_ = planner.vars
    feed_set = set(planner.feed_names)

    def transient(name):
        info = vars_.get(name)
        if info is None:
            return None
        if info.persistable or info.is_data or name in feed_set:
            return None
        return info.nbytes

    last_use = {}
    for i, ev in enumerate(events):
        for n in ev.reads:
            last_use[n] = i
        for n in ev.writes:
            last_use.setdefault(n, i)
    end = len(events) - 1
    for n in fetch_names:
        if n in last_use:
            last_use[n] = end

    alive = {}
    cur_sum = 0.0
    peak, watermark = 0.0, None
    timeline = [] if track else None
    stage_peaks = {}
    for i, ev in enumerate(events):
        newly = 0.0
        for n in ev.writes + ev.reads:
            if n not in alive:
                b = transient(n)
                if b:
                    alive[n] = b
                    cur_sum += b
                    if n in ev.writes:
                        newly += b
        cur = base + cur_sum + ev.extra_bytes
        if ev.reuse and newly:
            dying = sum(
                alive[n] for n in set(ev.reads)
                if n in alive and n not in ev.writes
                and last_use.get(n) == i
            )
            cur -= min(dying, newly)
        if cur > peak:
            peak = cur
            if track:
                top = sorted(alive.items(), key=lambda kv: -kv[1])[:8]
                watermark = {
                    "block_idx": ev.block_idx,
                    "op_index": ev.op_index,
                    "op_type": ev.op_type,
                    "loc": ev.loc or None,
                    "live_bytes": cur,
                    "top_live": [(n, float(b)) for n, b in top],
                }
        if track:
            timeline.append({
                "block_idx": ev.block_idx,
                "op_index": ev.op_index,
                "op_type": ev.op_type,
                "live_bytes": cur,
                "n_live": len(alive),
            })
            if ev.stage is not None:
                prev = stage_peaks.get(ev.stage, 0.0)
                stage_peaks[ev.stage] = max(prev, cur_sum + ev.extra_bytes)
        for n in ev.reads + ev.writes:
            if last_use.get(n) == i and n in alive:
                cur_sum -= alive.pop(n)
    return peak, watermark, timeline, stage_peaks


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

_UNSET = object()


def plan_memory(program, feed_names=None, fetch_names=(), feed_shapes=None,
                budget=_UNSET) -> MemoryTable:
    """Static peak-HBM plan for ONE step of `program`.

    feed_shapes pins -1 (batch) dims exactly like ``Program.estimate``;
    feed_names defaults to the program's declared data vars. budget
    defaults to :func:`hbm_budget` (``PADDLE_TPU_HBM_BYTES``); pass
    ``None`` to skip the oom-risk check."""
    if budget is _UNSET:
        budget = hbm_budget()
    planner = _MemoryPlanner(program, feed_names, fetch_names, feed_shapes)
    planner.walk_block(program.global_block)

    # resident: referenced persistables, once each; feeds live throughout
    resident = 0.0
    residents = []
    for name, info in planner.vars.items():
        if info.persistable and name not in planner.feed_names:
            resident += info.nbytes
            residents.append((name, info.nbytes))
    residents.sort(key=lambda kv: -kv[1])
    feed_bytes = 0.0
    for name in planner.feed_names:
        info = planner.vars.get(name)
        if info is None:
            info = planner._info(program.global_block, name)
        if info is not None:
            feed_bytes += info.nbytes

    base = resident + feed_bytes
    peak, watermark, timeline, stage_peaks = _simulate(
        planner.events, planner, base=base,
        fetch_names=planner.fetch_names, track=True,
    )
    peak = max(peak, base)  # an op-free program still holds its state

    planner._verify_donations()
    last_read = {}
    for i, ev in enumerate(planner.events):
        for n in ev.reads:
            last_read[n] = i
    planner._verify_missed_donations(last_read)
    planner._verify_recompute()

    table = MemoryTable(
        resident_bytes=resident,
        feed_bytes=feed_bytes,
        transient_peak_bytes=max(peak - base, 0.0),
        peak_bytes=peak,
        budget_bytes=budget,
        watermark=watermark,
        timeline=timeline or [],
        stage_peaks=stage_peaks,
        residents=residents,
        assumptions=list(planner.assumptions),
        findings=list(planner.findings),
    )
    if planner.pinned:
        table.assumptions.append(
            f"pinned {len(planner.pinned)} unknown (-1) dims to batch "
            f"hint {planner.batch_hint}"
        )
    if budget is not None and peak > budget:
        wm = watermark or {}
        table.findings.append(Finding(
            severity=Severity.WARNING,
            category=OOM_RISK,
            message=(
                f"estimated peak HBM {_fmt_bytes(peak)} exceeds the "
                f"{_fmt_bytes(budget)} budget (PADDLE_TPU_HBM_BYTES); "
                f"resident {_fmt_bytes(resident)} + feeds "
                f"{_fmt_bytes(feed_bytes)} + transients peak at op "
                f"#{wm.get('op_index')} {wm.get('op_type')!r}"
            ),
            block_idx=wm.get("block_idx", 0) or 0,
            op_index=wm.get("op_index"),
            op_type=wm.get("op_type"),
            names=tuple(n for n, _ in (wm.get("top_live") or [])[:3]),
            loc=wm.get("loc"),
        ))
    return table


def analyze_memory(program, feed_names=(), fetch_names=()):
    """The verify-family entry: memory findings only (use-after-donate,
    missed-donation, recompute-no-savings, oom-risk against the
    ``PADDLE_TPU_HBM_BYTES`` budget when set)."""
    return plan_memory(
        program, feed_names or None, fetch_names
    ).findings
