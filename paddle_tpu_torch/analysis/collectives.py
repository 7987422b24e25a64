"""Cross-rank collective-schedule lint: the build-time deadlock detector
(counterpart of paddle_tpu/analysis/collectives.py), over the port's mesh
(parallel/mesh.py: ``axis_names``, ``shape``) and the collective ops of
ops/collective.py and the op types the JAX package registers.

Under shard_map SPMD every rank runs ONE program, so collective sites are
normally rank-uniform by construction — except where the program encodes
*per-rank divergence*: ``pipeline_block`` runs a different stage
sub-block per rank (ROADMAP item 7 in the port), and ``cond`` branches
may hide collectives behind a predicate that is not guaranteed
replicated. A collective present on one rank's path but not another's is
the classic mismatched-collective deadlock: every rank blocks on an
exchange its peers never enter. This pass simulates the per-rank op
streams and rejects the mismatch at build time.

Simulation model:
* every collective-bearing op contributes one `Site` (kind, axis) to the
  stream — inner repetition counts (ring steps, microbatch ticks, scan
  trips) are rank-uniform, so one site per op suffices for comparison;
* ``pipeline_block``: per-rank stage sub-block (the ONLY rank-divergent
  construct in the IR), bracketed by the schedule's ppermute/psum;
  unbound axis = the sequential degrade, which runs every stage;
* ``pipeline_uniform``: one shared stage body — rank-uniform, still
  recursed for the axis checks;
* ``cond``/``conditional_block``: both branches are traced on every rank;
  branches whose collective streams disagree are flagged (the predicate
  cannot be proven replicated at build time);
* ``while``/``scan_block``/sub-blocks: body recursed once.

Axis checks ride the same walk: a collective whose axis the attached Mesh
does not name (or that hybrid mode leaves unbound) silently degrades to
identity — almost always a typo'd ``axis_name`` — and is flagged.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

from .findings import (
    COLLECTIVE_BRANCH_DIVERGENCE,
    COLLECTIVE_DIVERGENCE,
    UNKNOWN_MESH_AXIS,
    Severity,
    finding_for_op,
)

# op type -> default axis_name (matching each emitter's op.attr default)
ATTR_AXIS_OPS = {
    "c_allreduce_sum": "dp",
    "c_allreduce_max": "dp",
    "c_allreduce_min": "dp",
    "c_allreduce_prod": "dp",
    "allreduce": "dp",
    "mp_allreduce_sum": "dp",
    "c_broadcast": "dp",
    "c_allgather": "dp",
    "c_reducescatter": "dp",
    "alltoall": "dp",
    "collective_permute": "dp",
    "barrier": "dp",
    "c_allreduce_any": "dp",
    "zero_reduce_scatter": "dp",
    "zero_bucket_reduce_scatter": "dp",
    "c_bucket_allreduce_sum": "dp",
    "zero_all_gather": "dp",
    "dgc_momentum_step": "dp",
    "distributed_lookup_table": "ps",
    "fused_lookup_table": "ps",
    "moe_ffn": "ep",
    "ring_attention": "sp",
    "ulysses_attention": "sp",
    "pipeline_gate_loss": "pp",
}

# ops whose emitter reduces over a FIXED axis when it is bound
FIXED_AXIS_OPS = {"sync_batch_norm": "dp"}

_PIPELINE_OPS = ("pipeline_block", "pipeline_uniform")
_BRANCH_OPS = ("cond", "conditional_block", "conditional_block_infer")
_BODY_ATTRS = ("sub_block",)  # while / scan_block / bounded_while

# bound on enumerated rank combinations (product of pipeline-axis sizes);
# beyond it the tail is skipped — a 128-stage pipeline is not a test mesh
MAX_RANK_COMBOS = 128


# collectives whose WIRE FORMAT is part of the site kind: an int8-quantized
# exchange on one rank paired with a full-precision one on another is a
# payload-size mismatch — the exchange deadlocks (or corrupts) exactly like
# a kind mismatch, so the lint must distinguish the quantized variants.
# The embedding lookups are such ops too: their backward row-gradient
# exchange (all_to_all + all_gather when quantized, psum otherwise) runs a
# different collective SEQUENCE per wire format, and the column partition
# runs an all-gather instead of a psum — both are part of the site kind.
_QUANT_KIND_OPS = frozenset({
    "zero_reduce_scatter", "zero_all_gather", "zero_bucket_reduce_scatter",
    "distributed_lookup_table", "fused_lookup_table",
})
_LOOKUP_KIND_OPS = frozenset({
    "distributed_lookup_table", "fused_lookup_table",
})
# bucketed collectives: MEMBERSHIP AND ORDER are part of the cross-rank
# wire contract — two ranks disagreeing on which grads share a bucket (or
# on their order inside it) exchange different payload layouts on the same
# collective slot, which deadlocks or silently corrupts exactly like a
# kind mismatch. The per-member size list therefore joins the site kind,
# so a rank-divergent bucketing is a build-time COLLECTIVE_DIVERGENCE
# ERROR, not a hang. op type -> attr carrying the member sizes.
_BUCKET_KIND_OPS = {
    "zero_bucket_reduce_scatter": "pad_lens",
    "c_bucket_allreduce_sum": "bucket_numels",
}


def _site_kind(op, t):
    kind = t
    if t in _LOOKUP_KIND_OPS and op.attr("partition", "row") == "col":
        kind = f"{t}:col"
    if t in _BUCKET_KIND_OPS:
        sizes = op.attr(_BUCKET_KIND_OPS[t]) or ()
        kind = f"{kind}[{','.join(str(int(s)) for s in sizes)}]"
    if t in _QUANT_KIND_OPS:
        quant = op.attr("quant", "none")
        if quant and quant != "none":
            return f"{kind}:{quant}"
    return kind


def collective_axis(op):
    """(axis_name, kind) if `op` is collective-bearing, else (None, None).
    For quantized sharded-update collectives the kind carries the wire
    format (e.g. ``zero_reduce_scatter:int8``)."""
    t = op.type
    if t in ATTR_AXIS_OPS:
        return op.attr("axis_name", ATTR_AXIS_OPS[t]), _site_kind(op, t)
    if t in FIXED_AXIS_OPS:
        return FIXED_AXIS_OPS[t], t
    if t in _PIPELINE_OPS:
        return op.attr("axis_name", "pp"), t
    return None, None


@dataclass(frozen=True)
class Site:
    kind: str
    axis: str

    def __str__(self):
        return f"{self.kind}@{self.axis}"


class _Walker:
    def __init__(self, program, bound_axes, findings):
        self.program = program
        self.bound = frozenset(bound_axes)
        self.findings = findings
        self.first_rank = True  # branch findings reported once, not per rank

    def stream(self, coords):
        out = []
        self._walk(self.program.global_block.ops, coords, out, 0)
        self.first_rank = False
        return out

    def _walk(self, ops, coords, out, block_idx, depth=0):
        if depth > 16:  # cyclic sub-block refs cannot hang the verifier
            return
        for i, op in enumerate(ops):
            t = op.type
            if t in _PIPELINE_OPS:
                self._walk_pipeline(op, i, coords, out, block_idx, depth)
                continue
            if t in _BRANCH_OPS:
                self._walk_branch(op, i, coords, out, block_idx, depth)
                continue
            if t == "recompute_segment":
                # embedded ops live in the `sub_ops` attr, not a sub-block;
                # a collective folded into a rematerialized span still
                # executes (twice, but uniformly) on every rank
                from ..framework.registry import OpView

                views = [
                    OpView(ot, oattrs, outputs=oouts, inputs=oins)
                    for ot, oins, oouts, oattrs in op.attr("sub_ops", ())
                ]
                self._walk(views, coords, out, block_idx, depth + 1)
                continue
            body = None
            for a in _BODY_ATTRS:
                if op.attr(a) is not None:
                    body = self.program.blocks[op.attr(a)]
                    break
            if body is not None:
                self._walk(body.ops, coords, out, body.idx, depth + 1)
                continue
            ax, kind = collective_axis(op)
            if ax is not None and ax in self.bound:
                out.append((Site(kind, ax), op, i, block_idx))

    def _walk_pipeline(self, op, i, coords, out, block_idx, depth):
        ax = op.attr("axis_name", "pp")
        if op.type == "pipeline_uniform":
            body = self.program.blocks[op.attr("stage_block")]
            if ax in self.bound:
                out.append((Site("pipeline_uniform.ppermute", ax), op, i,
                            block_idx))
            self._walk(body.ops, coords, out, body.idx, depth + 1)
            if ax in self.bound:
                out.append((Site("pipeline_uniform.psum", ax), op, i,
                            block_idx))
            return
        stage_blocks = list(op.attr("stage_blocks") or ())
        if ax not in self.bound:
            # sequential degrade runs every stage on every rank, in order
            for bi in stage_blocks:
                blk = self.program.blocks[bi]
                self._walk(blk.ops, coords, out, blk.idx, depth + 1)
            return
        out.append((Site("pipeline_block.ppermute", ax), op, i, block_idx))
        stage = min(coords.get(ax, 0), len(stage_blocks) - 1)
        blk = self.program.blocks[stage_blocks[stage]]
        self._walk(blk.ops, coords, out, blk.idx, depth + 1)
        out.append((Site("pipeline_block.psum", ax), op, i, block_idx))

    def _walk_branch(self, op, i, coords, out, block_idx, depth):
        branches = []
        for attr in ("true_block", "false_block", "sub_block"):
            bi = op.attr(attr)
            if bi is not None:
                branches.append(self.program.blocks[bi])
        streams = []
        for blk in branches:
            s = []
            self._walk(blk.ops, coords, s, blk.idx, depth + 1)
            streams.append(s)
        if len(streams) > 1 and self.first_rank:
            a = [site for site, *_ in streams[0]]
            b = [site for site, *_ in streams[1]]
            if a != b:
                self.findings.append(finding_for_op(
                    Severity.WARNING, COLLECTIVE_BRANCH_DIVERGENCE,
                    f"branches of {op.type!r} emit different collective "
                    f"streams ({[str(s) for s in a]} vs "
                    f"{[str(s) for s in b]}); if the predicate is not "
                    "replicated across ranks this deadlocks",
                    op=op, op_index=i, block_idx=block_idx,
                ))
        if streams:
            out.extend(streams[0])


def analyze_collectives(program):
    findings = []
    mesh = getattr(program, "_mesh", None)
    mode = getattr(program, "_spmd_mode", "shard_map")
    if mesh is None or mode not in ("shard_map", "hybrid"):
        # no mesh: collectives degrade to identity by design (nranks==1);
        # gspmd: axes are never bound, the compiler derives comms from
        # shardings
        return findings
    mesh_axes = tuple(mesh.axis_names)
    bound = (
        mesh_axes if mode == "shard_map"
        else tuple(getattr(program, "_manual_axes", ()))
    )
    axis_sizes = dict(mesh.shape)

    # --- axis existence / binding, every block ----------------------------
    for blk in program.blocks:
        for i, op in enumerate(blk.ops):
            ax, kind = collective_axis(op)
            if ax is None or op.type in FIXED_AXIS_OPS:
                continue  # fixed-axis emitters guard themselves
            if ax not in mesh_axes:
                findings.append(finding_for_op(
                    Severity.WARNING, UNKNOWN_MESH_AXIS,
                    f"collective {kind!r} names mesh axis {ax!r} but the "
                    f"program's mesh only binds {list(mesh_axes)}; the op "
                    "degrades to identity (likely a typo'd axis_name)",
                    op=op, op_index=i, block_idx=blk.idx, names=(ax,),
                ))
            elif ax not in bound:
                findings.append(finding_for_op(
                    Severity.WARNING, UNKNOWN_MESH_AXIS,
                    f"collective {kind!r} names axis {ax!r} which hybrid "
                    f"mode leaves non-manual (manual axes: {list(bound)}); "
                    "explicit collectives over auto axes degrade to "
                    "identity",
                    op=op, op_index=i, block_idx=blk.idx, names=(ax,),
                ))

    # --- per-rank stream simulation ---------------------------------------
    walker = _Walker(program, bound, findings)
    affecting = sorted({
        op.attr("axis_name", "pp")
        for blk in program.blocks
        for op in blk.ops
        if op.type == "pipeline_block"
        and op.attr("axis_name", "pp") in bound
    })
    combos = itertools.product(
        *(range(int(axis_sizes.get(a, 1))) for a in affecting)
    )
    streams = []
    for combo in itertools.islice(combos, MAX_RANK_COMBOS):
        coords = dict(zip(affecting, combo))
        streams.append((coords, walker.stream(coords)))
    if len(streams) < 2:
        return findings
    base_coords, base = streams[0]
    for coords, cur in streams[1:]:
        for k, (a, b) in enumerate(itertools.zip_longest(base, cur)):
            if a is not None and b is not None and a[0] == b[0]:
                continue
            # anchor the finding on the concrete divergent collective —
            # prefer a real collective op over a pipeline schedule bracket
            if a is not None and b is not None:
                pick, pick_coords = (
                    (a, base_coords)
                    if not a[0].kind.startswith("pipeline_") else (b, coords)
                )
                detail = (
                    f"rank {base_coords} issues {a[0]} while rank "
                    f"{coords} issues {b[0]}"
                )
            else:
                pick, pick_coords = (a, base_coords) if a else (b, coords)
                longer, shorter = (
                    (base_coords, coords) if a else (coords, base_coords)
                )
                detail = (
                    f"rank {longer} issues {pick[0]} but rank {shorter}'s "
                    "stream has already ended"
                )
            site, op, op_idx, blk_idx = pick
            findings.append(finding_for_op(
                Severity.ERROR, COLLECTIVE_DIVERGENCE,
                f"rank-divergent collective order at schedule position "
                f"{k}: {detail} — every rank must issue the same "
                f"collectives in the same order over axis {site.axis!r} "
                "or the exchange deadlocks",
                op=op, op_index=op_idx, block_idx=blk_idx,
                names=(site.axis,),
            ))
            break
    return findings
