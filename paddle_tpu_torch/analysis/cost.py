"""Per-op cost attribution: analytic FLOPs / bytes-moved / roofline latency
over the Program IR (counterpart of paddle_tpu/analysis/cost.py).

The model is analytic (closed forms per op family), and its rules are the
JAX package's, so one program gives one count in both packages: the step
FLOPs that ``bench.py`` and ``chip_smoke.py`` divide by a step's time,
and the numerator of the executor's live ``perf.mfu`` gauge. The count is
a property of the program, not of what runs it: the port's eager replay
of a ``__vjp__`` op runs its forward op again (backward.py), which the
JAX package's XLA merges away, and the model counts neither.

Walk model (mirrors the collective-schedule walker, collectives.py):

* every op contributes one :class:`OpCost` (flops, bytes, roofline
  latency) computed from *declared* Variable shapes — no emitter runs,
  so estimating a BERT-base training program takes milliseconds;
* ``__vjp__`` grad ops are attributed to their forward op's family at
  2x the forward cost (dx and dW are each a forward-sized contraction;
  the replayed forward is not counted) — 3x when the forward is a
  ``recompute_segment``, whose backward re-runs the segment before the
  vjp;
* ``pipeline_block`` stage sub-blocks are walked once at graph-build
  shapes: M microbatches at B/M each sum to the declared-[B] cost;
* ``recompute_segment`` forward walks its folded ``sub_ops``;
* ``cond`` branches contribute the costlier branch; loop bodies
  (``while``/``scan_block``) are counted once per trip when the op
  carries a static trip count, else once (recorded in ``assumptions``);
* -1 (batch) dims are pinned by ``feed_shapes`` when given, else by the
  leading dim of any feed, else 1 — every such pin is recorded.

Roofline: ``latency = max(flops/peak_flops, bytes/peak_bandwidth)`` with
peaks from ``PADDLE_TPU_PEAK_TFLOPS`` / ``PADDLE_TPU_PEAK_GBPS``
(defaults: the NVIDIA H100 SXM5 80GB at its 700 W limit, 989.4 TFLOP/s
dense bf16 on the tensor cores and 3.35 TB/s of HBM3, the data sheet's
figures). The same peak feeds the executor's live ``perf.mfu`` gauge, so
offline and live MFU agree by construction.

Bytes of a declared dtype are torch's element size (``itemsize``): a
bfloat16 variable moves 2 bytes an element, as in the JAX package.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

from ..core.dtypes import to_torch_dtype

# NVIDIA H100 SXM5 80GB (700 W) data sheet: dense bf16 on the tensor
# cores, and HBM3 bandwidth
DEFAULT_PEAK_TFLOPS = 989.4
DEFAULT_PEAK_GBPS = 3350.0


def peak_flops() -> float:
    """Peak FLOP/s the MFU gauge and rooflines are measured against
    (``PADDLE_TPU_PEAK_TFLOPS``, default the H100's dense bf16)."""
    try:
        return float(
            os.environ.get("PADDLE_TPU_PEAK_TFLOPS", DEFAULT_PEAK_TFLOPS)
        ) * 1e12
    except ValueError:
        return DEFAULT_PEAK_TFLOPS * 1e12


def peak_bandwidth() -> float:
    """Peak bytes/s for the roofline's memory leg
    (``PADDLE_TPU_PEAK_GBPS``, default the H100's HBM3)."""
    try:
        return float(
            os.environ.get("PADDLE_TPU_PEAK_GBPS", DEFAULT_PEAK_GBPS)
        ) * 1e9
    except ValueError:
        return DEFAULT_PEAK_GBPS * 1e9


def itemsize(dtype) -> int:
    """Bytes of one element of a declared dtype name (4 where the name is
    no dtype of the port's)."""
    try:
        return to_torch_dtype(dtype or "float32").itemsize
    except (KeyError, ValueError):
        return 4


# ---------------------------------------------------------------------------
# op families
# ---------------------------------------------------------------------------

MATMUL_OPS = frozenset({
    "mul", "matmul", "bmm", "dot", "addmm", "batch_fc",
    "bilinear_tensor_product", "match_matrix_tensor",
})
CONV_OPS = frozenset({
    "conv2d", "conv3d", "depthwise_conv2d", "conv2d_transpose",
    "conv3d_transpose", "depthwise_conv2d_transpose", "deformable_conv",
    "deformable_conv_v1", "var_conv_2d", "row_conv", "conv_shift",
})
ATTENTION_OPS = frozenset({
    "fused_qkv_attention", "fused_qkv_attention_grad",
    "fused_multihead_attention", "fused_multihead_attention_grad",
    "ring_attention", "ulysses_attention",
})
NORM_OPS = frozenset({
    "batch_norm", "sync_batch_norm", "layer_norm", "layer_norm_grad",
    "group_norm", "instance_norm", "data_norm", "inplace_abn",
    "fused_dropout_add_ln", "fused_dropout_add_ln_grad", "lrn",
    "spectral_norm",
})
EMBED_OPS = frozenset({
    "lookup_table", "lookup_table_v2", "lookup_table_dequant",
    "lookup_sparse_table", "distributed_lookup_table",
    "fused_lookup_table", "gather",
    "gather_nd", "index_select", "index_sample", "take_along_axis",
    "scatter", "scatter_nd_add", "shuffle_batch", "pyramid_hash",
})
# the engine's lookup ops get dedicated closed forms (unique-row gather
# bytes forward, segment-sum scatter backward, quantized exchange wire)
SPARSE_LOOKUP_OPS = frozenset({
    "distributed_lookup_table", "fused_lookup_table",
})
OPTIMIZER_OPS = {
    # op type -> flops per Param element (rough update-rule arithmetic)
    "sgd": 2.0, "momentum": 4.0, "lars_momentum": 8.0, "adam": 12.0,
    "adamw": 14.0, "lamb": 16.0, "adagrad": 6.0, "decayed_adagrad": 7.0,
    "adadelta": 8.0, "rmsprop": 8.0, "ftrl": 8.0, "adamax": 10.0,
    "dpsgd": 4.0, "proximal_gd": 3.0, "proximal_adagrad": 6.0,
    "dgc_momentum_step": 6.0,
}
# zero-FLOP data movement: layout/shape/copy ops (bytes still counted)
DATA_OPS = frozenset({
    "reshape", "reshape2", "transpose", "transpose2", "squeeze",
    "squeeze2", "unsqueeze", "unsqueeze2", "flatten", "flatten2",
    "concat", "split", "stack", "unstack", "unbind", "slice",
    "strided_slice", "assign", "cast", "expand", "expand_as", "tile",
    "pad", "pad2d", "pad_constant_like", "reverse", "flip", "roll",
    "fill_constant", "fill_any_like", "fill_zeros_like",
    "fill_zeros_like2", "fill", "fill_constant_batch_size_like",
    "gaussian_random", "uniform_random", "truncated_gaussian_random",
    "gaussian_random_batch_size_like", "uniform_random_batch_size_like",
    "randint", "randperm", "range", "linspace", "eye", "one_hot",
    "one_hot_v2", "shape", "size", "shard_index", "sampling_id", "seed",
    "c_identity", "c_sync_calc_stream", "c_sync_comm_stream",
    "share_data", "space_to_depth", "pixel_shuffle", "shuffle_channel",
    "write_to_array", "read_from_array", "tensor_array_to_tensor",
    "select_input", "select_output", "assign_value",
})
# per-element flop weights for compute ops that are not matrix contractions
ELEMENTWISE_WEIGHTS = {
    "softmax": 4.0, "log_softmax": 4.0,
    "softmax_with_cross_entropy": 5.0,
    "cross_entropy": 3.0, "cross_entropy2": 3.0, "nll_loss": 2.0,
    "sigmoid_cross_entropy_with_logits": 4.0, "bce_loss": 4.0,
    "dropout": 2.0, "gelu": 8.0, "tanh": 1.0, "sigmoid": 2.0,
    "silu": 3.0, "swish": 3.0, "mish": 6.0, "erf": 1.0, "exp": 1.0,
    "square_error_cost": 3.0, "smooth_l1_loss": 4.0, "huber_loss": 4.0,
    "isfinite": 1.0, "check_finite_and_unscale": 2.0,
    "amp_check_finite_and_scale": 2.0, "update_loss_scaling": 2.0,
    "clip_by_norm": 3.0, "squared_l2_norm": 2.0, "l1_norm": 2.0,
    "frobenius_norm": 2.0, "p_norm": 3.0, "norm": 3.0,
}
# gather-like EMBED_OPS: the named slot is a table read SPARSELY — only
# the gathered rows (~output-sized) actually move, not the whole table
# (a criteo-sized vocab would otherwise dominate every byte rollup)
_GATHER_TABLE_SLOTS = {
    "lookup_table": "W", "lookup_table_v2": "W",
    "lookup_table_dequant": "W", "lookup_sparse_table": "W",
    "distributed_lookup_table": "W",
    "gather": "X", "gather_nd": "X", "index_select": "X",
    "index_sample": "X", "take_along_axis": "Input",
}
# ops whose cost is ~1 pass over the INPUT (output is reduced/small)
REDUCE_OPS = frozenset({
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "reduce_all", "reduce_any", "mean", "arg_max",
    "arg_min", "argsort", "top_k", "cumsum", "trace", "unique",
    "unique_with_counts", "accuracy", "auc",
})

# interconnect payload factor per collective kind: ring-algorithm wire
# bytes as a multiple of the payload (n = axis size)
_COLLECTIVE_FACTORS = {
    "c_allreduce_sum": lambda n: 2.0 * (n - 1) / n,
    "c_allreduce_max": lambda n: 2.0 * (n - 1) / n,
    "c_allreduce_min": lambda n: 2.0 * (n - 1) / n,
    "c_allreduce_prod": lambda n: 2.0 * (n - 1) / n,
    "allreduce": lambda n: 2.0 * (n - 1) / n,
    "mp_allreduce_sum": lambda n: 2.0 * (n - 1) / n,
    "c_allgather": lambda n: float(n - 1) / n,
    "c_reducescatter": lambda n: float(n - 1) / n,
    "alltoall": lambda n: float(n - 1) / n,
    "c_broadcast": lambda n: 1.0,
    "collective_permute": lambda n: 1.0,
    "barrier": lambda n: 0.0,
    # sharded weight update (ZeRO): reduce-scatter and all-gather each move
    # (n-1)/n of the payload; found-inf any-reduce is a [1]-element
    # allreduce
    "zero_reduce_scatter": lambda n: float(n - 1) / n,
    "zero_all_gather": lambda n: float(n - 1) / n,
    "c_allreduce_any": lambda n: 2.0 * (n - 1) / n,
    # bucketed overlap schedule: a bucket moves the same ring bytes as
    # its members' individual collectives would — the win is dispatch
    # count and firing position, not payload
    "c_bucket_allreduce_sum": lambda n: 2.0 * (n - 1) / n,
    "zero_bucket_reduce_scatter": lambda n: float(n - 1) / n,
}

#: int8 block quantization (ops/collective.py): effective bytes per
#: payload element = 1 int8 + one fp32 scale per `quant_block` elements.
def _quant_elem_bytes(quant, block, fp_itemsize):
    if quant and quant != "none":
        return 1.0 + 4.0 / max(int(block or 256), 1)
    return float(fp_itemsize)


def family_of(op_type: str) -> str:
    """Coarse op family used for attribution gauges and by-family rollups."""
    if op_type in MATMUL_OPS:
        return "matmul"
    if op_type in CONV_OPS:
        return "conv"
    if op_type in ATTENTION_OPS:
        return "attention"
    if op_type in NORM_OPS:
        return "normalization"
    if op_type in EMBED_OPS:
        return "embedding"
    if op_type in OPTIMIZER_OPS:
        return "optimizer"
    if op_type in _COLLECTIVE_FACTORS:
        return "collective"
    if op_type in DATA_OPS:
        return "data_movement"
    return "elementwise"


# ---------------------------------------------------------------------------
# cost table
# ---------------------------------------------------------------------------


@dataclass
class OpCost:
    """Total cost of one IR op site (already scaled by execution count)."""

    op_type: str
    family: str
    flops: float
    bytes: float
    latency: float
    count: int = 1
    block_idx: int = 0
    op_index: int = 0
    loc: str = ""

    def to_dict(self):
        return {
            "op_type": self.op_type, "family": self.family,
            "flops": self.flops, "bytes": self.bytes,
            "latency": self.latency, "count": self.count,
            "block_idx": self.block_idx, "op_index": self.op_index,
            "loc": self.loc,
        }


@dataclass
class CostTable:
    """Per-op cost attribution for one Program at concrete shapes."""

    ops: list = field(default_factory=list)
    assumptions: list = field(default_factory=list)
    peak_flops: float = 0.0
    peak_bandwidth: float = 0.0
    #: overlap-aware step-time estimate (seconds), set by
    #: :func:`estimate_program` ONLY for programs whose collective
    #: schedule was restructured for overlap (``program._overlap_schedule``
    #: — bucketed grad collectives / prefetched all-gathers): a
    #: two-resource simulation where collectives run on the wire channel
    #: concurrently with compute, and compute blocks only when it consumes
    #: a collective's output — max(compute, wire) per overlap segment
    #: instead of a global sum. None = serialized schedule: the step
    #: estimate is ``total_latency``.
    scheduled_latency: float = None
    #: static HBM plan from the memory analysis family (set by
    #: :func:`estimate_program`): peak live bytes (resident persistables
    #: + feeds + transient live-set max), the resident portion alone, and
    #: the full :class:`~paddle_tpu_torch.analysis.memory.MemoryTable`
    #: (the watermark op, timeline, per-stage peaks). Set beside the
    #: card's ``torch.cuda.max_memory_allocated`` over one step by
    #: ``Executor.memory_analysis``.
    peak_bytes: float = None
    resident_bytes: float = None
    memory: object = field(default=None, repr=False)

    @property
    def total_flops(self):
        return sum(e.flops for e in self.ops)

    @property
    def total_bytes(self):
        return sum(e.bytes for e in self.ops)

    @property
    def total_latency(self):
        """Sum of per-op rooflines: a LOWER bound on the step (assumes
        perfect overlap within each op, none across ops)."""
        return sum(e.latency for e in self.ops)

    @property
    def wire_latency(self):
        """Roofline latency of the collective family alone — the wire
        time a fully SERIALIZED schedule pays."""
        return sum(e.latency for e in self.ops if e.family == "collective")

    @property
    def step_latency(self):
        """Best step-time estimate under the program's actual collective
        schedule: :attr:`scheduled_latency` when the schedule is
        overlap-structured, else the serialized ``total_latency``."""
        return (
            self.scheduled_latency if self.scheduled_latency is not None
            else self.total_latency
        )

    @property
    def wire_exposed_latency(self):
        """Wire seconds the schedule can NOT hide behind compute: the
        part of :attr:`wire_latency` still on the critical path. Equals
        ``wire_latency`` for a serialized schedule."""
        wire = self.wire_latency
        compute = self.total_latency - wire
        return min(wire, max(0.0, self.step_latency - compute))

    @property
    def overlap_ratio(self):
        """Wire seconds hidden / total wire seconds (0 = fully
        serialized, 1 = the wire disappears behind the math)."""
        wire = self.wire_latency
        if wire <= 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.wire_exposed_latency / wire))

    def by_family(self):
        fams = {}
        for e in self.ops:
            f = fams.setdefault(
                e.family, {"flops": 0.0, "bytes": 0.0, "latency": 0.0,
                           "ops": 0}
            )
            f["flops"] += e.flops
            f["bytes"] += e.bytes
            f["latency"] += e.latency
            f["ops"] += e.count
        return fams

    def by_op_type(self):
        kinds = {}
        for e in self.ops:
            k = kinds.setdefault(
                e.op_type, {"flops": 0.0, "bytes": 0.0, "latency": 0.0,
                            "ops": 0}
            )
            k["flops"] += e.flops
            k["bytes"] += e.bytes
            k["latency"] += e.latency
            k["ops"] += e.count
        return kinds

    def top(self, k=10):
        """Top-k op sites by roofline latency (the "which ops eat the
        step" view)."""
        return sorted(self.ops, key=lambda e: -e.latency)[:k]

    def mfu_at(self, step_seconds: float) -> float:
        """Model FLOPs utilization of one step measured at
        ``step_seconds``, against this table's peak."""
        if step_seconds <= 0 or self.peak_flops <= 0:
            return 0.0
        return self.total_flops / step_seconds / self.peak_flops

    def to_dict(self, top=50):
        return {
            "total_flops": self.total_flops,
            "total_bytes": self.total_bytes,
            "total_latency": self.total_latency,
            "scheduled_latency": self.scheduled_latency,
            "wire_latency": self.wire_latency,
            "wire_exposed_latency": self.wire_exposed_latency,
            "overlap_ratio": self.overlap_ratio,
            "peak_flops": self.peak_flops,
            "peak_bandwidth": self.peak_bandwidth,
            "peak_bytes": self.peak_bytes,
            "resident_bytes": self.resident_bytes,
            "memory": (
                self.memory.to_dict() if self.memory is not None else None
            ),
            "by_family": self.by_family(),
            "ops": [e.to_dict() for e in self.top(top)],
            "assumptions": list(self.assumptions),
        }

    def format(self, top=10):
        """Human-readable table."""
        lines = [
            f"estimated step: {self.total_flops / 1e9:.3f} GFLOP, "
            f"{self.total_bytes / 1e6:.3f} MB moved, roofline >= "
            f"{self.total_latency * 1e3:.3f} ms "
            f"(peak {self.peak_flops / 1e12:.0f} TFLOP/s, "
            f"{self.peak_bandwidth / 1e9:.0f} GB/s)"
        ]
        if self.scheduled_latency is not None:
            lines.append(
                f"overlap schedule: step >= "
                f"{self.scheduled_latency * 1e3:.3f} ms "
                f"(wire {self.wire_latency * 1e3:.3f} ms, exposed "
                f"{self.wire_exposed_latency * 1e3:.3f} ms, "
                f"{self.overlap_ratio:.0%} hidden behind compute)"
            )
        if self.memory is not None:
            lines.append(self.memory.format(top=3))
        fams = sorted(self.by_family().items(),
                      key=lambda kv: -kv[1]["latency"])
        tot_lat = self.total_latency or 1.0
        lines.append("-- by family --")
        for fam, agg in fams:
            lines.append(
                f"  {fam:<14} {agg['flops'] / 1e9:>10.3f} GFLOP "
                f"{agg['bytes'] / 1e6:>10.3f} MB "
                f"{agg['latency'] / tot_lat:>6.1%} of roofline "
                f"({agg['ops']} ops)"
            )
        lines.append(f"-- top {top} op sites by roofline latency --")
        for e in self.top(top):
            lines.append(
                f"  {e.op_type:<28} {e.flops / 1e9:>10.3f} GFLOP "
                f"{e.bytes / 1e6:>9.3f} MB {e.latency * 1e6:>9.1f} us"
                f"  b{e.block_idx}#{e.op_index}"
                + (f"  {e.loc}" if e.loc else "")
            )
        if self.assumptions:
            lines.append("-- assumptions --")
            for a in self.assumptions:
                lines.append(f"  {a}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# per-op formulas
# ---------------------------------------------------------------------------


def _nelem(spec):
    return int(math.prod(spec[0])) if spec else 0


def _nbytes(spec):
    return _nelem(spec) * spec[1] if spec else 0


def _first(specs, slot):
    vals = specs.get(slot) or []
    for v in vals:
        if v is not None:
            return v
    return None


def _all_bytes(*spec_dicts):
    total = 0
    for specs in spec_dicts:
        for vals in specs.values():
            for v in vals:
                if v is not None:
                    total += _nbytes(v)
    return total


def _flops_matmul(op, ins, outs):
    out = _first(outs, "Out")
    x = _first(ins, "X")
    if out is None or x is None:
        return 0.0
    t = op.type
    if t == "dot":
        return 2.0 * _nelem(x)
    if t == "mul":
        xnc = int(op.attr("x_num_col_dims", 1))
        k = math.prod(x[0][xnc:]) or 1
    elif t == "matmul":
        k = x[0][-2] if op.attr("transpose_X", False) and len(x[0]) > 1 \
            else x[0][-1]
    else:  # bmm / addmm / batch_fc / bilinear-ish: contract x's last dim
        k = x[0][-1] if x[0] else 1
    return 2.0 * _nelem(out) * int(k)


def _per_dim(value, n, default=1):
    """Normalize a conv attr (scalar | [n] | [2n] begin/end pairs) to one
    BEGIN value per spatial dim."""
    if value is None:
        return [default] * n
    if not isinstance(value, (list, tuple)):
        return [int(value)] * n
    v = [int(x) for x in value]
    if len(v) >= 2 * n:
        return [v[2 * i] for i in range(n)]
    if len(v) >= n:
        return v[:n]
    return (v * n)[:n] if v else [default] * n


def _axis_taps(h_in, h_out, k, stride, pad, dil):
    """Valid (non-padding) kernel taps summed over output positions along
    one spatial dim — only real multiplies count, and at small
    spatial extents (deep resnet stages, 3x3 on 2x2) the padding share
    dominates."""
    total = 0
    for o in range(h_out):
        start = o * stride - pad
        total += sum(1 for t in range(k) if 0 <= start + t * dil < h_in)
    return total


def _conv_tap_factor(op, x, out, filt):
    """Fraction of kernel taps that land on real input (1.0 = no padding
    loss), separable per spatial dim."""
    spatial = len(x[0]) - 2
    if spatial < 1 or len(out[0]) != len(x[0]) or len(filt[0]) < 2 + spatial:
        return 1.0
    strides = _per_dim(op.attr("strides"), spatial)
    dils = _per_dim(op.attr("dilations"), spatial)
    algo = str(op.attr("padding_algorithm", "EXPLICIT")).upper()
    factor = 1.0
    for d in range(spatial):
        h_in, h_out = int(x[0][2 + d]), int(out[0][2 + d])
        k = int(filt[0][2 + d])
        if k <= 1 or h_out <= 0:
            continue
        if algo == "VALID":
            pad = 0
        elif algo == "SAME":
            pad = max(
                0, (h_out - 1) * strides[d] + (k - 1) * dils[d] + 1 - h_in
            ) // 2
        else:
            pad = _per_dim(op.attr("paddings"), spatial, default=0)[d]
        if pad == 0:
            continue
        factor *= _axis_taps(h_in, h_out, k, strides[d], pad, dils[d]) / (
            h_out * k
        )
    return factor


def _flops_conv(op, ins, outs):
    t = op.type
    filt = _first(ins, "Filter") or _first(ins, "W")
    if t.endswith("_transpose"):
        # filter [in_c, out_c/g, k...]: each INPUT element hits the whole
        # filter tail
        x = _first(ins, "Input") or _first(ins, "X")
        if x is None or filt is None:
            return 0.0
        return 2.0 * _nelem(x) * math.prod(filt[0][1:])
    out = _first(outs, "Output") or _first(outs, "Out")
    if out is None or filt is None:
        return 0.0
    # filter [out_c, in_c/g, k...]: every output element is a dot over the
    # filter tail (in_c/groups * prod(k)), discounted by padding taps
    full = 2.0 * _nelem(out) * math.prod(filt[0][1:])
    x = _first(ins, "Input") or _first(ins, "X")
    if x is None or len(x[0]) < 3:
        return full
    return full * _conv_tap_factor(op, x, out, filt)


def _flops_attention(op, ins, outs):
    causal = 0.5 if op.attr("causal", False) else 1.0
    t = op.type
    if t.startswith("fused_qkv_attention"):
        qkv = _first(ins, "QKV")
        if qkv is None:
            return 0.0
        b, s = qkv[0][0], qkv[0][1]
        e = qkv[0][-1] // 3
        fwd = 4.0 * b * s * s * e * causal
    else:  # q/k/v [B, H, S, D] (ring/ulysses share the layout)
        q = _first(ins, "Q")
        if q is None:
            return 0.0
        b, h, s, d = (list(q[0]) + [1, 1, 1, 1])[:4]
        fwd = 4.0 * b * h * s * s * d * causal
    # flash backward: dQ/dK/dV are 4 score-sized contractions plus the
    # in-kernel probability recompute ~ 2.5x the forward kernel
    return fwd * 2.5 if t.endswith("_grad") else fwd


def _flops_pool(op, ins, outs):
    ksize = op.attr("ksize")
    if op.attr("global_pooling", False) or op.attr("adaptive", False) \
            or not isinstance(ksize, (list, tuple)):
        # one pass over the input (global/adaptive reduce)
        return float(_nelem(_first(ins, "X")))
    return float(_nelem(_first(outs, "Out"))) * math.prod(ksize)


def _flops_norm(op, ins, outs):
    x = _first(ins, "X")
    n = _nelem(x)
    t = op.type
    if t.endswith("_grad"):
        return 14.0 * n
    if t in ("fused_dropout_add_ln",):
        return 10.0 * n
    if t in ("batch_norm", "sync_batch_norm", "inplace_abn"):
        return (4.0 if op.attr("is_test", False) else 6.0) * n
    return 8.0 * n


def _flops_optimizer(op, ins, outs):
    p = _first(ins, "Param")
    return OPTIMIZER_OPS.get(op.type, 4.0) * _nelem(p)


def _lookup_exchange_axis(op, axis_sizes):
    ax = op.attr("axis_name", "ps")
    n = int(axis_sizes.get(ax, 1))
    return n if n > 1 else 1


def _lookup_wire_elem_bytes(op, itemsize):
    return _quant_elem_bytes(
        op.attr("quant", "none"), op.attr("quant_block", 256), itemsize
    )


def _lookup_cost(op, ins, outs, axis_sizes):
    """Forward closed form for the engine's lookup ops
    (distributed_lookup_table / fused_lookup_table): ids read + output
    write + the UNIQUE-row gather — batch dedup means at most
    min(total ids, total table rows) rows actually stream from the table —
    plus the row-assembly exchange wire when the table is mesh-partitioned
    (psum of the masked [ids, D] rows ~ allreduce factor; the col
    partition's all-gather moves (n-1)/n of the assembled rows)."""
    ids_bytes = sum(
        _nbytes(v) for v in ins.get("Ids", ()) if v is not None
    )
    out_bytes = sum(
        _nbytes(v) for v in outs.get("Out", ()) if v is not None
    )
    tables = [v for v in ins.get("W", ()) if v is not None]
    table_rows = sum(v[0][0] for v in tables if v[0])
    dim = tables[0][0][-1] if tables and tables[0][0] else 1
    itemsize = tables[0][1] if tables else 4
    total_ids = sum(
        _nelem(v) for v in ins.get("Ids", ()) if v is not None
    )
    unique_rows = min(total_ids, table_rows) if table_rows else total_ids
    gather_bytes = (
        unique_rows * dim * itemsize
        if bool(op.attr("dedup", True)) else out_bytes
    )
    nbytes = ids_bytes + out_bytes + gather_bytes
    n = _lookup_exchange_axis(op, axis_sizes)
    if n > 1:
        row_payload = float(total_ids * dim)
        if op.attr("partition", "row") == "col":
            nbytes += row_payload * itemsize * (n - 1) / n
        else:
            # forward psum of the masked rows: allreduce ring factor at
            # full precision (quantization applies to the BACKWARD grad
            # exchange only; see _lookup_grad_cost)
            nbytes += row_payload * itemsize * 2.0 * (n - 1) / n
    return 0.0, nbytes


def _lookup_grad_cost(fwd_op, fwd_ins, fwd_outs, axis_sizes):
    """Backward closed form: ONE segment-sum scatter per table — each
    gathered row's cotangent is read once and accumulated into its unique
    row (flops ~= out grad elems), moving grad-rows in and unique table
    rows out — plus the id->owner grad all-to-all + all-gather at the
    (possibly int8 block-quantized) wire element size when row-sharded."""
    out_bytes = sum(
        _nbytes(v) for v in fwd_outs.get("Out", ()) if v is not None
    )
    out_elems = sum(
        _nelem(v) for v in fwd_outs.get("Out", ()) if v is not None
    )
    tables = [v for v in fwd_ins.get("W", ()) if v is not None]
    table_rows = sum(v[0][0] for v in tables if v[0])
    dim = tables[0][0][-1] if tables and tables[0][0] else 1
    itemsize = tables[0][1] if tables else 4
    total_ids = sum(
        _nelem(v) for v in fwd_ins.get("Ids", ()) if v is not None
    )
    unique_rows = min(total_ids, table_rows) if table_rows else total_ids
    nbytes = 2.0 * out_bytes + unique_rows * dim * itemsize
    flops = float(out_elems)
    n = _lookup_exchange_axis(fwd_op, axis_sizes)
    if n > 1 and fwd_op.attr("partition", "row") != "col":
        elem = _lookup_wire_elem_bytes(fwd_op, itemsize)
        # reduce-scatter (all_to_all) + all-gather legs over the grad rows
        nbytes += float(total_ids * dim) * elem * 2.0 * (n - 1) / n
        flops += float(total_ids * dim)  # fp32 accumulation of the shards
    return flops, nbytes


def _collective_cost(op, ins, outs, axis_sizes):
    """(flops, wire_bytes) for a collective op given bound axis sizes."""
    from .collectives import collective_axis

    payload = _first(ins, "X")
    nbytes = _nbytes(payload)
    # per-op emitter axis defaults live in collectives.py (dp/sp/pp/ps…)
    ax, _kind = collective_axis(op)
    if ax is None:
        ax = op.attr("axis_name", "dp")
    n = int(axis_sizes.get(ax, 1))
    if n <= 1:
        return 0.0, 0.0  # unbound axis: the emitter degrades to identity
    factor = _COLLECTIVE_FACTORS.get(op.type, lambda n: 1.0)(n)
    if op.type in ("zero_reduce_scatter", "zero_all_gather",
                   "zero_bucket_reduce_scatter"):
        # the wire payload is the PADDED flat vector at the (possibly
        # quantized) element size, not the declared input tensor:
        # pad_len * (1B + 4B/quant_block) int8, pad_len * itemsize fp.
        # A bucket's payload is the sum of its members' pads.
        if op.type == "zero_bucket_reduce_scatter":
            pad = int(sum(int(p) for p in (op.attr("pad_lens") or ())))
            if not pad:
                pad = sum(
                    _nelem(v) for v in ins.get("X", ()) if v is not None
                )
        else:
            pad = int(op.attr("pad_len") or _nelem(payload))
        elem = _quant_elem_bytes(
            op.attr("quant", "none"), op.attr("quant_block", 256),
            payload[1] if payload else 4,
        )
        # reduce-scatter sums n contributions per received element
        flops = float(pad) if op.type != "zero_all_gather" else 0.0
        return flops, pad * elem * factor
    if op.type == "c_bucket_allreduce_sum":
        elems = sum(_nelem(v) for v in ins.get("X", ()) if v is not None)
        itemsize = payload[1] if payload else 4
        return float(elems), elems * itemsize * factor
    flops = float(_nelem(payload)) if "allreduce" in op.type else 0.0
    return flops, nbytes * factor


def op_cost(op, in_specs, out_specs, axis_sizes=None):
    """(flops, bytes) for ONE execution of `op` at the given specs.

    in_specs/out_specs: {slot: [(shape, itemsize) | None, ...]}.
    """
    t = op.type
    generic_bytes = _all_bytes(in_specs, out_specs)
    if t in _COLLECTIVE_FACTORS:
        return _collective_cost(op, in_specs, out_specs, axis_sizes or {})
    if t in SPARSE_LOOKUP_OPS:
        return _lookup_cost(op, in_specs, out_specs, axis_sizes or {})
    if t in MATMUL_OPS:
        return _flops_matmul(op, in_specs, out_specs), generic_bytes
    if t in CONV_OPS:
        return _flops_conv(op, in_specs, out_specs), generic_bytes
    if t in ATTENTION_OPS:
        return _flops_attention(op, in_specs, out_specs), generic_bytes
    if t in NORM_OPS:
        return _flops_norm(op, in_specs, out_specs), generic_bytes
    if t in OPTIMIZER_OPS:
        return _flops_optimizer(op, in_specs, out_specs), generic_bytes
    if t in ("pool2d", "pool3d", "max_pool2d_with_index",
             "max_pool3d_with_index", "unpool", "spp"):
        return _flops_pool(op, in_specs, out_specs), generic_bytes
    if t in DATA_OPS or t in EMBED_OPS:
        slot = _GATHER_TABLE_SLOTS.get(t)
        table = _first(in_specs, slot) if slot else None
        if table is not None:
            out_bytes = sum(
                _nbytes(v)
                for vals in out_specs.values() for v in vals if v is not None
            )
            return 0.0, generic_bytes - _nbytes(table) + out_bytes
        return 0.0, generic_bytes
    if t in REDUCE_OPS:
        x = _first(in_specs, "X")
        return float(_nelem(x)), generic_bytes
    if t == "sum":  # n-ary accumulate
        out = _first(out_specs, "Out")
        n_in = sum(1 for v in in_specs.get("X", []) if v is not None)
        return float(max(n_in - 1, 1) * _nelem(out)), generic_bytes
    weight = ELEMENTWISE_WEIGHTS.get(t, 1.0)
    # elementwise default: weight flops per OUTPUT element
    out_elems = sum(
        _nelem(v)
        for vals in out_specs.values() for v in vals if v is not None
    )
    if out_elems == 0:
        out_elems = sum(
            _nelem(v)
            for vals in in_specs.values() for v in vals if v is not None
        )
    return weight * out_elems, generic_bytes


# ---------------------------------------------------------------------------
# overlap-aware schedule simulation
# ---------------------------------------------------------------------------


def _scheduled_latency(entries):
    """Two-resource step-time simulation over the walk-order cost entries
    ``(latency, is_wire, reads, writes)``: compute executes ops in program
    order on one timeline; a collective occupies the wire channel (one
    collective in flight at a time — the link serializes) starting when its
    inputs exist and the channel is free, WITHOUT blocking compute; a
    compute op that READS a collective's output waits for that collective
    to land. The result is max(compute, wire) per overlap segment instead
    of the serialized global sum — the latency-hiding-scheduler model the
    bucketed/prefetched transpile is shaped for."""
    t_c = 0.0  # compute timeline
    wire_free = 0.0  # when the wire channel is next available
    pending = {}  # var name -> completion time of the collective writing it
    for lat, is_wire, reads, writes in entries:
        if is_wire:
            dep = max(
                (pending[r] for r in reads if r in pending), default=0.0
            )
            start = max(t_c, wire_free, dep)
            end = start + lat
            wire_free = end
            for w in writes:
                pending[w] = end
        else:
            for r in reads:
                if r in pending:
                    t_c = max(t_c, pending.pop(r))
            for w in writes:
                pending.pop(w, None)  # overwritten: the wire result is dead
            t_c += lat
    return max(t_c, wire_free)


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------

_SKIP_OPS = frozenset({
    "feed", "fetch", "print", "assert", "py_func", "delete_var",
    "c_comm_init_all", "get_places", "is_empty",
})


class _Estimator:
    def __init__(self, program, feed_shapes, table):
        self.program = program
        self.table = table
        self.feed_shapes = {
            k: tuple(int(d) for d in v)
            for k, v in (feed_shapes or {}).items()
        }
        self.batch_hint = next(
            (s[0] for s in self.feed_shapes.values() if s), 1
        )
        self.pinned = set()  # distinct (var name, dim index) pins
        self.unknown_ops = {}
        # walk-order (latency, is_wire, reads, writes) entries feeding the
        # overlap-aware schedule simulation (_scheduled_latency)
        self.sched = []
        mesh = getattr(program, "_mesh", None)
        self.axis_sizes = dict(mesh.shape) if mesh is not None else {}

    # -- shape resolution --------------------------------------------------
    def _spec(self, block, name):
        if not name:
            return None
        v = block._find_var_recursive(name)
        if name in self.feed_shapes:
            shape = self.feed_shapes[name]
            dtype = v.dtype if v is not None and v.dtype else "float32"
            return shape, itemsize(dtype)
        if v is None or v.shape is None:
            return None
        shape = []
        for di, d in enumerate(v.shape):
            if d in (-1, None):
                shape.append(self.batch_hint)
                self.pinned.add((name, di))
            else:
                shape.append(int(d))
        return tuple(shape), itemsize(v.dtype)

    def _specs(self, block, slot_names):
        return {
            slot: [self._spec(block, n) for n in names]
            for slot, names in (slot_names or {}).items()
        }

    # -- op dispatch -------------------------------------------------------
    def walk_block(self, block, count=1, depth=0):
        if depth > 16:
            return
        for i, op in enumerate(block.ops):
            self.visit(op, block, i, count, depth)

    def visit(self, op, block, op_index, count, depth):
        t = op.type
        if t in _SKIP_OPS:
            return
        if t == "__vjp__":
            self._visit_vjp(op, block, op_index, count)
            return
        if t in ("pipeline_block", "pipeline_uniform"):
            self._visit_pipeline(op, block, op_index, count, depth)
            return
        if t == "recompute_segment":
            self._visit_recompute(op, block, op_index, count, depth,
                                  grad=False)
            return
        if t in ("cond", "conditional_block", "conditional_block_infer"):
            self._visit_branch(op, block, op_index, count, depth)
            return
        sub = op.attr("sub_block")
        if sub is not None and t in ("while", "scan_block", "bounded_while"):
            # bounded_while runs a STATIC max_iters bound; scan_block's
            # trip count is its SeqIn leading dim
            trips = op.attr("max_iters", None)
            if trips is None and t == "scan_block":
                seq_names = (op.inputs or {}).get("SeqIn") or []
                seq = self._spec(block, seq_names[0]) if seq_names else None
                if seq:
                    trips = seq[0][0]
            mult = int(trips) if trips else 1
            if not trips:
                self.table.assumptions.append(
                    f"loop body of {t!r} (block {sub}) counted once "
                    "(no static trip count)"
                )
            self.walk_block(self.program.blocks[sub], count * mult,
                            depth + 1)
            return
        from ..framework.registry import _REGISTRY

        if t not in _REGISTRY:
            self.unknown_ops[t] = self.unknown_ops.get(t, 0) + 1
            return
        ins = self._specs(block, op.inputs)
        outs = self._specs(block, op.outputs)
        flops, nbytes = op_cost(op, ins, outs, self.axis_sizes)
        self._record(op, t, flops, nbytes, count, block.idx, op_index)

    _SUB_BLOCK_FWD = frozenset({
        "while", "bounded_while", "scan_block", "cond",
        "conditional_block", "pipeline_block", "pipeline_uniform",
    })

    def _visit_vjp(self, op, block, op_index, count):
        from ..framework.registry import OpView

        fwd_type = op.attr("fwd_type")
        if fwd_type in self._SUB_BLOCK_FWD:
            # replaying a looped/branched body's vjp is not modeled yet;
            # recording the omission beats silently costing it as a
            # near-zero elementwise op
            self.table.assumptions.append(
                f"backward of sub-block op {fwd_type!r} not modeled "
                "(cost omitted)"
            )
            return
        fwd_op = OpView(fwd_type, op.attr("fwd_attrs"))
        fwd_ins = {
            slot[len("FwdIn:"):]: [self._spec(block, n) for n in names]
            for slot, names in op.inputs.items()
            if slot.startswith("FwdIn:")
        }
        # the forward op's OUTPUT shapes arrive as this op's OutGrad inputs
        fwd_outs = {
            slot[len("OutGrad:"):]: [self._spec(block, n) for n in names]
            for slot, names in op.inputs.items()
            if slot.startswith("OutGrad:")
        }
        if fwd_type == "recompute_segment":
            self._visit_recompute(fwd_op, block, op_index, count, 0,
                                  grad=True)
            return
        if fwd_type in SPARSE_LOOKUP_OPS:
            # one segment-sum scatter per table + the (possibly quantized)
            # grad exchange — NOT 2x the forward gather
            flops, nbytes = _lookup_grad_cost(
                fwd_op, fwd_ins, fwd_outs, self.axis_sizes
            )
            self._record(op, f"{fwd_type}_grad", flops, nbytes, count,
                         block.idx, op_index)
            return
        flops, nbytes = op_cost(fwd_op, fwd_ins, fwd_outs, self.axis_sizes)
        # each WANTED input grad of a contraction is one forward-sized
        # contraction (dX and dW of a matmul/conv are each 2MNK; a
        # first-layer conv never computes dX) — the replayed forward
        # itself is not counted (the JAX package's XLA merges it with the
        # original; the port's eager replay runs it, backward.py)
        wanted = sum(
            1 for slot, names in op.outputs.items()
            if slot.startswith("InGrad:") and any(names)
        )
        fam = family_of(fwd_type)
        if fam in ("matmul", "conv", "attention"):
            mult = float(max(wanted, 1))
        elif fam == "normalization":
            mult = 1.75  # d(norm) re-reduces once whatever grads are wanted
        else:
            mult = float(min(max(wanted, 1), 2))
        self._record(op, f"{fwd_type}_grad", mult * flops, mult * nbytes,
                     count, block.idx, op_index)

    def _visit_recompute(self, op, block, op_index, count, depth, grad):
        from ..framework.registry import OpView

        mult = 3.0 if grad else 1.0  # bwd = re-run fwd + 2x-fwd vjp
        for ot, oins, oouts, oattrs in op.attr("sub_ops", ()):
            view = OpView(ot, oattrs, outputs=oouts, inputs=oins)
            ins = self._specs(block, oins)
            outs = self._specs(block, oouts)
            flops, nbytes = op_cost(view, ins, outs, self.axis_sizes)
            self._record(
                view, ot + ("_grad" if grad else ""), mult * flops,
                mult * nbytes, count, block.idx, op_index,
                loc=op.attr("__loc__", ""),
            )

    def _visit_pipeline(self, op, block, op_index, count, depth):
        # M microbatches at B/M each sum to the declared-[B] cost, so each
        # stage block is walked once at graph-build shapes
        if op.type == "pipeline_uniform":
            body = op.attr("stage_block")
            if body is not None:
                self.walk_block(self.program.blocks[body], count, depth + 1)
            return
        for bi in op.attr("stage_blocks") or ():
            self.walk_block(self.program.blocks[bi], count, depth + 1)

    def _visit_branch(self, op, block, op_index, count, depth):
        # both branches are traced but one executes: charge the costlier
        best, best_sub = -1.0, None
        for attr in ("true_block", "false_block", "sub_block"):
            bi = op.attr(attr)
            if bi is None:
                continue
            sub = _Estimator(self.program, self.feed_shapes, CostTable(
                peak_flops=self.table.peak_flops,
                peak_bandwidth=self.table.peak_bandwidth,
            ))
            sub.axis_sizes = self.axis_sizes
            sub.batch_hint = self.batch_hint
            sub.walk_block(self.program.blocks[bi], count, depth + 1)
            lat = sub.table.total_latency
            if lat > best:
                best, best_sub = lat, sub
        if best_sub is not None:
            self.table.ops.extend(best_sub.table.ops)
            self.sched.extend(best_sub.sched)
            # pins / skipped ops inside the charged branch must still
            # surface in the parent's assumptions
            self.table.assumptions.extend(best_sub.table.assumptions)
            self.pinned |= best_sub.pinned
            for t, n in best_sub.unknown_ops.items():
                self.unknown_ops[t] = self.unknown_ops.get(t, 0) + n

    def _record(self, op, op_type, flops, nbytes, count, block_idx,
                op_index, loc=None):
        flops *= count
        nbytes *= count
        lat = max(
            flops / self.table.peak_flops if self.table.peak_flops else 0.0,
            nbytes / self.table.peak_bandwidth
            if self.table.peak_bandwidth else 0.0,
        )
        family = family_of(
            op_type[:-5] if op_type.endswith("_grad") else op_type
        )
        reads = tuple(
            n for names in (getattr(op, "inputs", None) or {}).values()
            for n in names if n
        )
        writes = tuple(
            n for names in (getattr(op, "outputs", None) or {}).values()
            for n in names if n
        )
        if not hasattr(self, "sched"):  # bare _Estimator (tests) tolerated
            self.sched = []
        self.sched.append((lat, family == "collective", reads, writes))
        self.table.ops.append(OpCost(
            op_type=op_type, family=family,
            flops=flops, bytes=float(nbytes), latency=lat, count=count,
            block_idx=block_idx, op_index=op_index,
            loc=loc if loc is not None else str(
                op.attr("__loc__", "") or ""
            ),
        ))


def estimate_program(program, feed_shapes=None, peak_tflops=None,
                     peak_gbps=None) -> CostTable:
    """Analytic per-op cost table for ONE step of `program`.

    feed_shapes: {var name: shape} pinning -1 (batch) dims — pass the
    shapes of the batch you will actually feed (``Program.estimate``
    forwards them). Unpinned -1 dims fall back to the leading dim of any
    feed, else 1, and are recorded in ``table.assumptions``.
    """
    table = CostTable(
        peak_flops=(
            peak_tflops * 1e12 if peak_tflops is not None else peak_flops()
        ),
        peak_bandwidth=(
            peak_gbps * 1e9 if peak_gbps is not None else peak_bandwidth()
        ),
    )
    est = _Estimator(program, feed_shapes, table)
    est.walk_block(program.global_block)
    if getattr(program, "_overlap_schedule", False):
        # the transpiler restructured the collective schedule for overlap
        # (bucketed grad collectives / prefetched all-gathers): estimate
        # the step as the two-resource simulation instead of the
        # serialized sum, and record the modeling choice
        table.scheduled_latency = _scheduled_latency(est.sched)
        table.assumptions.append(
            "overlap schedule: step estimated as max(compute, wire) per "
            "overlap segment (collectives on a concurrent wire channel)"
        )
    if est.pinned:
        table.assumptions.append(
            f"pinned {len(est.pinned)} unknown (-1) dims to batch hint "
            f"{est.batch_hint}"
        )
    for t, n in sorted(est.unknown_ops.items()):
        table.assumptions.append(
            f"unregistered op type {t!r} x{n} skipped"
        )
    try:
        from .memory import plan_memory

        # budget=None: the oom-risk gate belongs to the verifier; the
        # estimate just reports the plan
        mem = plan_memory(program, feed_shapes=feed_shapes, budget=None)
        table.memory = mem
        table.peak_bytes = mem.peak_bytes
        table.resident_bytes = mem.resident_bytes
    except Exception as exc:  # the cost table must survive a planner bug
        table.assumptions.append(f"static memory plan unavailable: {exc!r}")
    return table
