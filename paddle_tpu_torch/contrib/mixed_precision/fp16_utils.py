"""Program rewriting for AMP (counterpart of paddle_tpu/contrib/
mixed_precision/fp16_utils.py; reference fp16_utils.py rewrite_program).

Walks the forward ops and inserts `cast` ops so white-list ops consume
the low-precision dtype and black-list ops consume fp32. Parameters stay
fp32 masters in the Scope; each use of one in a low-precision op reads a
cast of it. Must run BEFORE append_backward so the casts get
differentiated (the grad of a cast casts back, so the masters' gradients
come out fp32).
"""

from __future__ import annotations

from ...core.dtypes import is_float
from ...errors import UnimplementedError
from ...framework import unique_name
from ...framework.registry import infer_shapes
from .fp16_lists import AutoMixedPrecisionLists


def _insert_cast(block, op_idx, op, name, dest_dtype, force=False):
    """Insert cast(name)->new var before op_idx; rewire op's input.

    force=True casts even when the var's *declared* dtype already matches:
    after white-op rewriting, declared dtypes can lag the runtime dtype, so
    black-list fp32 casts are emitted unconditionally (an f32->f32 cast
    costs one copy of the tensor)."""
    src = block._find_var_recursive(name)
    if src is None or not is_float(src.dtype):
        return 0
    if src.dtype == dest_dtype and not force:
        return 0
    cast_name = unique_name.generate(f"{name}.cast_{dest_dtype}")
    block.create_var(
        name=cast_name, shape=src.shape, dtype=dest_dtype,
        stop_gradient=src.stop_gradient,
    )
    block.append_op(
        "cast",
        {"X": [name]},
        {"Out": [cast_name]},
        {"in_dtype": src.dtype, "out_dtype": dest_dtype},
        index=op_idx,
    )
    for slot, names in op.inputs.items():
        op.inputs[slot] = [cast_name if n == name else n for n in names]
    return 1


# gray ops that must keep their inputs untouched: control flow re-enters
# sub-blocks (casts would break capture analysis), cast has an explicit
# out_dtype contract
_GRAY_SKIP = {"while", "conditional_block", "cast", "print", "py_func",
              "assign", "share_data", "pipeline_block", "pipeline_uniform",
              "pipeline_gate_loss", "recompute_segment"}

# input slots that carry TARGETS, not activations: never downcast them.
# A soft-label fp32 Label is data — it does not ride the activation
# stream the bandwidth rule targets, and bf16 quantizes it for no win.
_LABEL_SLOTS = {"Label", "Target", "GTBox", "GTLabel", "GTScore"}

# per-(op, slot) gray-downcast exemptions: the fused residual kernel's LN
# affine parameters stay fp32, as black-listed layer_norm's would (the
# kernel computes in fp32 and takes fp32 g and c)
_GRAY_SLOT_KEEP = {
    ("fused_dropout_add_ln", "Scale"),
    ("fused_dropout_add_ln", "LnBias"),
}

# pipeline-parallel stage ops: the JAX package rewrites inside their stage
# blocks; the port has no pipeline parallelism yet
_PIPELINE = ("pipeline_block", "pipeline_uniform")


def rewrite_program(program, amp_lists=None, dest_dtype="bfloat16"):
    """Insert casts per black/white lists into the (forward-only) program.

    Gray ops (neither list) FOLLOW their inputs, as in the reference
    rewrite (fp16_lists.py gray set + fp16_utils.py process rule): once any
    float input is low-precision, the remaining fp32 float inputs (fp32
    master params, typically a bias) are cast down too, so a bias add does
    not lift the activation stream back to fp32 between two matmuls."""
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    for op in program.global_block.ops:
        if op.type in _PIPELINE:
            raise UnimplementedError(
                f"rewrite_program: {op.type} (pipeline parallelism) is not "
                "in the port yet", op=op,
            )
    _rewrite_block(program.global_block, amp_lists, dest_dtype)
    program._bump()
    return program


def _rewrite_block(block, amp_lists, dest_dtype):
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type in amp_lists.white_list:
            target, force = dest_dtype, False
        elif op.type in amp_lists.black_list:
            target, force = "float32", True
        elif op.type not in _GRAY_SKIP:
            dts = set()
            for n in op.input_names():
                v = block._find_var_recursive(n)
                if v is not None and is_float(v.dtype):
                    dts.add(str(v.dtype))
            if dest_dtype not in dts:
                i += 1
                continue
            target, force = dest_dtype, False
        else:
            i += 1
            continue
        inserted = 0
        skip = set()
        if target == dest_dtype:
            for slot in op.inputs:
                if slot in _LABEL_SLOTS or (op.type, slot) in _GRAY_SLOT_KEEP:
                    skip.update(op.inputs[slot])
        for name in list(dict.fromkeys(op.input_names())):
            if name in skip:
                continue
            inserted += _insert_cast(block, i, op, name, target, force)
        if target == dest_dtype:
            # declared output dtypes follow what the emitter gives on the
            # new inputs (one run on meta tensors), so later white-op cast
            # checks see the truth: fp32-accumulating emitters
            # (softmax_with_cross_entropy reduces in fp32 from bf16
            # logits) keep fp32 outputs
            specs = infer_shapes(op.type, block, op.inputs, op.attrs)
            for slot, names in op.outputs.items():
                slot_specs = specs.get(slot, [])
                for j, n in enumerate(names):
                    v = block._find_var_recursive(n)
                    if v is None or not is_float(v.dtype):
                        continue
                    inferred = (
                        slot_specs[j][1] if j < len(slot_specs) else None
                    )
                    v.dtype = (
                        inferred
                        if inferred is not None and is_float(inferred)
                        else dest_dtype
                    )
        i += 1 + inserted
    return block
