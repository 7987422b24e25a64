"""Shape/dtype desync detection: replay ``registry.infer_shapes`` per op
(the emitter on meta tensors) and cross-check every declared Variable
against what the emitter would actually produce (counterpart of
paddle_tpu/analysis/shapes.py).

Most layers create their outputs from the emitter's inferred shapes, so
declaration and emitter agree *at build time* — but ops appended with
explicit outputs (optimizers, transpilers, hand-built graphs, programs
read from files) carry declarations the emitter never saw. When the two
drift, the run fails mid-step with no op attribution, or — worse — a
downstream op silently broadcasts. This pass catches the drift before
the run, per op.

-1 (batch) dims are compared as wildcards on either side: the declared
graph-build shape pins them at feed time, so only *concrete* disagreements
are desyncs. Replay reuses the registry's BATCH_SENTINEL machinery —
``infer_shapes`` maps -1 through the prime sentinel and back.
"""

from __future__ import annotations

from ..core.dtypes import convert_dtype
from ..framework.registry import _REGISTRY, infer_shapes
from .findings import (
    DTYPE_DESYNC,
    SHAPE_DESYNC,
    Severity,
    finding_for_op,
)

# ops never replayed:
#   __vjp__     — machine-generated grad replay; its outputs are created
#                 from the forward var's declaration (backward._ensure_var)
#                 so they cannot drift, and replaying doubles verify cost;
#   feed/fetch  — no emitter semantics of their own.
SKIP_OPS = frozenset({"__vjp__", "feed", "fetch"})


def _shapes_match(declared, inferred):
    if len(declared) != len(inferred):
        return False
    for d, i in zip(declared, inferred):
        if d == -1 or i == -1:
            continue  # batch wildcard: pinned at feed time
        if int(d) != int(i):
            return False
    return True


def analyze_shapes(program):
    findings = []
    for blk in program.blocks:
        for i, op in enumerate(blk.ops):
            if op.type in SKIP_OPS or op.type not in _REGISTRY:
                continue
            # skip ops whose input declarations are unknown — replaying
            # them would infer from garbage and report phantom desyncs
            skip = False
            for n in op.input_names():
                v = blk._find_var_recursive(n) if n else None
                if n and (v is None or v.shape is None):
                    skip = True
                    break
            if skip:
                continue
            try:
                out_specs = infer_shapes(op.type, blk, op.inputs, op.attrs)
            except Exception:
                # inference itself failed (op needs runtime-only context);
                # structural analysis already covers undeclared names
                continue
            for slot, names in op.outputs.items():
                specs = out_specs.get(slot, [])
                for j, n in enumerate(names):
                    if not n or j >= len(specs):
                        continue
                    shape, dtype = specs[j]
                    if shape is None:
                        continue
                    v = blk._find_var_recursive(n)
                    if v is None:
                        continue  # undeclared-write finding covers it
                    if v.shape is not None and not _shapes_match(
                        tuple(v.shape), tuple(shape)
                    ):
                        findings.append(finding_for_op(
                            Severity.ERROR, SHAPE_DESYNC,
                            f"output {n!r} declared with shape "
                            f"{tuple(v.shape)} but the {op.type!r} emitter "
                            f"produces {tuple(shape)}",
                            op=op, op_index=i, block_idx=blk.idx,
                            names=(n,),
                        ))
                    if dtype is not None and convert_dtype(
                        v.dtype
                    ) != convert_dtype(dtype):
                        findings.append(finding_for_op(
                            Severity.ERROR, DTYPE_DESYNC,
                            f"output {n!r} declared as {v.dtype} but the "
                            f"{op.type!r} emitter produces "
                            f"{convert_dtype(dtype)}",
                            op=op, op_index=i, block_idx=blk.idx,
                            names=(n,),
                        ))
    return findings
