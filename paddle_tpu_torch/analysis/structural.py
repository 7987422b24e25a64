"""Structural (dataflow) verification of a Program block (counterpart of
paddle_tpu/analysis/structural.py).

Mirrors the classification the executor performs in
``executor._analyze_block`` — inputs not produced earlier and not fed are
pulled from the Scope — but turns each way that pull can go wrong into a
named finding BEFORE the run:

* use-before-def: a non-persistable, non-feed temp read before any op
  produces it. At run time this is a PreconditionNotMet from
  ``Executor._from_scope`` (or stale data from a previous program — worse).
* undeclared-var / undeclared-write: an op references a name with no
  Variable metadata anywhere in the block chain. The env-based emitter
  loop tolerates it, but shape inference, persistable write-back and
  sharding specs are all blind to such names.
* unknown-op: op type absent from the registry — the run would raise
  UnimplementedError at that op; here it is caught before the run.
* redefinition: ``Block.create_var``/``create_parameter`` overwrote an
  existing entry, where a program records it in ``_redefinitions`` (the
  JAX package's Blocks do; the port's do not).
* dead-op / unreachable-var: ops whose outputs can never reach a fetch or
  a persistable, and vars no op touches. The port's executor runs them
  for nothing; they usually indicate a model-construction bug (e.g. a
  metric built and never fetched).
"""

from __future__ import annotations

from ..framework.registry import _REGISTRY
from .findings import (
    DEAD_OP,
    MISSING_FEED,
    REDEFINITION,
    TRAINING_OP_IN_INFERENCE,
    UNDECLARED_VAR,
    UNDECLARED_WRITE,
    UNKNOWN_OP,
    UNREACHABLE_VAR,
    USE_BEFORE_DEF,
    Finding,
    Severity,
    finding_for_op,
)

# Op types that must never survive in a frozen inference program
# (serving/freeze.py is the canonical producer of such programs; it marks
# them with ``program._is_inference``). Parameter-update ops mutate
# persistables, grad ops recompute backward work per request, and the AMP
# loss-scaling automaton corrupts its state when stepped outside training.
OPTIMIZER_UPDATE_OPS = frozenset({
    "sgd", "momentum", "lars_momentum", "adam", "adamw", "lamb", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "adamax", "dpsgd",
})
AMP_TRAINING_OPS = frozenset({
    "amp_check_finite_and_scale", "check_finite_and_unscale",
    "update_loss_scaling",
})


def is_training_only_op(op_type: str) -> bool:
    """True for ops with no business in a frozen inference graph:
    parameter updates, explicit grad kernels, the generic ``__vjp__``
    backward replay, and the AMP loss-scale automaton."""
    return (
        op_type in OPTIMIZER_UPDATE_OPS
        or op_type in AMP_TRAINING_OPS
        or op_type == "__vjp__"
        or op_type.endswith("_grad")
    )

# ops that are live regardless of dataflow (side effects / control
# structure); their sub-blocks are not part of the global-block dataflow
_SUB_BLOCK_ATTRS = (
    "sub_block", "true_block", "false_block", "stage_block", "stage_blocks",
)


def _sub_block_indices(op):
    out = []
    for a in _SUB_BLOCK_ATTRS:
        v = op.attr(a) if hasattr(op, "attr") else None
        if v is None:
            continue
        out.extend(v if isinstance(v, (list, tuple)) else [v])
    return out


def analyze_structural(program, feed_names=(), fetch_names=()):
    findings = []
    feed_names = set(feed_names or ())
    fetch_names = tuple(fetch_names or ())
    block = program.global_block

    # --- training-only ops in frozen inference programs -------------------
    # (only when the program is marked as an inference freeze — training
    # graphs legitimately carry these ops)
    if getattr(program, "_is_inference", False):
        for blk in program.blocks:
            for i, op in enumerate(blk.ops):
                if is_training_only_op(op.type):
                    findings.append(finding_for_op(
                        Severity.ERROR, TRAINING_OP_IN_INFERENCE,
                        f"training-only op {op.type!r} survived a freeze "
                        "into an inference program — it would mutate "
                        "parameters/loss-scale state or recompute backward "
                        "work per request; re-freeze from the training "
                        "graph (serving.freeze_program)",
                        op=op, op_index=i, block_idx=blk.idx,
                    ))

    # --- unknown ops + undeclared reads/writes, every block ---------------
    for blk in program.blocks:
        for i, op in enumerate(blk.ops):
            if op.type not in _REGISTRY:
                findings.append(finding_for_op(
                    Severity.ERROR, UNKNOWN_OP,
                    f"op type {op.type!r} is not registered; the run "
                    "would raise UnimplementedError",
                    op=op, op_index=i, block_idx=blk.idx,
                ))
            for n in op.output_names():
                if n and blk._find_var_recursive(n) is None:
                    findings.append(finding_for_op(
                        Severity.WARNING, UNDECLARED_WRITE,
                        f"op writes to {n!r} which is not declared in any "
                        "reachable block; shape inference, persistable "
                        "write-back and sharding cannot see this name",
                        op=op, op_index=i, block_idx=blk.idx, names=(n,),
                    ))

    # --- use-before-def over the global block's execution order -----------
    produced = set()
    producer_index = {}
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            if n and n not in producer_index:
                producer_index[n] = i
    for i, op in enumerate(block.ops):
        for n in op.input_names():
            if not n or n in produced or n in feed_names:
                continue
            v = block._find_var_recursive(n)
            if v is None:
                findings.append(finding_for_op(
                    Severity.ERROR, UNDECLARED_VAR,
                    f"op reads {n!r} which is not declared in any "
                    "reachable block",
                    op=op, op_index=i, names=(n,),
                ))
            elif v.persistable:
                pass  # legal: read from scope (params / optimizer state)
            elif v.is_data:
                # a feed var: legal unless an explicit feed set was given
                # and it is missing from it
                if feed_names:
                    findings.append(finding_for_op(
                        Severity.ERROR, MISSING_FEED,
                        f"data variable {n!r} is read but missing from the "
                        f"feed set {sorted(feed_names)}",
                        op=op, op_index=i, names=(n,),
                    ))
            else:
                later = producer_index.get(n)
                detail = (
                    f"; it is only produced later by op #{later}"
                    if later is not None and later > i
                    else "; no op in this block produces it"
                )
                findings.append(finding_for_op(
                    Severity.ERROR, USE_BEFORE_DEF,
                    f"op reads non-persistable temp {n!r} before any op "
                    f"produces it{detail} — at run time this is an "
                    "uninitialized-scope error",
                    op=op, op_index=i, names=(n,),
                ))
        produced.update(n for n in op.output_names() if n)

    # --- silent redefinitions recorded at build time ----------------------
    for blk in program.blocks:
        for ev in getattr(blk, "_redefinitions", ()):
            sev = Severity.WARNING if ev["spec_changed"] else Severity.INFO
            findings.append(Finding(
                severity=sev,
                category=REDEFINITION,
                message=(
                    f"variable {ev['name']!r} was silently redefined "
                    f"({ev['detail']}); the old Variable object is now "
                    "orphaned but ops may still reference it"
                ),
                block_idx=blk.idx,
                names=(ev["name"],),
                loc=ev.get("loc"),
            ))

    # --- dead ops / unreachable vars (global block, needs a fetch set) ----
    if fetch_names:
        live = set(fetch_names)
        live_ops = [False] * len(block.ops)
        for i in range(len(block.ops) - 1, -1, -1):
            op = block.ops[i]
            outs = [n for n in op.output_names() if n]
            is_live = (
                not outs  # pure side-effect op: keep
                or bool(_sub_block_indices(op))  # control flow: keep
                or any(n in live for n in outs)
            )
            if not is_live:
                for n in outs:
                    v = block._find_var_recursive(n)
                    if v is not None and v.persistable:
                        is_live = True  # state write-back
                        break
            if is_live:
                live_ops[i] = True
                live.update(n for n in op.input_names() if n)
        for i, (op, alive) in enumerate(zip(block.ops, live_ops)):
            if not alive:
                findings.append(finding_for_op(
                    Severity.INFO, DEAD_OP,
                    "op output feeds no fetch, persistable, or control "
                    "flow; the executor computes it for nothing — if it "
                    "was meant to be observed, add it to fetch_list",
                    op=op, op_index=i, names=tuple(op.output_names()),
                ))

    # vars no op in ANY block reads or writes (and that are neither
    # feeds, persistables, nor fetches): construction leftovers
    touched = set()
    for blk in program.blocks:
        for op in blk.ops:
            touched.update(op.input_names())
            touched.update(op.output_names())
    touched.update(fetch_names)
    for blk in program.blocks:
        for name, v in blk.vars.items():
            if name in touched or v.persistable or v.is_data:
                continue
            findings.append(Finding(
                severity=Severity.INFO,
                category=UNREACHABLE_VAR,
                message=(
                    f"variable {name!r} is declared but no op reads or "
                    "writes it"
                ),
                block_idx=blk.idx,
                names=(name,),
            ))
    return findings
