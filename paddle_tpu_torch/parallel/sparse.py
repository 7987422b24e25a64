"""Sparse-table bookkeeping (counterpart of paddle_tpu/parallel/sparse.py):
which ops are lookups and which tables they read. The JAX package's
``shard_sparse_tables`` (row and column partition over a mesh axis) and
``quantize_embedding_grads`` (the int8 gradient exchange) are ROADMAP
Queue 1 item 6; the port's lookups run meshless (ops/sparse.py).
"""

from __future__ import annotations

LOOKUP_OPS = ("distributed_lookup_table", "fused_lookup_table")


def _lookup_tables(op):
    """Table var names consumed by a (possibly fused) lookup op."""
    return [w for w in op.inputs.get("W", ()) if w]


def sparse_table_names(program):
    """Names of every table consumed by a lookup op (fused or single)."""
    names = []
    for blk in program.blocks:
        for op in blk.ops:
            if op.type in LOOKUP_OPS:
                for w in _lookup_tables(op):
                    if w not in names:
                        names.append(w)
    return names
