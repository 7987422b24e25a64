"""Sparse / huge-embedding lookup ops (counterpart of
paddle_tpu/ops/sparse.py; reference operators/distributed_ops/
distributed_lookup_table_op.cc).

* ``distributed_lookup_table`` — one table: batch-dedup (a static-size
  unique) -> one gather of the unique rows -> scatter back by the unique
  inverse.
* ``fused_lookup_table`` — N same-width lookups in one op
  (``embedding.fuse_lookups`` builds these): the id tensors concatenate
  into one key space (table t's id i -> table_offset_t + i), the batch's
  keys dedup once across every slot, one gather against the
  row-concatenated tables serves all N lookups, and the inverse scatters
  each slot's rows back.

The backward is torch autograd through the generic ``__vjp__`` replay, as
the JAX package's is jax.vjp: the vjp of a gather by index is the
segment-sum scatter-add of the row gradients into their table.

Only the meshless path is ported. A lookup whose axis is a mesh axis of
the run (the JAX package's row- and column-sharded tables and the int8
gradient exchange) raises; it does not fall back to a local gather
(ROADMAP Queue 1 item 6).

No host-device synchronisation: the unique is static-shape torch code
(sort, first-occurrence mask, cumsum, scatter), so it runs on meta
tensors in shape inference and never reads a value back on the card.
"""

from __future__ import annotations

import torch

from .. import observability as _obs
from ..errors import InvalidArgumentError, UnimplementedError
from ..framework.registry import register_op


def _squeeze_ids(ids):
    """fluid id layout: a trailing [.., 1] dim is squeezed (ids [B, 1]
    gather to [B, D], not [B, 1, D])."""
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    return ids.long()


def static_unique(keys):
    """(unique, inverse) of a 1-D integer tensor of length N, both of
    length N, as ``jnp.unique(keys, size=N, fill_value=0,
    return_inverse=True)`` gives them: the distinct keys ascending, then
    0 up to length N; ``unique[inverse] == keys``. A stable sort, a
    first-occurrence mask, a cumsum for each key's rank among the
    distinct keys, the distinct keys scattered to their ranks in a
    zero-filled buffer, and the ranks scattered back through the sort's
    permutation: static shapes only, no host read."""
    n = keys.shape[0]
    srt, perm = torch.sort(keys, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    if n > 1:
        first = torch.cat([first[:1], srt[1:] != srt[:-1]])
    rank = torch.cumsum(first, 0) - 1
    # into fresh buffers in place (scatter would clone them first); every
    # member of a group writes the same key to its rank
    unique = torch.zeros_like(keys).scatter_(0, rank, srt)
    inverse = torch.empty_like(rank).scatter_(0, perm, rank)
    return unique, inverse


def _lookup_core(ctx, op, ids_list, tables):
    """Shared body of both lookup ops: dedup once over the concatenated
    id/key space, one gather against the row-concatenated tables, scatter
    back per slot. Returns one [ids_shape..., D] value per ids tensor."""
    axis = op.attr("axis_name", "ps")
    if axis in ctx.mesh_axes:
        raise UnimplementedError(
            f"{op.type} over mesh axis {axis!r}: sharded embedding tables "
            "(row and column partition, the int8 gradient exchange) are "
            "not ported yet (ROADMAP Queue 1 item 6); run the lookup "
            "without a mesh axis of that name"
        )
    dedup = bool(op.attr("dedup", True))

    ids_list = [_squeeze_ids(i) for i in ids_list]
    # slot -> table segment: fused slots sharing one table share ONE
    # key-space segment, so the same id in two slots dedups to one row
    slot_idx = op.attr("slot_table_idx")
    if slot_idx is None:
        if len(tables) == len(ids_list):
            slot_idx = list(range(len(ids_list)))
        elif len(tables) == 1:
            slot_idx = [0] * len(ids_list)
        else:
            raise InvalidArgumentError(
                f"{op.type}: {len(ids_list)} id slots over {len(tables)} "
                "tables needs a slot_table_idx attr"
            )
    dim = int(tables[0].shape[-1])
    offsets = [0]
    for w in tables[:-1]:
        offsets.append(offsets[-1] + int(w.shape[0]))

    flat_ids, spans = [], []
    start = 0
    for i, ids in enumerate(ids_list):
        f = ids.reshape(-1) + offsets[slot_idx[i]]
        flat_ids.append(f)
        spans.append((start, start + f.shape[0], tuple(ids.shape)))
        start += f.shape[0]
    keys = torch.cat(flat_ids) if len(flat_ids) > 1 else flat_ids[0]

    if dedup:
        unique, inverse = static_unique(keys)
    else:
        unique = keys
        inverse = torch.arange(keys.shape[0], device=keys.device)

    combined = torch.cat(tables, 0) if len(tables) > 1 else tables[0]
    rows = torch.index_select(
        combined, 0, unique.clamp(0, combined.shape[0] - 1))
    gathered = torch.index_select(rows, 0, inverse)
    return [gathered[s:e].reshape(shape + (dim,)) for s, e, shape in spans]


@register_op("distributed_lookup_table", inputs=["Ids", "W"], outputs=["Out"])
def _distributed_lookup_table(ctx, op, ins):
    (out,) = _lookup_core(ctx, op, [ins["Ids"][0]], [ins["W"][0]])
    return {"Out": [out]}


@register_op("fused_lookup_table", inputs=["Ids", "W"], outputs=["Out"])
def _fused_lookup_table(ctx, op, ins):
    tables = ins["W"]
    if ctx.first_run:
        # once per trace, as the JAX package counts when jit traces
        _obs.add("embedding.fused_lookup_sites")
        _obs.add("embedding.fused_lookup_tables", len(tables))
    return {"Out": _lookup_core(ctx, op, ins["Ids"], tables)}
