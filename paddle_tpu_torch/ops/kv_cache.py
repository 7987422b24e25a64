"""KV-cache ops of the serving decode path (counterpart of
paddle_tpu/ops/kv_cache.py; used by serving/generate.py).

Generation keeps each transformer layer's key and value rows in
persistable scope variables and runs a single-token program per step:

* ``kv_cache_write`` writes the current step's K/V rows into the cache at
  a runtime position, in place: its Out is the cache variable, the same
  tensor, so the executor's write-back of persistables keeps it (the JAX
  package donates the cache to a dynamic-update-slice instead). The
  position stays on the device: no host-device sync per step.
* ``kv_cache_attention`` is masked decode attention in plain torch, as the
  JAX package computes it in jnp: Q for the current tokens against the
  whole cache, positions beyond ``Pos`` at -1e9, probabilities scaled by
  ``prob_scale``.

Neither op has a Pallas kernel in the JAX package, and neither is
differentiable: they exist only in inference programs.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


def _pos(pos):
    """Feeds arrive as [1] or [1, 1] tensors; the position as a 0-d int64
    tensor on their device."""
    return pos.reshape(()).long()


@register_op(
    "kv_cache_write",
    inputs=["Cache", "X", "Pos"],
    outputs=["Out"],
    differentiable=False,
    mutates=(("Out", "Cache"),),
)
def _kv_cache_write(ctx, op, ins):
    cache, x = ins["Cache"][0], ins["X"][0]
    rows = _pos(ins["Pos"][0]) + torch.arange(x.shape[1], device=x.device)
    return {"Out": [cache.index_copy_(1, rows, x.to(cache.dtype))]}


@register_op(
    "kv_cache_attention",
    inputs=["Q", "CacheK", "CacheV", "Pos"],
    outputs=["Out"],
    differentiable=False,
)
def _kv_cache_attention(ctx, op, ins):
    q, k, v = ins["Q"][0], ins["CacheK"][0], ins["CacheV"][0]
    pos = _pos(ins["Pos"][0])
    nh = int(op.attr("num_heads"))
    scale = float(op.attr("scale", 1.0))
    # test-mode residue of fluid's downgrade_in_infer attention dropout
    prob_scale = float(op.attr("prob_scale", 1.0))
    b, t, h = q.shape
    s = k.shape[1]
    dh = h // nh
    qh = q.reshape(b, t, nh, dh).transpose(1, 2)  # [B, nh, T, dh]
    kh = k.reshape(b, s, nh, dh).permute(0, 2, 3, 1)  # [B, nh, dh, S]
    scores = torch.matmul(qh, kh).float() * scale
    # Pos is the cache position of the LAST query row; query row i sits at
    # Pos - (T-1) + i and attends keys 0..that position
    qpos = pos - (t - 1) + torch.arange(t, device=q.device)
    valid = torch.arange(s, device=q.device)[None, :] <= qpos[:, None]
    scores = scores.masked_fill(~valid, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if prob_scale != 1.0:
        probs = probs * prob_scale
    vh = v.reshape(b, s, nh, dh).transpose(1, 2)  # [B, nh, S, dh]
    out = torch.matmul(probs, vh)  # [B, nh, T, dh]
    return {"Out": [out.transpose(1, 2).reshape(b, t, h)]}
