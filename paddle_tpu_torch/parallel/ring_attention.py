"""Sequence/context parallelism: ring attention and Ulysses (counterpart
of paddle_tpu/parallel/ring_attention.py).

The sequence axis of q, k, v [B, H, S, D] is sharded over a mesh axis
("sp"); each rank holds a local shard [B, H, S_local, D].

* Ring attention. Each rank keeps its query shard and the key/value
  shards travel the ring: at step t rank i holds the shard of rank
  (i + t) mod n, received from its right neighbour while it sends its
  own to the left. Step 0 is the diagonal shard; under a causal mask a
  shard wholly above the diagonal (source > i) is skipped with no
  launch. The forward merges shards in logsumexp form, so no [S, S]
  matrix ever exists. The backward, given the global lse and
  delta = rowsum(dO . out) (computed once, in fp32), accumulates dq on
  the resident shard while the dk/dv accumulators travel with k/v and
  take one final hop home: n transfers. Each step posts the next step's
  exchange before it launches its kernel.
* Ulysses. all_to_all from sequence-sharded to head-sharded, full local
  attention at offsets 0 (the same shard kernels), all_to_all back.

The per-shard blocks are kernels/ring_block.py's #12-#14 where they take
the shape (`ring_supports`: D in (32, 64, 128), fp32 or bf16, any
lengths); elsewhere its chunked plain versions, as the JAX package picks
its chunked-jnp backend. The choice reads shape and dtype only. The JAX
package's lane layout (packed [B, S, H*D] operands, an lse repeated over
each head's lanes) is a TPU artifact: the kernels take the strided
[B, H, S, D] views and the lse is fp32 [B, H, S].

The ring is written as generators (ring_fwd_steps, ring_bwd_steps) that
yield their exchanges: ("post", tensors) sends tensors to the left
neighbour and receives as many from the right, answering a token;
("wait", token) answers the received tensors. run_ring drives one over
an exchange; GroupExchange is the one over a mesh axis's process group
(dist.batch_isend_irecv). Ulysses uses dist.all_to_all_single.

The ring_attention and ulysses_attention ops keep the JAX package's
slots (Q, K, V -> Out), so a program pickled by either package loads in
the other. Their grad ops (ring_attention_grad, ulysses_attention_grad)
are dedicated: no collective runs inside a `__vjp__` replay. Without the
forward's lse in the op's slots, a grad op runs the forward ring again
(one more #12 per live shard) before the backward ring.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..errors import InvalidArgumentError
from ..framework.backward import dedicated_grad_maker
from ..framework.registry import register_op
from ..kernels.ring_block import (
    NEG_INF,
    add_shard_bwd_ref,
    ring_block_bwd,
    ring_block_fwd,
    ring_supports,
    shard_fwd_ref,
)


def _backends(q):
    """(forward, backward) per-shard functions for q's head dim and dtype:
    the kernel wrappers or the chunked plain versions."""
    if ring_supports(q.shape[3], q.dtype):
        return ring_block_fwd, ring_block_bwd
    return shard_fwd_ref, add_shard_bwd_ref


def _scale(scale, q):
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[3])


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------


class GroupExchange:
    """The ring's exchange over mesh axis `axis`: post(tensors) sends each
    to the left neighbour and receives as many from the right
    (dist.batch_isend_irecv on the axis's process group) and returns a
    token; wait(token) returns the received tensors. Every rank posts in
    the same order, so the i-th message from the right neighbour lands in
    the i-th receive."""

    def __init__(self, mesh, axis):
        n, idx = mesh.shape[axis], mesh.coordinate(axis)
        self.group = mesh.group(axis)
        self.left = mesh.global_rank(axis, (idx - 1) % n)
        self.right = mesh.global_rank(axis, (idx + 1) % n)
        self._pending = {}
        self._next = 0

    def post(self, tensors):
        sends = [t.contiguous() for t in tensors]
        bufs = [torch.empty_like(t) for t in sends]
        ops = ([dist.P2POp(dist.isend, t, self.left, self.group)
                for t in sends]
               + [dist.P2POp(dist.irecv, b, self.right, self.group)
                  for b in bufs])
        token, self._next = self._next, self._next + 1
        # the sends stay referenced until their transfer completes
        self._pending[token] = (bufs, dist.batch_isend_irecv(ops), sends)
        return token

    def wait(self, token):
        bufs, works, _ = self._pending.pop(token)
        for w in works:
            w.wait()
        return bufs


def run_ring(steps, exchange):
    """Run a ring generator (ring_fwd_steps / ring_bwd_steps) to its
    result, answering its exchanges with `exchange` (post / wait)."""
    try:
        kind, arg = next(steps)
        while True:
            answer = exchange.post(arg) if kind == "post" else \
                exchange.wait(arg)
            kind, arg = steps.send(answer)
    except StopIteration as done:
        return done.value


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def ring_fwd_steps(q, k, v, idx, n, causal, scale):
    """The ring forward of rank idx of n on its shards q, k, v
    [B, H, S_local, D]: yields its exchanges, returns (o fp32, lse fp32
    [B, H, S_local])."""
    fwd, _ = _backends(q)
    S = q.shape[2]
    pending = (yield "post", (k, v)) if n > 1 else None
    o, lse = fwd(q, k, v, idx * S, idx * S, causal, scale)  # the diagonal
    for t in range(1, n):
        kt, vt = yield "wait", pending
        if t < n - 1:
            pending = yield "post", (kt, vt)
        src = (idx + t) % n
        if causal and src > idx:
            continue  # wholly above the diagonal: contributes nothing
        o_s, l_s = fwd(q, kt, vt, idx * S, src * S, causal, scale)
        l_new = torch.logaddexp(lse, l_s)
        o = (o * torch.exp(lse - l_new)[..., None]
             + o_s * torch.exp(l_s - l_new)[..., None])
        lse = l_new
    return o, lse


def ring_bwd_steps(q, k, v, do, out, lse, idx, n, causal, scale):
    """The ring backward of rank idx of n from the forward's out and
    global lse: yields its exchanges, returns fp32 (dq, dk, dv) of its
    shards. dq accumulates here; the dk/dv accumulators travel with k/v
    and come home after the last step."""
    _, bwd = _backends(q)
    S = q.shape[2]
    delta = (do.float() * out.float()).sum(-1)  # once per backward, fp32
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    pending = (yield "post", (k, v)) if n > 1 else None
    bwd(q, k, v, do, lse, delta, idx * S, idx * S, causal, scale, dq, dk, dv)
    for t in range(1, n):
        acc = yield "post", (dk, dv)
        kt, vt = yield "wait", pending
        if t < n - 1:
            pending = yield "post", (kt, vt)
        dk, dv = yield "wait", acc
        src = (idx + t) % n
        if not (causal and src > idx):
            bwd(q, kt, vt, do, lse, delta, idx * S, src * S, causal, scale,
                dq, dk, dv)
    if n > 1:  # the accumulators sit one hop from home
        dk, dv = yield "wait", (yield "post", (dk, dv))
    return dq, dk, dv


def ring_attention(q, k, v, mesh, axis, causal=False, scale=None):
    """Ring attention of the local shards q, k, v [B, H, S_local, D] over
    mesh axis `axis` -> [B, H, S_local, D] in q's dtype."""
    n, idx = mesh.shape[axis], mesh.coordinate(axis)
    o, _ = run_ring(ring_fwd_steps(q, k, v, idx, n, causal, _scale(scale, q)),
                    GroupExchange(mesh, axis))
    return o.to(q.dtype)


def ring_attention_grads(q, k, v, d_out, mesh, axis, causal=False,
                         scale=None):
    """(dq, dk, dv) of ring_attention for the output gradient d_out, in
    the inputs' dtypes: the forward ring again (for out and the global
    lse), then the backward ring."""
    n, idx = mesh.shape[axis], mesh.coordinate(axis)
    scale = _scale(scale, q)
    ex = GroupExchange(mesh, axis)
    o, lse = run_ring(ring_fwd_steps(q, k, v, idx, n, causal, scale), ex)
    grads = run_ring(ring_bwd_steps(q, k, v, d_out, o.to(q.dtype), lse, idx,
                                    n, causal, scale), ex)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------


def _all_to_all(x, group, n, split_dim, concat_dim):
    """x split into n blocks along split_dim, block j to rank j; the
    blocks received from ranks 0..n-1 concatenated along concat_dim."""
    parts = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0)
    out = torch.empty_like(parts.contiguous())
    dist.all_to_all_single(out, parts.contiguous(), group=group)
    return torch.cat(out.unbind(0), concat_dim)


def _ulysses_io(mesh, axis, h):
    n = mesh.shape[axis]
    if h % n:
        raise InvalidArgumentError(
            f"ulysses: heads {h} not divisible by axis size {n}")
    group = mesh.group(axis)
    # [B, H, S/n, D] -> [B, H/n, S, D], and back
    return (lambda x: _all_to_all(x, group, n, 1, 2),
            lambda x: _all_to_all(x, group, n, 2, 1))


def ulysses_attention(q, k, v, mesh, axis, causal=False, scale=None):
    """Ulysses attention of the local shards q, k, v [B, H, S_local, D]
    over mesh axis `axis` (H divisible by its size) -> [B, H, S_local, D]
    in q's dtype."""
    to_heads, to_seq = _ulysses_io(mesh, axis, q.shape[1])
    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    fwd, _ = _backends(qh)
    o, _ = fwd(qh, kh, vh, 0, 0, causal, _scale(scale, q))
    return to_seq(o.to(q.dtype))


def ulysses_attention_grads(q, k, v, d_out, mesh, axis, causal=False,
                            scale=None):
    """(dq, dk, dv) of ulysses_attention for d_out, in the inputs'
    dtypes: the local forward again for out and lse, then #13/#14 at
    offsets 0."""
    to_heads, to_seq = _ulysses_io(mesh, axis, q.shape[1])
    scale = _scale(scale, q)
    qh, kh, vh, doh = (to_heads(t) for t in (q, k, v, d_out))
    fwd, bwd = _backends(qh)
    o, lse = fwd(qh, kh, vh, 0, 0, causal, scale)
    delta = (doh.float() * o.to(q.dtype).float()).sum(-1)
    grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for t in (qh, kh, vh)]
    bwd(qh, kh, vh, doh, lse, delta, 0, 0, causal, scale, *grads)
    return tuple(to_seq(g.to(t.dtype)) for g, t in zip(grads, (q, k, v)))


# ---------------------------------------------------------------------------
# op registrations (static graph)
# ---------------------------------------------------------------------------


def _attention_fallback(q, k, v, causal, scale):
    """Dense attention in fp32: the ops' answer without a mesh axis (the
    nranks == 1 degradation)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * _scale(scale, q)
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _op_args(op, ins):
    return (ins["Q"][0], ins["K"][0], ins["V"][0], op.attr("axis_name", "sp"),
            bool(op.attr("causal", False)), op.attr("scale", None))


def _register(op_type, fwd, grads):
    @register_op(op_type, inputs=["Q", "K", "V"], outputs=["Out"],
                 grad_maker=dedicated_grad_maker(op_type + "_grad",
                                                 ("Q", "K", "V")))
    def emit(ctx, op, ins):
        q, k, v, axis, causal, scale = _op_args(op, ins)
        if axis in ctx.mesh_axes:
            out = fwd(q, k, v, ctx.mesh, axis, causal, scale)
        else:
            out = _attention_fallback(q, k, v, causal, scale)
        return {"Out": [out]}

    @register_op(op_type + "_grad", inputs=["Q", "K", "V", "OutGrad"],
                 outputs=["QGrad", "KGrad", "VGrad"], differentiable=False)
    def emit_grad(ctx, op, ins):
        q, k, v, axis, causal, scale = _op_args(op, ins)
        g = ins["OutGrad"][0].to(q.dtype)
        if axis in ctx.mesh_axes:
            dq, dk, dv = grads(q, k, v, g, ctx.mesh, axis, causal, scale)
        else:
            _, vjp = torch.func.vjp(
                lambda q_, k_, v_: _attention_fallback(q_, k_, v_, causal,
                                                       scale), q, k, v)
            dq, dk, dv = vjp(g)
        return {slot: [t] for slot, t in (("QGrad", dq), ("KGrad", dk),
                                          ("VGrad", dv))
                if op.outputs.get(slot)}

    return emit, emit_grad


_register("ring_attention", ring_attention, ring_attention_grads)
_register("ulysses_attention", ulysses_attention, ulysses_attention_grads)
