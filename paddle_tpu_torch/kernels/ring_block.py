"""Per-shard attention blocks of sequence parallelism (ring and Ulysses):
hand-written CUDA kernels and their plain PyTorch versions (counterpart
of paddle_tpu/kernels/ring_block.py).

Replaces: paddle_tpu/kernels/ring_block.py:_fwd_kernel (via `shard_fwd`,
#12), _dq_kernel (via `shard_dq`, #13) and _dkv_kernel (via `shard_dkv`,
#14), the Pallas kernels that parallel/ring_attention.py runs once per
live ring step (and Ulysses once, over the whole sequence, at offsets 0).

One call attends the resident query shard q [B, H, Sq, D] to one visiting
key/value shard k, v [B, H, Sk, D] at the shards' global causal offsets
(row0, col0), runtime integers: query i sees key j when
col0 + j <= row0 + i. No bias, no dropout (the SP ops expose neither).

  forward  (ring_block_fwd): the shard's normalised output o and its row
           logsumexp lse, both fp32 ([B, H, Sq, D], [B, H, Sq]); a row
           with no visible key gives o = 0 and lse = NEG_INF = -1e30, a
           finite stand-in for -inf that the caller's logsumexp merge
           weighs as nothing (with -inf, logaddexp(-inf, -inf) and
           exp(l - l_new) give NaN).
  backward (ring_block_bwd): given the GLOBAL lse of the whole ring and
           delta = rowsum(dO . out) (fp32 [B, H, Sq]), dq of the query
           shard (#13) and dk, dv of the visiting shard (#14), ADDED into
           the caller's fp32 accumulators: dq stays on the resident shard,
           dk and dv travel the ring with k and v.

The JAX package packs heads into 128-lane rows ([B, S, H*D]) and repeats
each head's lse over its D lanes, a TPU layout; here q, k, v and dO are
[B, H, S, D] views read through their strides, and the lse is the compact
fp32 [B, H, Sq] (the JAX package's `_slim_lse` form).

What bounds it on the H100: at B=1, H=12, S=8192, D=64, causal, offsets
(0, 0) (the SP path's one-rank ring), 4*D flops for each of 4.03e8 live
pairs forward and 8*D backward, against a few MB: operations. The kernels
(csrc/ring_block.cu) skip tiles wholly above the causal diagonal in
global coordinates, and add into the accumulators instead of writing a
contribution the caller would add in another pass. All three run their
products on the tensor cores (csrc/mma_tiles.cuh) as 3xTF32 (`tf32_split`
below: each fp32 operand is hi + lo, both TF32, and a product is
lo*hi + hi*lo + hi*hi, within about 2^-21 of fp32's), their tiles fed by
cp.async; the forward (#12) on the body it shares with the whole-row
forward #1/#5 (csrc/attn_mma.cuh's fwd_mma_block), with the ring's
liveness at the offsets.

Dispatch: a CUDA tensor goes to the kernels, or raises if they do not
take it (`ring_supports`); a CPU tensor goes to the plain version. The
caller (parallel/ring_attention.py) picks the kernels or the plain
versions by `ring_supports`, a rule of head dim and dtype alone.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import InvalidArgumentError
from . import _build

NEG_INF = -1e30
# head dims the kernels are instantiated for, and the input dtypes
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# keys per block of the plain versions: a [Sq, KV_CHUNK] score block at
# most (the JAX package's _KV_CHUNK)
KV_CHUNK = 1024


def ring_supports(head_dim, dtype):
    """True when the kernels take a shard of this head dim and dtype
    (any sequence lengths: their tiles check their bounds)."""
    return head_dim in HEAD_DIMS and dtype in DTYPES


def _visible(Sq, k0, k1, row0, col0, device):
    """[Sq, k1 - k0] bool: which of keys k0..k1 each query sees."""
    rows = row0 + torch.arange(Sq, device=device)[:, None]
    cols = col0 + torch.arange(k0, k1, device=device)[None, :]
    return cols <= rows


def _chunks(Sk):
    return [(k0, min(k0 + KV_CHUNK, Sk)) for k0 in range(0, Sk, KV_CHUNK)]


def shard_fwd_ref(q, k, v, row0, col0, causal, scale):
    """The plain forward of #12: an online softmax over key blocks of
    KV_CHUNK in fp32 -> (o fp32 [B, H, Sq, D], lse fp32 [B, H, Sq]), a
    row with no visible key at o = 0, lse = NEG_INF."""
    qf = q.float()
    B, H, Sq, D = q.shape
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, D), device=q.device)
    for k0, k1 in _chunks(k.shape[2]):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k[:, :, k0:k1].float())
        s = s * scale
        if causal:
            vis = _visible(Sq, k0, k1, row0, col0, q.device)
            s = s.masked_fill(~vis, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        e = torch.exp(s - m_new)
        if causal:  # a wholly masked row has m_new == NEG_INF, e == 1
            e = e.masked_fill(~vis, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", e,
                                         v[:, :, k0:k1].float())
        m = m_new
    some = l > 0
    o = torch.where(some, acc / torch.where(some, l, 1.0), 0.0)
    lse = torch.where(some, m + torch.log(torch.where(some, l, 1.0)),
                      NEG_INF)
    return o, lse.squeeze(-1)


def _bwd_blocks(q, k, v, do, lse, delta, row0, col0, causal, scale):
    """(k0, k1, p, dS) of each key block, from the global lse and delta."""
    qf, dof = q.float(), do.float()
    lse4, delta4 = lse[..., None], delta[..., None]
    Sq = q.shape[2]
    for k0, k1 in _chunks(k.shape[2]):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k[:, :, k0:k1].float())
        p = torch.exp(s * scale - lse4)
        if causal:
            p = p.masked_fill(~_visible(Sq, k0, k1, row0, col0, q.device),
                              0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, v[:, :, k0:k1].float())
        yield k0, k1, p, p * (dp - delta4)


def shard_dq_ref(q, k, v, do, lse, delta, row0, col0, causal, scale):
    """The plain #13: dq fp32 [B, H, Sq, D] of the query shard against
    one visiting shard, from the global lse and delta [B, H, Sq]."""
    dq = torch.zeros(q.shape, device=q.device)
    for k0, k1, _, ds in _bwd_blocks(q, k, v, do, lse, delta, row0, col0,
                                     causal, scale):
        dq += torch.einsum("bhqk,bhkd->bhqd", ds,
                           k[:, :, k0:k1].float()) * scale
    return dq


def shard_dkv_ref(q, k, v, do, lse, delta, row0, col0, causal, scale):
    """The plain #14: (dk, dv) fp32 [B, H, Sk, D] of the visiting shard
    from this query shard, from the global lse and delta."""
    qf, dof = q.float(), do.float()
    dk, dv = [], []
    for _, _, p, ds in _bwd_blocks(q, k, v, do, lse, delta, row0, col0,
                                   causal, scale):
        dk.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale)
        dv.append(torch.einsum("bhqk,bhqd->bhkd", p, dof))
    return torch.cat(dk, 2), torch.cat(dv, 2)


def add_shard_bwd_ref(q, k, v, do, lse, delta, row0, col0, causal, scale,
                      dq, dk, dv):
    """The plain #13 and #14 added into the accumulators dq, dk, dv, as
    ring_block_bwd adds; returns (dq, dk, dv)."""
    args = (row0, col0, causal, scale)
    dq += shard_dq_ref(q, k, v, do, lse, delta, *args)
    dk_c, dv_c = shard_dkv_ref(q, k, v, do, lse, delta, *args)
    dk += dk_c
    dv += dv_c
    return dq, dk, dv


def tf32_round(x):
    """fp32 x rounded onto TF32's 10 mantissa bits, to nearest with ties
    away from zero, as the card's cvt.rna.tf32.f32 rounds: integer
    operations on the fp32 bits (add half a unit of the 13 dropped bits,
    clear them). A value past TF32's largest rounds to infinity; inf and
    NaN pass through. The plain model of the kernels' split, for
    tests."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    rounded = (bits + 0x1000) & -0x2000  # -0x2000: 0xFFFFE000
    return torch.where(finite, rounded, bits).view(torch.float32)


def tf32_split(x):
    """(hi, lo), both TF32, with hi + lo = x within 2^-22 |x|: the split
    of each fp32 operand of the kernels' 3xTF32 products."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def _check(q, k, v, who, do=None):
    """The kernels' input checks on a CUDA tensor."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0:2] != q.shape[0:2] or k.shape[3] != q.shape[3] \
            or (do is not None and do.shape != q.shape):
        raise InvalidArgumentError(
            f"{who}: q (and dO) must be [B, H, Sq, D] and k, v [B, H, Sk, D] "
            f"of the same B, H, D; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    ts = (q, k, v) if do is None else (q, k, v, do)
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise InvalidArgumentError(
            f"{who}: unsupported devices {[str(t.device) for t in ts]}")
    if any(t.dtype != q.dtype for t in ts) or not ring_supports(
            q.shape[3], q.dtype):
        raise InvalidArgumentError(
            f"{who}: the kernels take fp32 or bf16 q, k, v (and dO) of one "
            f"dtype with head dim in {HEAD_DIMS}; got "
            f"{[t.dtype for t in ts]}, D={q.shape[3]}")
    # views with a contiguous last dim are read in place; k and v share
    # their strides
    if not (k.stride() == v.stride() and k.stride(3) == 1):
        k, v = k.contiguous(), v.contiguous()
    q = q if q.stride(3) == 1 else q.contiguous()
    if do is None:
        return q, k, v
    return q, k, v, (do if do.stride(3) == 1 else do.contiguous())


def _strides(q, kv, do):
    vals = [s for t in (q, kv, do) for s in t.stride()[:3]]
    return (ctypes.c_longlong * 9)(*vals)


def _stats(t, shape, who, name):
    if (tuple(t.shape) != shape or t.dtype != torch.float32
            or not t.is_contiguous()):
        raise InvalidArgumentError(
            f"{who}: {name} must be a contiguous fp32 {shape}, got "
            f"{tuple(t.shape)} {t.dtype}, strides {t.stride()}")


def ring_block_fwd(q, k, v, row0, col0, causal, scale):
    """(o fp32 [B, H, Sq, D], lse fp32 [B, H, Sq]) of the query shard q
    against the visiting shard k, v at global offsets (row0, col0) (#12).
    The kernel takes fp32 or bf16 [B, H, S, D] views with a contiguous
    last dim and D in HEAD_DIMS, any Sq and Sk."""
    row0, col0 = int(row0), int(col0)
    if q.device.type == "cpu":
        return shard_fwd_ref(q, k, v, row0, col0, causal, scale)
    q, k, v = _check(q, k, v, "ring_block_fwd")
    B, H, Sq, D = q.shape
    o = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _bind().ring_block_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, Sq, k.shape[2], D, row0, col0,
        _strides(q, k, q), float(scale), int(bool(causal)),
        DTYPES.index(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"ring_block_fwd launch failed: CUDA error {err}")
    ring_block_fwd.launches += 1
    return o, lse


ring_block_fwd.launches = 0


def ring_block_bwd(q, k, v, do, lse, delta, row0, col0, causal, scale,
                   dq, dk, dv):
    """Add the query shard's dq (#13) and the visiting shard's dk, dv
    (#14) against k, v at offsets (row0, col0) into the fp32 accumulators
    dq [B, H, Sq, D] and dk, dv [B, H, Sk, D] (contiguous), from the
    global lse and delta = rowsum(dO . out), fp32 [B, H, Sq]. dO: the
    output gradient [B, H, Sq, D] in q's dtype. Returns (dq, dk, dv)."""
    row0, col0 = int(row0), int(col0)
    if q.device.type == "cpu":
        return add_shard_bwd_ref(q, k, v, do, lse, delta, row0, col0, causal,
                                 scale, dq, dk, dv)
    q, k, v, do = _check(q, k, v, "ring_block_bwd", do)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    who = "ring_block_bwd"
    _stats(lse, (B, H, Sq), who, "lse")
    _stats(delta, (B, H, Sq), who, "delta")
    _stats(dq, (B, H, Sq, D), who, "dq")
    _stats(dk, (B, H, Sk, D), who, "dk")
    _stats(dv, (B, H, Sk, D), who, "dv")
    lib = _bind()
    ops = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    tail = (B, H, Sq, Sk, D, row0, col0, _strides(q, k, do), float(scale),
            int(bool(causal)), DTYPES.index(q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)
    err = lib.ring_block_bwd_dq(*ops, dq.data_ptr(), *tail)
    if err:
        raise RuntimeError(
            f"ring_block_bwd_dq launch failed: CUDA error {err}")
    ring_block_bwd.launches_dq += 1
    err = lib.ring_block_bwd_dkv(*ops, dk.data_ptr(), dv.data_ptr(), *tail)
    if err:
        raise RuntimeError(
            f"ring_block_bwd_dkv launch failed: CUDA error {err}")
    ring_block_bwd.launches_dkv += 1
    return dq, dk, dv


ring_block_bwd.launches_dq = 0
ring_block_bwd.launches_dkv = 0


def _bind():
    lib = _build.load("ring_block")
    if lib.ring_block_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        st = ctypes.POINTER(ctypes.c_longlong)
        tail = [i] * 7 + [st, f, i, i, p]
        lib.ring_block_fwd.argtypes = [p] * 5 + tail
        lib.ring_block_bwd_dq.argtypes = [p] * 7 + tail
        lib.ring_block_bwd_dkv.argtypes = [p] * 8 + tail
        for fn in (lib.ring_block_fwd, lib.ring_block_bwd_dq,
                   lib.ring_block_bwd_dkv):
            fn.restype = ctypes.c_int
    return lib
