"""Whole-row attention, forward and backward, on the packed projection
and on the 4-D [B, H, S, D] layout: hand-written CUDA kernels and their
plain PyTorch versions (counterpart of paddle_tpu/kernels/flash_attention.py).

Replaces: paddle_tpu/kernels/flash_attention.py:_fwd_kernel_qkv (via
`_pallas_fwd_qkv`, #1) and _bwd_kernel_qkv (via `_pallas_bwd_qkv`, #3),
the Pallas kernels behind `fused_attention_qkv` and
`attention_grads_qkv`; and _fwd_kernel (via `_pallas_fwd`, #5) and
_bwd_kernel (via `_pallas_bwd`, #6), the kernels behind
`fused_attention` and `attention_grads` (the fused_multihead_attention
op).

Computes, per batch and head: softmax(q k^T * scale + key_bias) v, with
key_bias an additive fp32 [B, S], causal masking at NEG_INF, and fluid's
dropout on the probabilities: in training the Philox keep mask of
prng_mask.py (keyed by the op's two seed words, the batch, head, query
and key), kept values scaled by 1/(1-p) under `upscale_in_train`; in test
mode a scale of 1-p under `downgrade_in_infer`. The packed wrappers take
qkv [B, S, 3*H*D] (section i in {q, k, v}, head h at columns
i*H*D + h*D) -> [B, S, H*D]; the 4-D wrappers take separate q, k, v
[B, H, S, D] -> [B, H, S, D]. The backwards give dqkv (or dq, dk, dv)
and, when asked, dbias [B, S], the sum of dS over heads and query rows.

What bounds it on the H100: at BERT shapes (S=128..512, D=64) each
query row and head does 4*S*D flops forward (about 9*S*D backward)
against 12*D input bytes, ~S/3 flop per byte, so the kernels are bound
by operations. The kernels (csrc/flash_attention.cu) keep every [S, S]
tile out of device memory, and every kernel runs its products on the
tensor cores (csrc/mma_tiles.cuh: mma.sync TF32 in a 3xTF32 split, so
the products hold fp32's accuracy): the forward streams key tiles
through shared memory with an online softmax in registers, on the body
it shares with the ring-block forward #12 (csrc/attn_mma.cuh's
fwd_mma_block); the backward splits into a per-query-tile kernel (row
statistics, delta, dq) and a per-key-tile kernel (dk, dv, per-head dbias
partials), on bodies the KV-tiled pair shares (csrc/attn_mma.cuh). Both
layouts launch the same three kernels, which read q, k and v as
[B, H, S, D] views through their strides: the packed projection is the
view whose k and v sections lie H*D and 2*H*D columns on, so it is read
in place and dq, dk and dv land in one packed dqkv; the head-split views
of a projection (#5's usual operands) need no copy either. The mask is
regenerated from its coordinates in every kernel, never stored.

Dispatch reads only shapes and dtypes (`route`), never the device, so a
program built before its device is known takes the same branch on the
card and on the CPU, and answers every shape the JAX package answers:
- fp32 or bf16 with a head dim D in HEAD_DIMS: the whole-row kernels up
  to MAX_SEQ = 1024, the KV-tiled kernels of flash_tiled.py (#7-#9)
  past it, which also save the row logsumexp (uses_tiled_path: the
  packed op hands its saved Out and Lse to the grad op);
- D % 8 == 0 and D < 128 outside HEAD_DIMS (heads the JAX package's
  kernel takes): q, k, v (and dO) zero-padded to the next width in
  HEAD_DIMS, the scale taken from the true D, the kernels run, the
  output sliced back. Exact: zero columns add nothing to q k^T, and v's
  are dropped. The pads and slices are copies the card pays for;
- fp16, D % 8 != 0 or D > 128, where the JAX package itself runs no
  kernel (its jnp `_reference`): the plain version, on every device,
  launching nothing.
Then a CUDA tensor goes to the kernels, or raises if it is malformed; a
CPU tensor goes to the plain version of the routed kernels; a meta
tensor (shape inference) gets an empty output of the right shape.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..core.dtypes import to_torch_dtype
from ..errors import InvalidArgumentError
from . import _build
from .prng_mask import drop_scale, keep_mask, mask_args
from .sum_partials import sum_partials

NEG_INF = -1e30
# head dims the kernels are instantiated for (BertConfig.tiny: 32, base: 64)
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# the JAX package's whole-row cap (paddle_tpu/kernels/flash_attention.py):
# longer sequences take the KV-tiled kernels
MAX_SEQ = 1024


def _kernel_kind(head_dim, dtype):
    dtype = to_torch_dtype(dtype) if isinstance(dtype, str) else dtype
    return head_dim in HEAD_DIMS and dtype in DTYPES


def kernel_width(head_dim):
    """The head width the kernels run a head of `head_dim` at: itself in
    HEAD_DIMS, else the next width of HEAD_DIMS above it when head_dim is
    a multiple of 8 (zero-padded), else None (no kernel)."""
    if head_dim % 8:
        return None
    return next((w for w in HEAD_DIMS if head_dim <= w), None)


def route(seq_len, head_dim, dtype):
    """Which kernels attention of these static properties runs: "whole"
    (#1/#3 packed, #5/#6 4-D) up to MAX_SEQ, "tiled" (#7-#9) past it, or
    None: the plain version on every device (fp16, D % 8 != 0, D > 128),
    as the JAX package computes its jnp reference there."""
    dtype = to_torch_dtype(dtype) if isinstance(dtype, str) else dtype
    if dtype not in DTYPES or kernel_width(head_dim) is None:
        return None
    return "tiled" if seq_len > MAX_SEQ else "whole"


def supports_packed(seq_len, num_heads, head_dim, dtype):
    """True when fused_attention_qkv takes the whole-row kernels (#1, #3)
    for these static properties."""
    return seq_len <= MAX_SEQ and _kernel_kind(head_dim, dtype)


def uses_tiled_path(seq_len, num_heads, head_dim, dtype):
    """True when fused_attention_qkv dispatches the KV-tiled kernels (#7-#9)
    for these static properties. The op builder uses it at graph-build
    time to wire the forward's saved (Out, Lse) into the grad op
    (ops/fused.py), so it must mirror the dispatch below; it reads no
    device, so the CPU's plain versions take the same branch."""
    return seq_len > MAX_SEQ and _kernel_kind(head_dim, dtype)


def _split_heads(t, H):
    """The [B, H, S, D] view of t [B, S, H*D] (rows t.stride(1) apart)."""
    return t.unflatten(-1, (H, -1)).transpose(1, 2)


def _head_views(qkv, H):
    """(q, k, v): the [B, H, S, D] views of the packed projection's
    sections, which share their strides."""
    heads = _split_heads(qkv, 3 * H)
    return heads[:, :H], heads[:, H:2 * H], heads[:, 2 * H:]


def _heads(qkv, H):
    """(q, k, v) as fp32 [B, H, S, D] of the packed projection."""
    return tuple(t.float() for t in _head_views(qkv, H))


def _probs(q, k, key_bias, scale, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if causal:
        S = s.shape[-1]
        keep = torch.ones(S, S, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return torch.softmax(s, dim=-1)


def _mask(q, rate, is_test, seed):
    """The keep mask [B, H, S, S] in training, else None."""
    if rate == 0.0 or is_test:
        return None
    B, H, S, _ = q.shape
    return keep_mask(seed, rate, S, S, lead=(B, H), device=q.device)


def _attend(q, k, v, key_bias, scale, dropout_rate, is_test, upscale,
            causal, seed):
    """fp32 [B, H, S, D] attention of fp32 heads [B, H, S, D]: the
    arithmetic every plain version shares."""
    p = _probs(q, k, key_bias, scale, causal)
    p = p * drop_scale(dropout_rate, is_test, upscale)
    keep = _mask(q, dropout_rate, is_test, seed)
    if keep is not None:
        p = p * keep
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _attend_bwd(q, k, v, key_bias, do, scale, dropout_rate, is_test,
                upscale, causal, seed):
    """(dq, dk, dv fp32 [B, H, S, D], dbias fp32 [B, S]) of _attend for the
    fp32 output gradient do, in the formulas of the JAX package's
    `_head_bwd`."""
    p = _probs(q, k, key_bias, scale, causal)
    ds_ = drop_scale(dropout_rate, is_test, upscale)
    keep = _mask(q, dropout_rate, is_test, seed)
    w = ds_ if keep is None else keep * ds_  # multiplier of p and dp
    pm = p * w
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v) * w
    dv = torch.einsum("bhqk,bhqd->bhkd", pm, do)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return dq, dk, dv, ds.sum(dim=(1, 2))


def reference_qkv(qkv, num_heads, key_bias=None, *, scale, dropout_rate=0.0,
                  is_test=True, upscale=False, causal=False, seed=None):
    """The plain version: the same function in PyTorch ops, in fp32, with
    the output cast back to qkv's dtype (as the JAX package's
    `_reference` does), and the kernels' Philox mask in training."""
    mask_args(dropout_rate, is_test, seed, "reference_qkv")
    B, S, _ = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    out = _attend(q, k, v, key_bias, scale, dropout_rate, is_test, upscale,
                  causal, seed)
    return out.transpose(1, 2).reshape(B, S, -1).to(qkv.dtype)


def reference_qkv_bwd(qkv, num_heads, key_bias, d_out, *, scale,
                      dropout_rate=0.0, is_test=True, upscale=False,
                      causal=False, seed=None):
    """The plain backward, in the formulas of the JAX package's
    `_head_bwd`: (dqkv in qkv's dtype, dbias fp32 [B, S])."""
    mask_args(dropout_rate, is_test, seed, "reference_qkv_bwd")
    B, S, _ = qkv.shape
    H = num_heads
    q, k, v = _heads(qkv, H)
    do = d_out.reshape(B, S, H, -1).transpose(1, 2).float()
    dq, dk, dv, dbias = _attend_bwd(q, k, v, key_bias, do, scale,
                                    dropout_rate, is_test, upscale, causal,
                                    seed)
    dqkv = torch.cat([t.transpose(1, 2).reshape(B, S, -1)
                      for t in (dq, dk, dv)], dim=-1)
    return dqkv.to(qkv.dtype), dbias


def reference(q, k, v, key_bias=None, *, scale, dropout_rate=0.0,
              is_test=True, upscale=False, causal=False, seed=None):
    """The plain version of #5: attention on [B, H, S, D] q, k and v in
    fp32, the output cast back to q's dtype (the JAX package's
    `_reference`), the kernels' Philox mask in training."""
    mask_args(dropout_rate, is_test, seed, "reference")
    out = _attend(q.float(), k.float(), v.float(), key_bias, scale,
                  dropout_rate, is_test, upscale, causal, seed)
    return out.to(q.dtype)


def reference_bwd(q, k, v, key_bias, d_out, *, scale, dropout_rate=0.0,
                  is_test=True, upscale=False, causal=False, seed=None):
    """The plain version of #6: (dq, dk, dv in q's dtype, dbias fp32
    [B, S], the sum of dS over heads and query rows)."""
    mask_args(dropout_rate, is_test, seed, "reference_bwd")
    dq, dk, dv, dbias = _attend_bwd(q.float(), k.float(), v.float(),
                                    key_bias, d_out.float(), scale,
                                    dropout_rate, is_test, upscale, causal,
                                    seed)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dbias


def _check(qkv, num_heads, key_bias, who):
    """(B, S, D, fp32 bias or None) after the kernels' input checks."""
    B, S, three_hd = qkv.shape
    D = three_hd // 3 // num_heads
    if qkv.device.type != "cuda":
        raise InvalidArgumentError(f"{who}: unsupported device {qkv.device}")
    if qkv.dtype not in DTYPES or D not in HEAD_DIMS or qkv.stride(2) != 1:
        raise InvalidArgumentError(
            f"{who}: the kernels take fp32/bf16 qkv with a contiguous last "
            f"dim and head dim in {HEAD_DIMS}; got {qkv.dtype}, D={D}, "
            f"strides {qkv.stride()}"
        )
    bias = None
    if key_bias is not None:
        bias = key_bias.float().contiguous()
        if bias.device != qkv.device or tuple(bias.shape) != (B, S):
            raise InvalidArgumentError(
                f"{who}: key_bias must be [B, S] = {(B, S)} on {qkv.device}, "
                f"got {tuple(bias.shape)} on {bias.device}"
            )
    return B, S, D, bias


def _shape(qkv, num_heads, who):
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise InvalidArgumentError(
            f"{who}: qkv must be [B, S, 3*H*D] with H={num_heads}, got "
            f"{tuple(qkv.shape)}"
        )
    D = qkv.shape[2] // 3 // num_heads
    return D


def _tiled_kw(scale, dropout_rate, is_test, dropout_implementation,
              causal):
    return dict(scale=scale, rate=float(dropout_rate), is_test=bool(is_test),
                upscale=dropout_implementation == "upscale_in_train",
                causal=bool(causal))


def fused_attention_qkv(qkv, num_heads, key_bias=None, *, scale=None,
                        dropout_rate=0.0, is_test=True,
                        dropout_implementation="downgrade_in_infer",
                        causal=False, seed=None, return_lse=False):
    """Attention over a packed qkv projection [B, S, 3*H*D] -> [B, S, H*D].

    The kernels take: fp32 or bf16 qkv on a CUDA device with a contiguous
    last dim, H*D*3 columns with D in HEAD_DIMS, and any S. Training
    dropout (rate > 0, not is_test) needs `seed`, the op's two seed words
    (registry.EmitContext.seed_words), on every device. With return_lse
    the result is (out, lse): lse fp32 [B, H, S] on the tiled path, else
    None."""
    D = _shape(qkv, num_heads, "fused_attention_qkv")
    B, S, _ = qkv.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if uses_tiled_path(S, num_heads, D, qkv.dtype):
        from .flash_tiled import flash_tiled_fwd

        out, lse = flash_tiled_fwd(
            qkv, key_bias, seed, num_heads, D,
            **_tiled_kw(scale, dropout_rate, is_test, dropout_implementation,
                        causal))
        return (out, lse) if return_lse else out
    if _padded_route(S, D, qkv.dtype):
        # a head the kernels take zero-padded: the 4-D wrappers on the
        # projection's head views (their counters)
        out = _pack4(fused_attention(
            *_head_views(qkv, num_heads), key_bias, scale=scale,
            dropout_rate=dropout_rate, is_test=is_test,
            dropout_implementation=dropout_implementation, causal=causal,
            seed=seed))
        return (out, None) if return_lse else out
    out = _whole_row_fwd(qkv, num_heads, key_bias, D, scale, dropout_rate,
                         is_test, dropout_implementation, causal, seed)
    return (out, None) if return_lse else out


def _whole_row_fwd(qkv, num_heads, key_bias, D, scale, dropout_rate, is_test,
                   dropout_implementation, causal, seed):
    B, S, _ = qkv.shape
    upscale = dropout_implementation == "upscale_in_train"
    if qkv.device.type == "meta":
        return torch.empty((B, S, num_heads * D), dtype=qkv.dtype,
                           device=qkv.device)
    mask = mask_args(dropout_rate, is_test, seed, "fused_attention_qkv")
    if qkv.device.type == "cpu" or route(S, D, qkv.dtype) is None:
        return reference_qkv(qkv, num_heads, key_bias, scale=scale,
                             dropout_rate=dropout_rate, is_test=is_test,
                             upscale=upscale, causal=causal, seed=seed)
    B, S, D, bias = _check(qkv, num_heads, key_bias, "fused_attention_qkv")
    out = torch.empty((B, S, num_heads * D), dtype=qkv.dtype,
                      device=qkv.device)
    _launch_fwd(*_head_views(qkv, num_heads), bias,
                _split_heads(out, num_heads), scale,
                drop_scale(dropout_rate, is_test, upscale), causal,
                mask)
    fused_attention_qkv.launches += 1
    return out


fused_attention_qkv.launches = 0


def fused_attention_qkv_bwd(qkv, num_heads, key_bias, d_out, *, scale=None,
                            dropout_rate=0.0, is_test=True,
                            dropout_implementation="downgrade_in_infer",
                            causal=False, seed=None, want_dbias=False,
                            saved_out=None, saved_lse=None):
    """(dqkv [B, S, 3*H*D], dbias fp32 [B, S] or None) of
    fused_attention_qkv for the output gradient d_out [B, S, H*D], with
    the forward's mask regenerated from the same seed words. The kernels
    take what the forward kernel takes, and d_out of qkv's dtype with a
    contiguous last dim. dbias is computed only when want_dbias. On the
    tiled path the backward kernels read the forward's saved output and
    lse (fused_attention_qkv(return_lse=True)); without them the forward
    runs again first."""
    D = _shape(qkv, num_heads, "fused_attention_qkv_bwd")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    B, S, _ = qkv.shape
    if uses_tiled_path(S, num_heads, D, qkv.dtype):
        from .flash_tiled import flash_tiled_bwd, flash_tiled_fwd

        kw = _tiled_kw(scale, dropout_rate, is_test, dropout_implementation,
                       causal)
        if saved_out is None or saved_lse is None:
            saved_out, saved_lse = flash_tiled_fwd(qkv, key_bias, seed,
                                                   num_heads, D, **kw)
        return flash_tiled_bwd(qkv, key_bias, seed, d_out, saved_out,
                               saved_lse, num_heads, D,
                               want_dbias=want_dbias, **kw)
    if _padded_route(S, D, qkv.dtype):
        dq, dk, dv, dbias = attention_grads(
            *_head_views(qkv, num_heads), key_bias,
            _split_heads(d_out, num_heads), scale=scale,
            dropout_rate=dropout_rate, is_test=is_test,
            dropout_implementation=dropout_implementation, causal=causal,
            seed=seed, want_dbias=want_dbias)
        return torch.cat([_pack4(t) for t in (dq, dk, dv)], -1), dbias
    upscale = dropout_implementation == "upscale_in_train"
    mask = mask_args(dropout_rate, is_test, seed, "fused_attention_qkv_bwd")
    if qkv.device.type == "cpu" or route(S, D, qkv.dtype) is None:
        dqkv, dbias = reference_qkv_bwd(
            qkv, num_heads, key_bias, d_out, scale=scale,
            dropout_rate=dropout_rate, is_test=is_test, upscale=upscale,
            causal=causal, seed=seed,
        )
        return dqkv, (dbias if want_dbias else None)
    B, S, D, bias = _check(qkv, num_heads, key_bias,
                           "fused_attention_qkv_bwd")
    H = num_heads
    if (tuple(d_out.shape) != (B, S, H * D) or d_out.dtype != qkv.dtype
            or d_out.device != qkv.device or d_out.stride(2) != 1):
        raise InvalidArgumentError(
            f"fused_attention_qkv_bwd: d_out must be [B, S, H*D] = "
            f"{(B, S, H * D)} of {qkv.dtype} on {qkv.device} with a "
            f"contiguous last dim; got {tuple(d_out.shape)} {d_out.dtype} "
            f"on {d_out.device}"
        )
    dqkv = torch.empty((B, S, 3 * H * D), dtype=qkv.dtype, device=qkv.device)
    dbias = _launch_bwd(
        *_head_views(qkv, H), bias, _split_heads(d_out, H),
        _head_views(dqkv, H), want_dbias, scale,
        drop_scale(dropout_rate, is_test, upscale), causal,
        mask, fused_attention_qkv_bwd)
    return dqkv, dbias


fused_attention_qkv_bwd.launches_dq = 0
fused_attention_qkv_bwd.launches_dkv = 0


class FlashQKV(torch.autograd.Function):
    """Differentiable fused_attention_qkv (counterpart of the JAX
    package's `_flash_qkv` and `flash_tiled_outs` custom_vjps): the
    backward calls the same backward kernels, with the forward's seed
    words, so it regenerates the forward's mask; on the tiled path it
    reads the forward's saved output and lse. The static graph uses the
    dedicated fused_qkv_attention_grad op instead (ops/fused.py)."""

    @staticmethod
    def forward(ctx, qkv, key_bias, num_heads, kw):
        out, lse = fused_attention_qkv(qkv, num_heads, key_bias,
                                       return_lse=True, **kw)
        ctx.save_for_backward(qkv, key_bias, out, lse)
        ctx.num_heads, ctx.kw = num_heads, kw
        return out

    @staticmethod
    def backward(ctx, d_out):
        qkv, key_bias, out, lse = ctx.saved_tensors
        want_dbias = key_bias is not None and ctx.needs_input_grad[1]
        dqkv, dbias = fused_attention_qkv_bwd(
            qkv, ctx.num_heads, key_bias, d_out.contiguous(),
            want_dbias=want_dbias, saved_out=out, saved_lse=lse, **ctx.kw,
        )
        if dbias is not None:
            dbias = dbias.to(key_bias.dtype)
        return dqkv, dbias, None, None


def flash_qkv(qkv, num_heads, key_bias=None, **kw):
    """fused_attention_qkv through FlashQKV (autograd-aware)."""
    return FlashQKV.apply(qkv, key_bias, num_heads, kw)


# ---------------------------------------------------------------------------
# [B, H, S, D]: separate q, k and v (#5, #6)
# ---------------------------------------------------------------------------


def supports(seq_len, head_dim, dtype):
    """True when fused_attention and attention_grads take the kernels (#5,
    #6) as they are for these static properties (the JAX package's
    `supports`: the whole-row cap of MAX_SEQ; the port's HEAD_DIMS; fp32
    or bf16). The other shapes go where `route` sends them."""
    return seq_len <= MAX_SEQ and _kernel_kind(head_dim, dtype)


def _padded_route(seq_len, head_dim, dtype):
    """True when the kernels take these heads only zero-padded: the
    packed wrappers then go through the 4-D ones, which pad."""
    r = route(seq_len, head_dim, dtype)
    return r is not None and head_dim not in HEAD_DIMS


def _pack4(t):
    """[B, H, S, D] -> [B, S, H*D]."""
    B, H, S, D = t.shape
    return t.transpose(1, 2).reshape(B, S, H * D)


def _shape4(q, k, v, who):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise InvalidArgumentError(
            f"{who}: q, k and v must be [B, H, S, D] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise InvalidArgumentError(
            f"{who}: q, k and v must share a dtype, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    return tuple(q.shape)


def _kernel_operands(q, k, v, key_bias, who):
    """(q, k, v sharing strides with a contiguous last dim, fp32 bias or
    None) for the kernels, after their input checks. The head-split views
    of a projection (reshape + transpose) share their strides and are
    taken as they are; a head dim outside HEAD_DIMS is zero-padded to
    kernel_width (copies); anything else is made contiguous first."""
    B, H, S, D = q.shape
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise InvalidArgumentError(
            f"{who}: unsupported devices {q.device}, {k.device}, {v.device}"
        )
    W = kernel_width(D)
    if W != D:
        q, k, v = (F.pad(t, (0, W - D)) for t in (q, k, v))
    elif not (q.stride() == k.stride() == v.stride() and q.stride(3) == 1):
        q, k, v = (t.contiguous() for t in (q, k, v))
    bias = None
    if key_bias is not None:
        bias = key_bias.float().contiguous()
        if bias.device != q.device or tuple(bias.shape) != (B, S):
            raise InvalidArgumentError(
                f"{who}: key_bias must be [B, S] = {(B, S)} on {q.device}, "
                f"got {tuple(bias.shape)} on {bias.device}"
            )
    return q, k, v, bias


def _strides(*tensors):
    """The kernels' host array of (batch, head, row) element strides."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def fused_attention(q, k, v, key_bias=None, *, scale=None, dropout_rate=0.0,
                    is_test=True, dropout_implementation="downgrade_in_infer",
                    causal=False, seed=None):
    """softmax(q k^T * scale + key_bias) v on [B, H, S, D] q, k and v, with
    fluid's dropout on the probabilities -> [B, H, S, D] in q's dtype
    (#5). key_bias: additive [B, S]. Training dropout (rate > 0, not
    is_test) needs `seed`, the op's two seed words, on every device."""
    B, H, S, D = _shape4(q, k, v, "fused_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    upscale = dropout_implementation == "upscale_in_train"
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    mask = mask_args(dropout_rate, is_test, seed, "fused_attention")
    r = route(S, D, q.dtype)
    kw = dict(scale=scale, is_test=is_test, upscale=upscale, causal=causal)
    if r == "tiled" and q.device.type == "cpu":
        from .flash_tiled import reference_fwd4

        return reference_fwd4(q, k, v, key_bias, seed, rate=dropout_rate,
                              **kw)[0]
    if r is None or q.device.type == "cpu":
        return reference(q, k, v, key_bias, dropout_rate=dropout_rate,
                         seed=seed, **kw)
    q, k, v, bias = _kernel_operands(q, k, v, key_bias, "fused_attention")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dscale = drop_scale(dropout_rate, is_test, upscale)
    if r == "tiled":
        from .flash_tiled import launch_fwd

        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        launch_fwd(q, k, v, bias, out, lse, scale, dscale, causal, mask)
    else:
        _launch_fwd(q, k, v, bias, out, scale, dscale, causal, mask)
        fused_attention.launches += 1
    return out[..., :D] if out.shape[3] != D else out


fused_attention.launches = 0


def attention_grads(q, k, v, key_bias, d_out, *, scale=None,
                    dropout_rate=0.0, is_test=True,
                    dropout_implementation="downgrade_in_infer",
                    causal=False, seed=None, want_dbias=True):
    """(dq, dk, dv [B, H, S, D] in q's dtype, dbias fp32 [B, S] or None) of
    fused_attention for the output gradient d_out (#6), with the forward's
    mask regenerated from the same seed words. dbias, the sum of dS over
    heads and query rows, is computed only when want_dbias."""
    B, H, S, D = _shape4(q, k, v, "attention_grads")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    upscale = dropout_implementation == "upscale_in_train"
    if q.device.type == "meta":
        grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                      for _ in range(3))
        dbias = (torch.empty((B, S), dtype=torch.float32, device=q.device)
                 if want_dbias else None)
        return grads + (dbias,)
    mask = mask_args(dropout_rate, is_test, seed, "attention_grads")
    r = route(S, D, q.dtype)
    kw = dict(scale=scale, is_test=is_test, upscale=upscale, causal=causal)
    if r == "tiled" and q.device.type == "cpu":
        from .flash_tiled import reference_bwd4, reference_fwd4

        out, lse = reference_fwd4(q, k, v, key_bias, seed,
                                  rate=dropout_rate, **kw)
        dq, dk, dv, dbias = reference_bwd4(q, k, v, key_bias, seed, d_out,
                                           out, lse, rate=dropout_rate, **kw)
        return dq, dk, dv, (dbias if want_dbias else None)
    if r is None or q.device.type == "cpu":
        dq, dk, dv, dbias = reference_bwd(
            q, k, v, key_bias, d_out, dropout_rate=dropout_rate, seed=seed,
            **kw)
        return dq, dk, dv, (dbias if want_dbias else None)
    q, k, v, bias = _kernel_operands(q, k, v, key_bias, "attention_grads")
    if (tuple(d_out.shape) != (B, H, S, D) or d_out.dtype != q.dtype
            or d_out.device != q.device):
        raise InvalidArgumentError(
            f"attention_grads: d_out must be [B, H, S, D] = {(B, H, S, D)} "
            f"of {q.dtype} on {q.device}; got {tuple(d_out.shape)} "
            f"{d_out.dtype} on {d_out.device}"
        )
    W = q.shape[3]
    if W != D:
        d_out = F.pad(d_out, (0, W - D))
    elif d_out.stride(3) != 1:
        d_out = d_out.contiguous()
    grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dscale = drop_scale(dropout_rate, is_test, upscale)
    if r == "tiled":
        from .flash_tiled import launch_bwd, launch_fwd

        # the 4-D op saves no lse: its backward runs #7 once more
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        launch_fwd(q, k, v, bias, out, lse, scale, dscale, causal, mask)
        dbias = launch_bwd(q, k, v, bias, d_out, out, lse, grads,
                           want_dbias, scale, dscale, causal, mask)
    else:
        dbias = _launch_bwd(q, k, v, bias, d_out, grads, want_dbias, scale,
                            dscale, causal, mask, attention_grads)
    if W != D:
        grads = tuple(g[..., :D] for g in grads)
    return grads + (dbias,)


attention_grads.launches_dq = 0
attention_grads.launches_dkv = 0


class Flash4D(torch.autograd.Function):
    """Differentiable fused_attention (counterpart of the JAX package's
    `_flash` custom_vjp): the backward calls attention_grads with the
    forward's seed words, so it regenerates the forward's mask. Written
    with setup_context, so torch.func transforms (the `__vjp__` replay's
    torch.func.vjp) reach #6 as autograd does. The static graph uses the
    dedicated fused_multihead_attention_grad op (ops/fused.py)."""

    @staticmethod
    def forward(q, k, v, key_bias, kw):
        return fused_attention(q, k, v, key_bias, **kw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_bias, kw = inputs
        ctx.save_for_backward(q, k, v, key_bias)
        ctx.kw = kw

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, key_bias = ctx.saved_tensors
        want_dbias = key_bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = attention_grads(q, k, v, key_bias, d_out,
                                            want_dbias=want_dbias, **ctx.kw)
        if dbias is not None:
            dbias = dbias.to(key_bias.dtype)
        return dq, dk, dv, dbias, None


def flash_attention(q, k, v, key_bias=None, **kw):
    """fused_attention through Flash4D (autograd-aware)."""
    return Flash4D.apply(q, k, v, key_bias, kw)


def _launch_fwd(q, k, v, bias, out, scale, dscale, causal, mask):
    """Launch the forward kernel on the [B, H, S, D] views q, k, v (shared
    strides, last dim contiguous) into the view out."""
    B, H, S, D = q.shape
    err = _bind().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        B, S, H, D, _strides(q, q, out), float(scale), float(dscale),
        int(bool(causal)), *mask, DTYPES.index(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")


def _launch_bwd(q, k, v, bias, d_out, grads, want_dbias, scale, dscale,
                causal, mask, counter):
    """Launch the two backward kernels on the [B, H, S, D] views q, k, v
    and d_out into the views grads = (dq, dk, dv), which share their
    strides; add each launch to `counter`'s launches_dq / launches_dkv.
    Returns dbias fp32 [B, S] when want_dbias, else None."""
    B, H, S, D = q.shape
    dq, dk, dv = grads
    dev = q.device
    stats = torch.empty((2, B, H, S), dtype=torch.float32, device=dev)
    part = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
            if want_dbias else None)
    lib = _bind()
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                d_out.data_ptr())
    tail = (
        B, S, H, D, _strides(q, d_out, dq), float(scale), float(dscale),
        int(bool(causal)), *mask, DTYPES.index(q.dtype),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    err = lib.flash_attention_bwd_dq(
        *operands, dq.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        *tail,
    )
    if err:
        raise RuntimeError(
            f"flash_attention_bwd_dq launch failed: CUDA error {err}"
        )
    counter.launches_dq += 1
    err = lib.flash_attention_bwd_dkv(
        *operands, dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), part.data_ptr() if part is not None else None,
        *tail,
    )
    if err:
        raise RuntimeError(
            f"flash_attention_bwd_dkv launch failed: CUDA error {err}"
        )
    counter.launches_dkv += 1
    # per-head partials summed over heads in a fixed order
    return sum_partials(part) if want_dbias else None


def _bind():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        st = ctypes.POINTER(ctypes.c_longlong)
        tail = [i, i, i, i, st, f, f, i, i, u, u, u, i, p]
        lib.flash_attention_fwd.argtypes = [p] * 5 + tail
        lib.flash_attention_bwd_dq.argtypes = [p] * 8 + tail
        lib.flash_attention_bwd_dkv.argtypes = [p] * 10 + tail
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                   lib.flash_attention_bwd_dkv):
            fn.restype = ctypes.c_int
    return lib
