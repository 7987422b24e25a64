"""Packed-QKV attention, forward and backward: hand-written CUDA kernels
and their plain PyTorch versions (counterpart of
paddle_tpu/kernels/flash_attention.py).

Replaces: paddle_tpu/kernels/flash_attention.py:_fwd_kernel_qkv (via
`_pallas_fwd_qkv`) and _bwd_kernel_qkv (via `_pallas_bwd_qkv`), the
Pallas kernels behind `fused_attention_qkv` and `attention_grads_qkv`.

Computes, per batch and head of a packed projection qkv [B, S, 3*H*D]
(section i in {q, k, v}, head h at columns i*H*D + h*D):
softmax(q k^T * scale + key_bias) v -> [B, S, H*D], with key_bias an
additive fp32 [B, S], causal masking at NEG_INF, and fluid's dropout on
the probabilities: in training the Philox keep mask of prng_mask.py
(keyed by the op's two seed words), kept values scaled by 1/(1-p) under
`upscale_in_train`; in test mode a scale of 1-p under
`downgrade_in_infer`. The backward gives dqkv [B, S, 3*H*D] and, when
asked, dbias [B, S], the sum of dS over heads and query rows.

What bounds it on the H100: at BERT shapes (S=128..512, D=64) each
query row and head does 4*S*D flops forward (about 9*S*D backward)
against 12*D input bytes, ~S/3 flop per byte, so fp32 CUDA-core kernels
are bound by operations. The designs (csrc/flash_attention_qkv.cu) keep
every [S, S] tile out of device memory: the forward streams key tiles
through shared memory with an online softmax; the backward splits into
a per-query-tile kernel (row statistics, delta, dq) and a per-key-tile
kernel (dk, dv, per-head dbias partials), reading the packed projection
in place and writing one packed dqkv. The mask is regenerated from its
coordinates in every kernel, never stored.

Dispatch: a sequence longer than MAX_SEQ = 1024 goes to the KV-tiled
kernels of flash_tiled.py (#7-#9), which also save the row logsumexp;
the rule reads only shapes and dtypes (uses_tiled_path), so a program
built before its device is known takes the same branch on the card and
on the CPU. Then a CUDA tensor goes to the kernels, or raises if they do
not take it; a CPU tensor goes to the plain version; a meta tensor
(shape inference) gets an empty output of the right shape.
"""

from __future__ import annotations

import ctypes
import math

import torch

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


def _heads(qkv, H):
    """(q, k, v) as fp32 [B, H, S, D] views of the packed projection."""
    B, S, three_hd = qkv.shape
    D = three_hd // 3 // H

    def head(i):
        sec = qkv[..., i * H * D:(i + 1) * H * D]
        return sec.reshape(B, S, H, D).transpose(1, 2).float()

    return head(0), head(1), head(2)


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


def reference_qkv(qkv, num_heads, key_bias=None, *, scale, dropout_rate=0.0,
                  is_test=True, upscale=False, causal=False, seed=None):
    """The plain version: the same function in PyTorch ops, in fp32, with
    the output cast back to qkv's dtype (as the JAX package's
    `_reference` does), and the kernels' Philox mask in training."""
    mask_args(dropout_rate, is_test, seed, "reference_qkv")
    B, S, _ = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    p = _probs(q, k, key_bias, scale, causal)
    p = p * drop_scale(dropout_rate, is_test, upscale)
    keep = _mask(q, dropout_rate, is_test, seed)
    if keep is not None:
        p = p * keep
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
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
    dqkv = torch.cat([t.transpose(1, 2).reshape(B, S, -1)
                      for t in (dq, dk, dv)], dim=-1)
    return dqkv.to(qkv.dtype), ds.sum(dim=(1, 2))


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
    use_mask, s0, s1, thr = mask_args(dropout_rate, is_test, seed,
                                      "fused_attention_qkv")
    if qkv.device.type == "cpu":
        return reference_qkv(qkv, num_heads, key_bias, scale=scale,
                             dropout_rate=dropout_rate, is_test=is_test,
                             upscale=upscale, causal=causal, seed=seed)
    B, S, D, bias = _check(qkv, num_heads, key_bias, "fused_attention_qkv")
    out = torch.empty((B, S, num_heads * D), dtype=qkv.dtype,
                      device=qkv.device)
    err = _bind().flash_attention_qkv_fwd(
        qkv.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), B, S, num_heads, D, qkv.stride(0), qkv.stride(1),
        out.stride(0), out.stride(1), float(scale),
        float(drop_scale(dropout_rate, is_test, upscale)), int(bool(causal)),
        use_mask, s0, s1, thr, DTYPES.index(qkv.dtype),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"flash_attention_qkv_fwd launch failed: CUDA error {err}"
        )
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
    upscale = dropout_implementation == "upscale_in_train"
    use_mask, s0, s1, thr = mask_args(dropout_rate, is_test, seed,
                                      "fused_attention_qkv_bwd")
    if qkv.device.type == "cpu":
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
    dev = qkv.device
    dqkv = torch.empty((B, S, 3 * H * D), dtype=qkv.dtype, device=dev)
    stats = torch.empty((2, B, H, S), dtype=torch.float32, device=dev)
    part = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
            if want_dbias else None)
    lib = _bind()
    common = (
        B, S, H, D, qkv.stride(0), qkv.stride(1), d_out.stride(0),
        d_out.stride(1), dqkv.stride(0), dqkv.stride(1), float(scale),
        float(drop_scale(dropout_rate, is_test, upscale)), int(bool(causal)),
        use_mask, s0, s1, thr, DTYPES.index(qkv.dtype),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    bias_p = bias.data_ptr() if bias is not None else None
    err = lib.flash_attention_qkv_bwd_dq(
        qkv.data_ptr(), bias_p, d_out.data_ptr(), dqkv.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), *common,
    )
    if err:
        raise RuntimeError(
            f"flash_attention_qkv_bwd_dq launch failed: CUDA error {err}"
        )
    fused_attention_qkv_bwd.launches_dq += 1
    err = lib.flash_attention_qkv_bwd_dkv(
        qkv.data_ptr(), bias_p, d_out.data_ptr(), dqkv.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(),
        part.data_ptr() if part is not None else None, *common,
    )
    if err:
        raise RuntimeError(
            f"flash_attention_qkv_bwd_dkv launch failed: CUDA error {err}"
        )
    fused_attention_qkv_bwd.launches_dkv += 1
    # per-head partials summed over heads in a fixed order
    return dqkv, (sum_partials(part) if want_dbias else None)


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


def _bind():
    lib = _build.load("flash_attention_qkv")
    if lib.flash_attention_qkv_fwd.argtypes is None:
        p, i, ll, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint)
        tail = [f, f, i, i, u, u, u, i, p]
        lib.flash_attention_qkv_fwd.argtypes = (
            [p, p, p, i, i, i, i, ll, ll, ll, ll] + tail)
        bwd = [i, i, i, i, ll, ll, ll, ll, ll, ll] + tail
        lib.flash_attention_qkv_bwd_dq.argtypes = [p, p, p, p, p, p] + bwd
        lib.flash_attention_qkv_bwd_dkv.argtypes = [p, p, p, p, p, p, p] + bwd
        for fn in (lib.flash_attention_qkv_fwd, lib.flash_attention_qkv_bwd_dq,
                   lib.flash_attention_qkv_bwd_dkv):
            fn.restype = ctypes.c_int
    return lib
