"""KV-tiled attention with a saved row logsumexp: hand-written CUDA
kernels and their plain PyTorch versions (counterpart of
paddle_tpu/kernels/flash_tiled.py).

Replaces: paddle_tpu/kernels/flash_tiled.py:_fwd_kernel (via
`flash_tiled_fwd`), _dkv_kernel and _dq_kernel (via `flash_tiled_bwd`),
the Pallas kernels behind every attention longer than the whole-row
kernel's MAX_SEQ = 1024 (flash_attention.py dispatches here).

Computes what flash_attention.fused_attention_qkv computes, over a packed
projection qkv [B, S, 3*H*D] (flash_tiled_fwd / flash_tiled_bwd), and
what fused_attention computes on [B, H, S, D] q, k, v past MAX_SEQ
(flash_attention.py calls launch_fwd / launch_bwd on the 4-D views; the
kernels read either layout through its strides, no copy), and returns
beside the output the row
logsumexp of the softmax before dropout, lse = m + log(l), as a compact
fp32 [B, H, S] (the JAX package keeps a [B, S, H*D] copy with each head's
value repeated over its D lanes, a TPU layout). The backward takes the
saved output and lse and never re-runs the forward: delta = rowsum(dO .
out) per head and row, p = exp(s - lse), dS = p (dp - delta), and gives
dqkv [B, S, 3*H*D] and, when asked, dbias [B, S].

Dropout is the Philox keep mask of prng_mask.py keyed by the op's seed
words and each element's (b, h, row, col), so the three kernels, the
whole-row kernels (#1, #3) and every plain version draw one mask whatever
their tiling. (The JAX kernels reseed the TPU's PRNG per tile.)

What bounds it on the H100: at GPT-small's S=2048 (B=4, H=12, D=64,
causal) each kernel owns 25.8 GFLOP of products against ~0.1 GB of
bytes: operations, 0.156 ms a kernel as three TF32 terms a product
(3xTF32) at 495 TFLOP/s, 0.026 ms in bf16 at 989 TFLOP/s. The design
(csrc/flash_tiled.cu) keeps every [S, S] tile out of device memory: one
block per (query tile, head, batch) for the forward and dq, one per (key
tile, head, batch) for dkv, tiles above the causal diagonal skipped. All
three run their products on the tensor cores (mma.sync TF32, 3xTF32 for
fp32 operands) on the bodies they share with the whole-row kernels
(csrc/attn_mma.cuh over csrc/mma_tiles.cuh): the forward is the
whole-row forward's kernel body, writing lse beside the output. dbias
partials per head are summed by sum_partials in a fixed order.

Dispatch: a CUDA tensor goes to the kernels, or raises if they do not
take it; a CPU tensor goes to the plain version; a meta tensor (shape
inference) gets empty outputs of the right shapes.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..errors import InvalidArgumentError
from . import _build
from .flash_attention import (
    DTYPES,
    NEG_INF,
    _check,
    _head_views,
    _heads,
    _shape,
    _split_heads,
)
from .prng_mask import drop_scale, keep_mask, mask_args
from .sum_partials import sum_partials

# key tile of the plain versions; the kernels stream tiles of 64 keys (32
# at D=128, csrc/mma_tiles.cuh)
TILE = 128


def _key_tiles(S):
    return [(k0, min(k0 + TILE, S)) for k0 in range(0, S, TILE)]


def _tile_scores(q, k, bias, k0, k1, scale, causal):
    """fp32 scores [B, H, S, k1 - k0] of every query against keys k0..k1."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k1]) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, k0:k1]
    if causal:
        S = q.shape[2]
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(k0, k1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def _multiplier(q, rate, is_test, upscale, seed, k0, k1):
    """fluid's dropout factor on p and dp for keys k0..k1: the keep mask
    times 1/(1-p) (or 1) in training, a constant in test mode."""
    w = drop_scale(rate, is_test, upscale)
    if rate == 0.0 or is_test:
        return w
    B, H, S, _ = q.shape
    keep = keep_mask(seed, rate, S, k1 - k0, lead=(B, H), col0=k0,
                     device=q.device)
    return keep * w


def _ref_fwd4(q, k, v, bias, seed, scale, rate, is_test, upscale, causal):
    """(fp32 out [B, H, S, D], lse fp32 [B, H, S]) of fp32 heads: an online
    softmax over key tiles of TILE."""
    B, H, S, D = q.shape
    m = torch.full((B, H, S, 1), -math.inf, device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    acc = torch.zeros((B, H, S, D), device=q.device)
    for k0, k1 in _key_tiles(S):
        s = _tile_scores(q, k, bias, k0, k1, scale, causal)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)  # before dropout
        e = e * _multiplier(q, rate, is_test, upscale, seed, k0, k1)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", e,
                                         v[:, :, k0:k1])
        m = m_new
    return acc / l, (m + torch.log(l)).squeeze(-1)


def _ref_bwd4(q, k, v, bias, seed, do4, out4, lse, scale, rate, is_test,
              upscale, causal):
    """(dq, dk, dv fp32 [B, H, S, D], dbias fp32 [B, S]) from fp32 heads,
    the output gradient and the saved out and lse, one pass over key
    tiles of TILE."""
    delta = (do4 * out4).sum(-1, keepdim=True)
    lse4 = lse.float()[..., None]
    dq = torch.zeros_like(q)
    dk, dv, db = [], [], []
    for k0, k1 in _key_tiles(q.shape[2]):
        p = torch.exp(_tile_scores(q, k, bias, k0, k1, scale, causal) - lse4)
        w = _multiplier(q, rate, is_test, upscale, seed, k0, k1)
        dp = torch.einsum("bhqd,bhkd->bhqk", do4, v[:, :, k0:k1]) * w
        ds = p * (dp - delta)
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, k[:, :, k0:k1]) * scale
        dk.append(torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale)
        dv.append(torch.einsum("bhqk,bhqd->bhkd", p * w, do4))
        db.append(ds.sum(dim=(1, 2)))
    return dq, torch.cat(dk, 2), torch.cat(dv, 2), torch.cat(db, -1)


def _pack(t):
    """[B, H, S, D] -> [B, S, H*D]."""
    B, H, S, D = t.shape
    return t.transpose(1, 2).reshape(B, S, H * D)


def reference_fwd(qkv, bias, seed, H, D, *, scale, rate=0.0, is_test=True,
                  upscale=False, causal=False):
    """The plain forward: an online softmax over key tiles of TILE in
    PyTorch ops, fp32. Returns (out in qkv's dtype [B, S, H*D], lse fp32
    [B, H, S])."""
    mask_args(rate, is_test, seed, "flash_tiled.reference_fwd")
    out, lse = _ref_fwd4(*_heads(qkv, H), bias, seed, scale, rate, is_test,
                         upscale, causal)
    return _pack(out).to(qkv.dtype), lse


def reference_bwd(qkv, bias, seed, do, out, lse, H, D, *, scale, rate=0.0,
                  is_test=True, upscale=False, causal=False):
    """The plain backward from the saved out and lse, one pass over key
    tiles of TILE: (dqkv in qkv's dtype, dbias fp32 [B, S])."""
    mask_args(rate, is_test, seed, "flash_tiled.reference_bwd")

    def split(t):
        return _split_heads(t, H).float()

    dq, dk, dv, dbias = _ref_bwd4(*_heads(qkv, H), bias, seed, split(do),
                                  split(out), lse, scale, rate, is_test,
                                  upscale, causal)
    dqkv = torch.cat([_pack(t) for t in (dq, dk, dv)], -1)
    return dqkv.to(qkv.dtype), dbias


def reference_fwd4(q, k, v, bias, seed, *, scale, rate=0.0, is_test=True,
                   upscale=False, causal=False):
    """The plain forward on [B, H, S, D] q, k, v: (out in q's dtype, lse
    fp32 [B, H, S])."""
    mask_args(rate, is_test, seed, "flash_tiled.reference_fwd4")
    out, lse = _ref_fwd4(q.float(), k.float(), v.float(), bias, seed, scale,
                         rate, is_test, upscale, causal)
    return out.to(q.dtype), lse


def reference_bwd4(q, k, v, bias, seed, do, out, lse, *, scale, rate=0.0,
                   is_test=True, upscale=False, causal=False):
    """The plain backward on [B, H, S, D] q, k, v from the saved out and
    lse: (dq, dk, dv in q's dtype, dbias fp32 [B, S])."""
    mask_args(rate, is_test, seed, "flash_tiled.reference_bwd4")
    dq, dk, dv, dbias = _ref_bwd4(q.float(), k.float(), v.float(), bias,
                                  seed, do.float(), out.float(), lse, scale,
                                  rate, is_test, upscale, causal)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dbias


def _statics(qkv, H, D, scale, who):
    if _shape(qkv, H, who) != D:
        raise InvalidArgumentError(
            f"{who}: qkv {tuple(qkv.shape)} does not hold H={H} heads of "
            f"D={D}"
        )
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


def flash_tiled_fwd(qkv, bias, seed, H, D, *, scale=None, rate=0.0,
                    is_test=True, upscale=False, causal=False):
    """(out [B, S, H*D] in qkv's dtype, lse fp32 [B, H, S]) of attention
    over qkv [B, S, 3*H*D] with an optional fp32 key bias [B, S]. The
    kernel takes what flash_attention's kernels take: fp32 or bf16 qkv on
    a CUDA device with a contiguous last dim, D in HEAD_DIMS, any S.
    Training dropout needs `seed`, the op's two seed words."""
    scale = _statics(qkv, H, D, scale, "flash_tiled_fwd")
    B, S, _ = qkv.shape
    if qkv.device.type == "meta":
        return (torch.empty((B, S, H * D), dtype=qkv.dtype, device="meta"),
                torch.empty((B, H, S), dtype=torch.float32, device="meta"))
    mask = mask_args(rate, is_test, seed, "flash_tiled_fwd")
    if qkv.device.type == "cpu":
        return reference_fwd(qkv, bias, seed, H, D, scale=scale, rate=rate,
                             is_test=is_test, upscale=upscale, causal=causal)
    B, S, D, bias = _check(qkv, H, bias, "flash_tiled_fwd")
    out = torch.empty((B, S, H * D), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=qkv.device)
    launch_fwd(*_head_views(qkv, H), bias, _split_heads(out, H), lse, scale,
               drop_scale(rate, is_test, upscale), causal, mask)
    return out, lse


flash_tiled_fwd.launches = 0


def _check_saved(qkv, H, D, do, out, lse, who):
    B, S, _ = qkv.shape
    for name, t, shape, dtype in (("d_out", do, (B, S, H * D), qkv.dtype),
                                  ("out", out, (B, S, H * D), qkv.dtype),
                                  ("lse", lse, (B, H, S), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != qkv.device or t.stride(-1) != 1
                or (name == "lse" and not t.is_contiguous())):
            raise InvalidArgumentError(
                f"{who}: {name} must be {shape} of {dtype} on {qkv.device} "
                f"with a contiguous last dim (lse contiguous); got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}, strides "
                f"{t.stride()}"
            )


def flash_tiled_bwd(qkv, bias, seed, do, out, lse, H, D, *, scale=None,
                    rate=0.0, is_test=True, upscale=False, causal=False,
                    want_dbias=False):
    """(dqkv [B, S, 3*H*D] in qkv's dtype, dbias fp32 [B, S] or None) of
    flash_tiled_fwd for the output gradient do [B, S, H*D], from the
    forward's saved out and lse, with its mask regenerated from the same
    seed words. dbias is computed only when want_dbias. Two kernels: dq
    (which also derives delta = rowsum(do . out)) and then dkv."""
    scale = _statics(qkv, H, D, scale, "flash_tiled_bwd")
    mask = mask_args(rate, is_test, seed, "flash_tiled_bwd")
    if qkv.device.type == "cpu":
        dqkv, dbias = reference_bwd(
            qkv, bias, seed, do, out, lse, H, D, scale=scale, rate=rate,
            is_test=is_test, upscale=upscale, causal=causal)
        return dqkv, (dbias if want_dbias else None)
    B, S, D, bias = _check(qkv, H, bias, "flash_tiled_bwd")
    _check_saved(qkv, H, D, do, out, lse, "flash_tiled_bwd")
    dqkv = torch.empty((B, S, 3 * H * D), dtype=qkv.dtype, device=qkv.device)
    dbias = launch_bwd(*_head_views(qkv, H), bias, _split_heads(do, H),
                       _split_heads(out, H), lse, _head_views(dqkv, H),
                       want_dbias, scale, drop_scale(rate, is_test, upscale),
                       causal, mask)
    return dqkv, dbias


flash_tiled_bwd.launches_dq = 0
flash_tiled_bwd.launches_dkv = 0


def _strides(*tensors):
    """The kernels' host array of (batch, head, row) element strides."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def launch_fwd(q, k, v, bias, out, lse, scale, dscale, causal, mask):
    """Launch #7 on the checked [B, H, S, D] views q, k, v (shared strides,
    last dim contiguous, D in HEAD_DIMS) into the view out and the
    contiguous fp32 lse [B, H, S]; counted on flash_tiled_fwd.launches."""
    B, H, S, D = q.shape
    err = _bind().flash_tiled_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        lse.data_ptr(), B, S, H, D, _strides(q, q, out, out), float(scale),
        float(dscale), int(bool(causal)), *mask, DTYPES.index(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_tiled_fwd launch failed: CUDA error {err}")
    flash_tiled_fwd.launches += 1


def launch_bwd(q, k, v, bias, do, out, lse, grads, want_dbias, scale,
               dscale, causal, mask):
    """Launch #9 (dq, and delta from the saved out) and then #8 (dk, dv)
    on the checked [B, H, S, D] views q, k, v, do and out (each with a
    contiguous last dim) into the views grads = (dq, dk, dv), which share
    their strides; counted on flash_tiled_bwd.launches_dq / launches_dkv.
    Returns dbias fp32 [B, S] when want_dbias, else None."""
    B, H, S, D = q.shape
    dq, dk, dv = grads
    dev = q.device
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    part = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
            if want_dbias else None)
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None, do.data_ptr())
    tail = (B, S, H, D, _strides(q, do, dq, out), float(scale), float(dscale),
            int(bool(causal)), *mask, DTYPES.index(q.dtype),
            torch.cuda.current_stream(dev).cuda_stream)
    lib = _bind()
    err = lib.flash_tiled_bwd_dq(*operands, out.data_ptr(), lse.data_ptr(),
                                 dq.data_ptr(), delta.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"flash_tiled_bwd_dq launch failed: CUDA error {err}")
    flash_tiled_bwd.launches_dq += 1
    err = lib.flash_tiled_bwd_dkv(
        *operands, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), part.data_ptr() if part is not None else None, *tail)
    if err:
        raise RuntimeError(
            f"flash_tiled_bwd_dkv launch failed: CUDA error {err}")
    flash_tiled_bwd.launches_dkv += 1
    # per-head partials summed over heads in a fixed order
    return sum_partials(part) if want_dbias else None


def _bind():
    lib = _build.load("flash_tiled")
    if lib.flash_tiled_fwd.argtypes is None:
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        st = ctypes.POINTER(ctypes.c_longlong)
        tail = [i, i, i, i, st, f, f, i, i, u, u, u, i, p]
        lib.flash_tiled_fwd.argtypes = [p] * 6 + tail
        lib.flash_tiled_bwd_dq.argtypes = [p] * 9 + tail
        lib.flash_tiled_bwd_dkv.argtypes = [p] * 10 + tail
        for fn in (lib.flash_tiled_fwd, lib.flash_tiled_bwd_dq,
                   lib.flash_tiled_bwd_dkv):
            fn.restype = ctypes.c_int
    return lib
