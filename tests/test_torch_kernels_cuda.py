"""The port's hand-written CUDA kernels on the card: each against its plain
PyTorch version (training dropout included: both draw the same Philox
mask), philox.cuh against the CUDA toolkit's curand Philox, the wrappers'
refusals, the launch counters, and BERT-tiny and GPT-tiny programs (frozen
inference, training steps, KV-cache generation) on the card against the
same programs on the CPU.

Needs a CUDA card and nvcc; skips elsewhere. Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

(`--noconftest`: tests/conftest.py imports jax; this file imports nothing
of jax or paddle_tpu, so it runs where jax is not installed.) Tolerances,
per kernel: forward fp32 atol 5e-6 (sums in another order); backward fp32
atol 5e-5 (sums over up to S=512 rows of terms of magnitude ~1); bf16 the
same plus one bf16 unit (2^-7 relative), for the output's one rounding.
The standalone LayerNorm's column sums (dscale, dbias over up to 8192
rows) atol 1e-3 + rtol 1e-5, and its statistics atol 5e-6 + rtol 1e-5.
AMP programs on the card against the CPU, both in bf16 (cuBLAS and the
CPU's matmul round at other places): loss rtol 2^-8, each gradient's
relative L2 error 2^-4.
"""

import ctypes
import math
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import convert, layers
from paddle_tpu_torch.contrib import mixed_precision as mp
from paddle_tpu_torch.errors import InvalidArgumentError
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import flash_tiled as ft
from paddle_tpu_torch.kernels import fused_residual as fr
from paddle_tpu_torch.kernels import layer_norm as lnk
from paddle_tpu_torch.kernels import prng_mask as pm
from paddle_tpu_torch.kernels import ring_block as rb
from paddle_tpu_torch.kernels import sum_partials as sp
from paddle_tpu_torch.models.bert import (
    BertConfig,
    bert_encoder,
    bert_pretrain,
)
from paddle_tpu_torch.models.gpt import (
    GPTConfig,
    gpt_cache_names,
    gpt_lm_loss,
)
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.serving import GPTGenerator, freeze_program

pytestmark = pytest.mark.cuda

TOL = {
    "attention": {torch.float32: (5e-6, 0.0),
                  torch.bfloat16: (5e-6, 2 ** -7)},
    "residual": {torch.float32: (5e-6, 0.0),
                 torch.bfloat16: (5e-6, 2 ** -7)},
    "attention_bwd": {torch.float32: (5e-5, 0.0),
                      torch.bfloat16: (5e-5, 2 ** -7)},
    "residual_bwd": {torch.float32: (5e-5, 0.0),
                     torch.bfloat16: (5e-5, 2 ** -7)},
}
SEED = (0x1234567, 0x89ABCDE)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, kernel, dtype):
    atol, rtol = TOL[kernel][dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _qkv(dev, B, S, H, D, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * D, generator=g, device=dev).to(dtype)
    bias = torch.zeros(B, S, device=dev)
    for b in range(B):  # a padded tail of keys in every sample
        bias[b, S - 1 - b * S // 4:] = -1e4
    return qkv, bias


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_attention_kernel_matches_plain_version(dev, D, dtype, causal):
    qkv, bias = _qkv(dev, 2, 100, 3, D, dtype)
    kw = dict(scale=1 / math.sqrt(D), dropout_rate=0.1, causal=causal)
    before = fa.fused_attention_qkv.launches
    got = fa.fused_attention_qkv(qkv, 3, bias, is_test=True, **kw)
    assert fa.fused_attention_qkv.launches == before + 1
    _close(got, fa.reference_qkv(qkv, 3, bias, **kw), "attention", dtype)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_attention_kernels_train_like_their_plain_versions(dev, D, dtype,
                                                           causal, impl):
    """Forward and backward with training dropout, dbias on, S not a
    multiple of the tile."""
    H, S = 3, 150
    qkv, bias = _qkv(dev, 2, S, H, D, dtype, seed=1)
    g = torch.Generator(device=dev).manual_seed(2)
    do = torch.randn(2, S, H * D, generator=g, device=dev).to(dtype)
    kw = dict(scale=1 / math.sqrt(D), dropout_rate=0.2, is_test=False,
              causal=causal, seed=SEED)
    upscale = impl == "upscale_in_train"
    before = (fa.fused_attention_qkv.launches,
              fa.fused_attention_qkv_bwd.launches_dq,
              fa.fused_attention_qkv_bwd.launches_dkv)
    out = fa.fused_attention_qkv(qkv, H, bias, dropout_implementation=impl,
                                 **kw)
    dqkv, dbias = fa.fused_attention_qkv_bwd(
        qkv, H, bias, do, dropout_implementation=impl, want_dbias=True, **kw)
    assert (fa.fused_attention_qkv.launches,
            fa.fused_attention_qkv_bwd.launches_dq,
            fa.fused_attention_qkv_bwd.launches_dkv) == tuple(
                n + 1 for n in before)
    _close(out, fa.reference_qkv(qkv, H, bias, upscale=upscale, **kw),
           "attention", dtype)
    want_q, want_b = fa.reference_qkv_bwd(qkv, H, bias, do, upscale=upscale,
                                          **kw)
    _close(dqkv, want_q, "attention_bwd", dtype)
    _close(dbias, want_b, "attention_bwd", torch.float32)


def test_attention_kernel_reads_a_strided_projection(dev):
    """qkv as a column slice of a wider buffer (rows are not contiguous):
    the forward and both backward kernels read it through its strides,
    with training dropout and dbias on."""
    wide = torch.randn(2, 64, 3 * 2 * 64 + 16, device=dev)
    qkv = wide[..., 8:8 + 3 * 2 * 64]
    bias = torch.zeros(2, 64, device=dev)
    bias[1, 40:] = -1e4
    do = torch.randn(2, 64, 2 * 64, device=dev)
    kw = dict(scale=1 / 8, dropout_rate=0.2, is_test=False, seed=SEED)
    got = fa.fused_attention_qkv(qkv, 2)
    _close(got, fa.reference_qkv(qkv, 2, scale=1 / 8), "attention",
           torch.float32)
    got = fa.fused_attention_qkv(qkv, 2, bias, **kw)
    _close(got, fa.reference_qkv(qkv, 2, bias, **kw), "attention",
           torch.float32)
    dqkv, dbias = fa.fused_attention_qkv_bwd(qkv, 2, bias, do,
                                             want_dbias=True, **kw)
    want_q, want_b = fa.reference_qkv_bwd(qkv, 2, bias, do, **kw)
    _close(dqkv, want_q, "attention_bwd", torch.float32)
    _close(dbias, want_b, "attention_bwd", torch.float32)


def test_attention_backward_skips_dbias_unless_asked(dev):
    qkv, bias = _qkv(dev, 1, 64, 2, 64, torch.float32)
    do = torch.randn(1, 64, 128, device=dev)
    s0 = sp.sum_partials.launches
    dqkv, dbias = fa.fused_attention_qkv_bwd(qkv, 2, bias, do)
    assert dbias is None and sp.sum_partials.launches == s0
    want, _ = fa.reference_qkv_bwd(qkv, 2, bias, do, scale=1 / 8)
    _close(dqkv, want, "attention_bwd", torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [100, 768, 1024])
def test_residual_kernel_matches_plain_version(dev, N, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    x, y = (torch.randn(37, N, generator=g, device=dev).to(dtype)
            for _ in range(2))
    gam = 1 + 0.1 * torch.randn(N, generator=g, device=dev)
    beta = 0.1 * torch.randn(N, generator=g, device=dev)
    kw = dict(rate=0.1, eps=1e-5)
    before = fr.fused_dropout_add_ln_fwd.launches
    got = fr.fused_dropout_add_ln_fwd(x, y, gam, beta, is_test=True, **kw)
    assert fr.fused_dropout_add_ln_fwd.launches == before + 1
    _close(got, fr.reference_fwd(x, y, gam, beta, **kw), "residual", dtype)


@pytest.mark.parametrize("upscale", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [100, 768, 1024])
def test_residual_kernels_train_like_their_plain_versions(dev, N, dtype,
                                                          upscale):
    """Forward and backward with training dropout over 300 rows (five
    backward blocks, the last one ragged); dy is zero exactly where the
    plain mask drops."""
    g = torch.Generator(device=dev).manual_seed(3)
    x, y, do = (torch.randn(300, N, generator=g, device=dev).to(dtype)
                for _ in range(3))
    gam = 1 + 0.1 * torch.randn(N, generator=g, device=dev)
    beta = 0.1 * torch.randn(N, generator=g, device=dev)
    kw = dict(rate=0.2, is_test=False, upscale=upscale, eps=1e-5, seed=SEED)
    before = (fr.fused_dropout_add_ln_fwd.launches,
              fr.fused_dropout_add_ln_bwd.launches, sp.sum_partials.launches)
    out = fr.fused_dropout_add_ln_fwd(x, y, gam, beta, **kw)
    dx, dy, dg, dc = fr.fused_dropout_add_ln_bwd(x, y, gam, do, **kw)
    assert (fr.fused_dropout_add_ln_fwd.launches,
            fr.fused_dropout_add_ln_bwd.launches,
            sp.sum_partials.launches) == tuple(n + 1 for n in before)
    _close(out, fr.reference_fwd(x, y, gam, beta, **kw), "residual", dtype)
    want = fr.reference_bwd(x, y, gam, do, **kw)
    for got_t, want_t in zip((dx, dy), want[:2]):
        _close(got_t, want_t, "residual_bwd", dtype)
    for got_t, want_t in zip((dg, dc), want[2:]):
        # sums over 300 rows
        torch.testing.assert_close(got_t, want_t, atol=5e-4, rtol=1e-5)
    keep = pm.keep_mask(SEED, 0.2, 300, N, device=dev)
    assert torch.equal(dy == 0, ~keep)


def _residual_rows(dev, R, N, dtype, stride, seed):
    """x, y and dO [R, N] of dtype whose rows lie `stride` elements apart
    (stride N: contiguous; N + 1: rows that are not 16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.randn(3, R, N, generator=g, device=dev)
    vals[1] = vals[1] * 2 + 0.5
    buf = torch.zeros(3, R, stride, device=dev, dtype=dtype)
    buf[..., :N] = vals.to(dtype)
    return buf[0, :, :N], buf[1, :, :N], buf[2, :, :N]


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [700, 768, 1024])
def test_residual_backward_takes_both_copy_paths_alike(dev, N, dtype,
                                                       training):
    """#4 over R=1000 rows (groups of 16, the last one ragged), dropout
    0.1 in training or test mode, on contiguous rows (16-byte vectors
    where N is a whole number of chunks: fp32 chunks of 4, bf16 of 8, so
    bf16 at N=700 goes element by element) and on the same values with
    rows N + 1 elements apart (element by element): dx, dy within the
    backward tolerance of the plain version, dg and dc within the sums'
    (1e-3 + 1e-5 relative), the two layouts' results the same bits, dg
    and dc the same bits over two launches, and dy zero exactly where the
    plain mask drops."""
    R = 1000
    gam = 1 + 0.1 * torch.randn(N, device=dev)
    kw = dict(rate=0.1, is_test=not training, eps=1e-5,
              seed=SEED if training else None)
    got = {}
    for stride in (N, N + 1):
        x, y, do = _residual_rows(dev, R, N, dtype, stride, 21)
        before = (fr.fused_dropout_add_ln_bwd.launches,
                  sp.sum_partials.launches)
        got[stride] = fr.fused_dropout_add_ln_bwd(x, y, gam, do, **kw)
        assert (fr.fused_dropout_add_ln_bwd.launches,
                sp.sum_partials.launches) == (before[0] + 1, before[1] + 1)
        dx, dy, dg, dc = got[stride]
        want = fr.reference_bwd(x, y, gam, do, **kw)
        _close(dx, want[0], "residual_bwd", dtype)
        _close(dy, want[1], "residual_bwd", dtype)
        for a, w in zip((dg, dc), want[2:]):
            torch.testing.assert_close(a, w, atol=1e-3, rtol=1e-5)
        again = fr.fused_dropout_add_ln_bwd(x, y, gam, do, **kw)
        assert torch.equal(dg, again[2]) and torch.equal(dc, again[3])
        if training:
            keep = pm.keep_mask(SEED, 0.1, R, N, device=dev)
            assert torch.equal(dy == 0, ~keep)
    for a, b in zip(got[N], got[N + 1]):
        assert torch.equal(a, b)


def test_kernel_masks_equal_the_plain_mask_and_keep_one_minus_p(dev):
    """The residual backward's dy is zero exactly where a kernel dropped:
    over 2048 x 768 elements (>10^6) that pattern equals the plain mask,
    a tile of the plain mask equals the same slice of the whole, and the
    keep rate is within 5 sigma of 1-p."""
    R, N, rate = 2048, 768, 0.1
    x, y, do = (torch.randn(R, N, device=dev) for _ in range(3))
    _, dy, _, _ = fr.fused_dropout_add_ln_bwd(
        x, y, None, do, rate=rate, is_test=False, seed=SEED)
    whole = pm.keep_mask(SEED, rate, R, N, device=dev)
    kept = dy != 0
    assert torch.equal(kept, whole)
    tile = pm.keep_mask(SEED, rate, 64, 96, row0=640, col0=352, device=dev)
    assert torch.equal(tile, whole[640:704, 352:448])
    n = kept.numel()
    p = 1 - pm.threshold(rate) / 65536
    assert abs(kept.float().mean().item() - p) < 5 * math.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("G", [12, 257])
def test_sum_partials_kernel_matches_plain_version(dev, G):
    """One thread a column up to 16 partials, slices of at most 16 in
    up to 32 thread rows past it: both within 5e-5 of the plain sum and
    the same bits twice."""
    part = torch.randn(3, G, 700, device=dev)
    before = sp.sum_partials.launches
    got = sp.sum_partials(part)
    assert sp.sum_partials.launches == before + 1
    torch.testing.assert_close(got, sp.reference(part), atol=5e-5, rtol=0)
    assert torch.equal(got, sp.sum_partials(part))  # deterministic


_CURAND_CHECK = r"""
#include <curand_kernel.h>
#include "philox.cuh"

__global__ void both(const uint4* c, const uint2* k, uint4* ours,
                     uint4* theirs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ours[i] = philox::philox4x32_10(c[i], k[i].x, k[i].y);
  theirs[i] = curand_Philox4x32_10(c[i], k[i]);
}

extern "C" int run(const void* c, const void* k, void* ours, void* theirs,
                   int n) {
  both<<<(n + 255) / 256, 256>>>(static_cast<const uint4*>(c),
                                 static_cast<const uint2*>(k),
                                 static_cast<uint4*>(ours),
                                 static_cast<uint4*>(theirs), n);
  cudaError_t err = cudaDeviceSynchronize();
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
"""


def test_philox_header_matches_curand_and_the_plain_version(dev, tmp_path):
    src = tmp_path / "curand_check.cu"
    src.write_text(_CURAND_CHECK)
    lib = tmp_path / "libcurand_check.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    n = 4096
    rng = np.random.RandomState(0)
    ctr = rng.randint(0, 2 ** 32, (n, 4), dtype=np.uint64)
    key = rng.randint(0, 2 ** 32, (n, 2), dtype=np.uint64)
    ctr[0], key[0] = 0, 0  # Random123's zero known answer
    c = torch.from_numpy(ctr.astype(np.uint32).view(np.int32)).to(dev)
    k = torch.from_numpy(key.astype(np.uint32).view(np.int32)).to(dev)
    ours, theirs = torch.empty_like(c), torch.empty_like(c)
    assert fn(c.data_ptr(), k.data_ptr(), ours.data_ptr(), theirs.data_ptr(),
              n) == 0
    assert torch.equal(ours, theirs)
    got = ours.cpu().numpy().view(np.uint32)
    assert tuple(got[0]) == (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    for i in range(0, n, 512):
        want = pm.philox4x32_10(
            *(torch.tensor([int(w)]) for w in ctr[i]), tuple(key[i]))
        assert tuple(int(w[0]) for w in want) == tuple(got[i])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """The packed wrappers answer the shapes the JAX package answers
    (flash_attention.route): head dim 48 through the 4-D wrappers on
    heads zero-padded to 64 (#5's counter), fp16 through the plain
    version; neither launches a packed kernel. Malformed inputs raise."""
    counts = (fa.fused_attention_qkv.launches,
              fa.fused_attention_qkv_bwd.launches_dq,
              fr.fused_dropout_add_ln_fwd.launches,
              fr.fused_dropout_add_ln_bwd.launches)
    qkv, bias = _qkv(dev, 1, 16, 2, 48, torch.float32)
    mha = _mha_counts()
    out = fa.fused_attention_qkv(qkv, 2, bias)  # head dim 48
    assert _mha_counts() == (mha[0] + 1, mha[1], mha[2])
    _close(out, fa.reference_qkv(qkv, 2, bias, scale=1 / math.sqrt(48)),
           "attention", torch.float32)
    qkv, bias = _qkv(dev, 1, 16, 2, 64, torch.float32)
    with pytest.raises(InvalidArgumentError):  # training without seed words
        fa.fused_attention_qkv(qkv, 2, bias, dropout_rate=0.1, is_test=False)
    mha = _mha_counts()
    half = fa.fused_attention_qkv(qkv.half(), 2, bias)  # fp16: plain
    assert half.dtype == torch.float16 and _mha_counts() == mha
    assert torch.equal(half, fa.reference_qkv(qkv.half(), 2, bias,
                                              scale=0.125))
    with pytest.raises(InvalidArgumentError):  # bias on another device
        fa.fused_attention_qkv(qkv, 2, bias.cpu())
    d16 = torch.zeros(1, 16, 128, device=dev).bfloat16()
    with pytest.raises(InvalidArgumentError):  # d_out of another dtype
        fa.fused_attention_qkv_bwd(qkv, 2, bias, d16)
    x = torch.randn(4, 2048, device=dev)
    with pytest.raises(InvalidArgumentError):  # wider than a warp's row
        fr.fused_dropout_add_ln_fwd(x, x)
    x = torch.randn(4, 64, device=dev)
    with pytest.raises(InvalidArgumentError):  # training without seed words
        fr.fused_dropout_add_ln_fwd(x, x, rate=0.1, is_test=False)
    with pytest.raises(InvalidArgumentError):  # strided d_out rows
        fr.fused_dropout_add_ln_bwd(x, x, None, torch.zeros(64, 4,
                                                            device=dev).t())
    with pytest.raises(InvalidArgumentError):
        sp.sum_partials(torch.zeros(2, 3, 4, device=dev).double())
    assert counts == (fa.fused_attention_qkv.launches,
                      fa.fused_attention_qkv_bwd.launches_dq,
                      fr.fused_dropout_add_ln_fwd.launches,
                      fr.fused_dropout_add_ln_bwd.launches)


def test_bert_tiny_on_the_card_matches_the_cpu(dev):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    cfg = BertConfig.tiny()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [-1, 32], "int64")
        types = fluid.data("types", [-1, 32], "int64")
        mask = fluid.data("mask", [-1, 32], "float32")
        seq = bert_encoder(ids, types, mask, cfg, is_test=True)
        prob = layers.softmax(layers.fc(layers.slice(seq, [1], [0], [1]), 4))
    frozen = freeze_program(main, [prob], feed_names=("ids", "types", "mask"))
    exe, scope = fluid.Executor(), fluid.Scope()  # the default place: card
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, cfg.vocab_size, (3, 32)),
            "types": np.zeros((3, 32), np.int64),
            "mask": np.ones((3, 32), np.float32)}
    feed["mask"][1, 20:] = 0
    a0 = fa.fused_attention_qkv.launches
    r0 = fr.fused_dropout_add_ln_fwd.launches
    gpu, = exe.run(frozen.program, feed=feed,
                   fetch_list=list(frozen.fetch_names), scope=scope)
    assert fa.fused_attention_qkv.launches - a0 == cfg.num_layers
    assert fr.fused_dropout_add_ln_fwd.launches - r0 == 2 * cfg.num_layers
    cpu_scope = fluid.Scope()
    convert.state_from_numpy(convert.state_to_numpy(scope), cpu_scope,
                             fluid.CPUPlace())
    cpu, = fluid.Executor(fluid.CPUPlace()).run(
        frozen.program, feed=feed, fetch_list=list(frozen.fetch_names),
        scope=cpu_scope)
    np.testing.assert_allclose(gpu, cpu, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_bert_tiny_training_on_the_card_matches_the_cpu(dev, dropout):
    """Two Adam steps of bench_bert's program at BertConfig.tiny() on the
    card and on the CPU from one state. With dropout, both draw the same
    Philox masks in the fused ops (the plain `dropout` op after the
    embeddings draws from torch generators, which differ between devices,
    so the embedding dropout is 0 here). Tolerance: loss rtol 1e-5, every
    @GRAD atol 1e-5 + rtol 1e-3, other state atol 1e-7 + rtol 1e-3, each
    parameter's update over the two steps within 1e-3 of (|update| + lr)
    but where the card's and the CPU's gradients differ by more than 1e-4
    of the CPU's at a step (Adam's step follows that disagreement); those
    stay under 2% of the elements."""
    B, S, P = 4, 64, 38
    cfg = BertConfig.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        v = [fluid.data(n, [B, S], t) for n, t in (
            ("ids", "int64"), ("types", "int64"), ("mask", "float32"))]
        pos = fluid.data("mask_pos", [P], "int64")
        lab = fluid.data("labels", [P], "int64")
        loss = bert_pretrain(*v, lab, cfg, mask_pos=pos)
        _, pg = Adam(1e-3).minimize(loss, startup)
    for op in main.global_block.ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
        if op.type == "__vjp__" and op.attr("fwd_type") == "dropout":
            op.attrs["fwd_attrs"]["dropout_prob"] = 0.0
    rng = np.random.RandomState(1)
    feed = {"ids": rng.randint(0, cfg.vocab_size, (B, S)),
            "types": rng.randint(0, 2, (B, S)),
            "mask": np.ones((B, S), np.float32),
            "mask_pos": rng.choice(B * S, P, replace=False),
            "labels": rng.randint(0, cfg.vocab_size, P)}
    feed["mask"][2, 50:] = 0
    fetch = [loss] + [g for _, g in pg]
    gscope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=gscope)
    cscope, cexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    convert.state_from_numpy(convert.state_to_numpy(gscope), cscope,
                             fluid.CPUPlace(), program=main)
    cpu_prog = main.clone()  # the same seed and run counter as `main`
    start = convert.state_to_numpy(gscope)
    grads = {p.name: [] for p, _ in pg}  # (card, CPU) per step
    c0 = fa.fused_attention_qkv_bwd.launches_dq
    for step in range(2):
        gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gscope)
        cpu = cexe.run(cpu_prog, feed=feed, fetch_list=fetch, scope=cscope)
        np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-5)
        for g, c, (p, _) in zip(gpu[1:], cpu[1:], pg):
            np.testing.assert_allclose(g, c, rtol=1e-3, atol=1e-5,
                                       err_msg=p.name)
            grads[p.name].append((g, c))
    assert fa.fused_attention_qkv_bwd.launches_dq - c0 == 2 * cfg.num_layers
    gend, cend = convert.state_to_numpy(gscope), convert.state_to_numpy(cscope)
    exempt = total = 0
    for name, c in cend.items():
        g = gend[name]
        if name not in grads:  # moments, beta powers, lr
            np.testing.assert_allclose(g, c, rtol=1e-3, atol=1e-7,
                                       err_msg=name)
            continue
        du = g.astype(np.float64) - start[name]
        dc = c.astype(np.float64) - start[name]
        noisy = np.zeros(dc.shape, bool)
        for gg, gc in grads[name]:
            gc = gc.astype(np.float64)
            noisy |= np.abs(gg - gc) > 1e-4 * np.abs(gc)
        err = np.abs(du - dc) - 1e-3 * (np.abs(dc) + 1e-3)
        assert (err[~noisy] <= 0).all(), name
        exempt, total = exempt + noisy.sum(), total + noisy.size
    print(f"updates: {exempt} of {total} elements exempt")
    assert exempt < 0.02 * total


def _tiled_counts():
    return (ft.flash_tiled_fwd.launches, ft.flash_tiled_bwd.launches_dq,
            ft.flash_tiled_bwd.launches_dkv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S", [(1, 1152), (4, 2048)])
def test_tiled_kernels_match_their_plain_versions(dev, B, S, causal,
                                                  with_bias, training, dtype):
    """#7 (forward, lse), #9 (dq, delta) and #8 (dk, dv, dbias) against the
    plain tiled versions, dropout 0.1 in training or test mode. Tolerances
    as the whole-row kernels' (sums over up to 2048 rows); lse atol 5e-6."""
    H, D = 3, 64
    qkv, bias = _qkv(dev, B, S, H, D, dtype, seed=S + B)
    bias = bias if with_bias else None
    g = torch.Generator(device=dev).manual_seed(5)
    do = torch.randn(B, S, H * D, generator=g, device=dev).to(dtype)
    kw = dict(scale=1 / 8, rate=0.1, is_test=not training, causal=causal)
    seed = SEED if training else None
    before = _tiled_counts()
    out, lse = ft.flash_tiled_fwd(qkv, bias, seed, H, D, **kw)
    dqkv, dbias = ft.flash_tiled_bwd(qkv, bias, seed, do, out, lse, H, D,
                                     want_dbias=with_bias, **kw)
    assert _tiled_counts() == tuple(n + 1 for n in before)
    want_o, want_l = ft.reference_fwd(qkv, bias, seed, H, D, **kw)
    _close(out, want_o, "attention", dtype)
    torch.testing.assert_close(lse, want_l, atol=5e-6, rtol=0)
    want_q, want_b = ft.reference_bwd(qkv, bias, seed, do, out, lse, H, D,
                                      **kw)
    _close(dqkv, want_q, "attention_bwd", dtype)
    if with_bias:
        _close(dbias, want_b, "attention_bwd", torch.float32)
    else:
        assert dbias is None


@pytest.mark.parametrize("D", [32, 128])
def test_tiled_kernels_take_every_head_dim(dev, D):
    qkv, bias = _qkv(dev, 2, 1100, 2, D, torch.float32, seed=D)
    do = torch.randn(2, 1100, 2 * D, device=dev)
    kw = dict(rate=0.2, is_test=False, causal=True)
    out, lse = ft.flash_tiled_fwd(qkv, bias, SEED, 2, D, **kw)
    dqkv, dbias = ft.flash_tiled_bwd(qkv, bias, SEED, do, out, lse, 2, D,
                                     want_dbias=True, **kw)
    want_o, _ = ft.reference_fwd(qkv, bias, SEED, 2, D, scale=D ** -0.5,
                                 **kw)
    want_q, want_b = ft.reference_bwd(qkv, bias, SEED, do, out, lse, 2, D,
                                      scale=D ** -0.5, **kw)
    _close(out, want_o, "attention", torch.float32)
    _close(dqkv, want_q, "attention_bwd", torch.float32)
    _close(dbias, want_b, "attention_bwd", torch.float32)


def test_tiled_kernels_draw_the_whole_row_kernels_mask(dev):
    """One seed, S=512 (both paths take it), random q, k and v: #7's
    output equals #1's bit for bit (one body, attn_mma.cuh's fwd_view,
    with and without the lse row, so one mask and one arithmetic), and
    the dv of one query row from #8 is zero exactly where #3's is and
    where the plain mask drops."""
    B, S, H, D, rate = 2, 512, 2, 64, 0.25
    qkv, bias = _qkv(dev, B, S, H, D, torch.float32, seed=9)
    kw = dict(scale=1 / 8, is_test=False, causal=False)
    out, lse = ft.flash_tiled_fwd(qkv, bias, SEED, H, D, rate=rate, **kw)
    whole = fa.fused_attention_qkv(qkv, H, bias, dropout_rate=rate, seed=SEED,
                                   **kw)
    assert torch.equal(out, whole)
    row, head = 77, 1
    one = torch.zeros(B, S, H * D, device=dev)
    one[:, row, head * D:(head + 1) * D] = 1.0
    dqkv, _ = ft.flash_tiled_bwd(qkv, bias, SEED, one, out, lse, H, D,
                                 rate=rate, **kw)
    dqkv_w, _ = fa.fused_attention_qkv_bwd(qkv, H, bias, one,
                                           dropout_rate=rate, seed=SEED, **kw)
    sec = slice(2 * H * D + head * D, 2 * H * D + (head + 1) * D)
    zero = (dqkv[0, :, sec] == 0).all(-1)
    keep = pm.keep_mask(SEED, rate, S, S, lead=(B, H), device=dev)
    live = bias[0] > -1  # padded keys get p = 0 whatever the mask
    assert torch.equal(zero[live], ~keep[0, head, row][live])
    assert torch.equal(zero, (dqkv_w[0, :, sec] == 0).all(-1))


def test_attention_dispatch_takes_the_tiled_kernels_past_1024(dev):
    """fused_attention_qkv and its backward launch #7-#9 past MAX_SEQ and
    #1, #3 up to it; with the saved (out, lse) the backward does not run
    the forward again."""
    qkv, _ = _qkv(dev, 1, 1536, 2, 64, torch.float32)
    do = torch.randn(1, 1536, 128, device=dev)
    w0 = (fa.fused_attention_qkv.launches,
          fa.fused_attention_qkv_bwd.launches_dq)
    t0 = _tiled_counts()
    out, lse = fa.fused_attention_qkv(qkv, 2, causal=True, return_lse=True)
    fa.fused_attention_qkv_bwd(qkv, 2, None, do, causal=True, saved_out=out,
                               saved_lse=lse)
    assert _tiled_counts() == tuple(n + 1 for n in t0)
    fa.fused_attention_qkv_bwd(qkv, 2, None, do, causal=True)  # no saved
    assert _tiled_counts() == (t0[0] + 2, t0[1] + 2, t0[2] + 2)
    fa.fused_attention_qkv(qkv[:, :1024], 2, causal=True)
    assert (fa.fused_attention_qkv.launches,
            fa.fused_attention_qkv_bwd.launches_dq) == (w0[0] + 1, w0[1])


def test_tiled_wrappers_refuse_what_the_kernels_do_not_take(dev):
    counts = _tiled_counts()
    qkv, bias = _qkv(dev, 1, 1100, 2, 48, torch.float32)
    with pytest.raises(InvalidArgumentError):  # head dim 48
        ft.flash_tiled_fwd(qkv, bias, None, 2, 48)
    qkv, bias = _qkv(dev, 1, 1100, 2, 64, torch.float32)
    with pytest.raises(InvalidArgumentError):  # fp16
        ft.flash_tiled_fwd(qkv.half(), bias, None, 2, 64)
    with pytest.raises(InvalidArgumentError):  # bias on another device
        ft.flash_tiled_fwd(qkv, bias.cpu(), None, 2, 64)
    out, lse = ft.flash_tiled_fwd(qkv, bias, None, 2, 64)
    do = torch.zeros(1, 1100, 128, device=dev)
    with pytest.raises(InvalidArgumentError):  # lse of another layout
        ft.flash_tiled_bwd(qkv, bias, None, do, out, lse.transpose(1, 2)
                           .contiguous(), 2, 64)
    with pytest.raises(InvalidArgumentError):  # out on the CPU
        ft.flash_tiled_bwd(qkv, bias, None, do, out.cpu(), lse, 2, 64)
    assert _tiled_counts() == (counts[0] + 1, counts[1], counts[2])


def test_gpt_tiny_at_s2048_trains_on_the_card_like_the_cpu(dev):
    """Two Adam steps of GPT-tiny (max_position 2048, B=1, S=2048, dropout
    0) on the card and the CPU from one state: every step launches #7, #9
    and #8 once per layer and #1, #3 never. Tolerances as the BERT-tiny
    test's, with 5% exempt updates (the CPU test's bound for GPT)."""
    cfg = GPTConfig.tiny()
    cfg.max_position = 2048
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [1, 2048], "int64")
        loss = gpt_lm_loss(ids, cfg)
        _, pg = Adam(1e-3).minimize(loss, startup)
    feed = {"ids": np.random.RandomState(1).randint(0, 512, (1, 2048))}
    fetch = [loss] + [g for _, g in pg]
    gscope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=gscope)
    cscope, cexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    convert.state_from_numpy(convert.state_to_numpy(gscope), cscope,
                             fluid.CPUPlace(), program=main)
    t0 = _tiled_counts()
    w0 = (fa.fused_attention_qkv.launches,
          fa.fused_attention_qkv_bwd.launches_dq)
    for step in range(2):
        gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gscope)
        cpu = cexe.run(main, feed=feed, fetch_list=fetch, scope=cscope)
        np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-5)
        for g, c, (p, _) in zip(gpu[1:], cpu[1:], pg):
            np.testing.assert_allclose(g, c, rtol=1e-3, atol=1e-5,
                                       err_msg=p.name)
    n = 2 * cfg.num_layers
    assert _tiled_counts() == (t0[0] + n, t0[1] + n, t0[2] + n)
    assert (fa.fused_attention_qkv.launches,
            fa.fused_attention_qkv_bwd.launches_dq) == w0


def test_gpt_tiny_generation_on_the_card_matches_the_cpu(dev):
    """KV-cache generation of GPT-tiny on the card gives the CPU's tokens
    and the card's full recompute's (which launches #1 causal)."""
    cfg = GPTConfig.tiny()
    gen = GPTGenerator(cfg, batch=2, context_len=12, max_len=24)
    gen.init_params(seed=3)
    assert gen.scope.find_var("wte").is_cuda
    cpu = GPTGenerator(cfg, batch=2, context_len=12, max_len=24,
                       executor=fluid.Executor(fluid.CPUPlace()))
    convert.state_from_numpy(convert.state_to_numpy(gen.scope), cpu.scope,
                             fluid.CPUPlace(), program=cpu.prefill_prog,
                             exclude=gpt_cache_names(cfg))
    ctx = np.random.RandomState(0).randint(0, 512, (2, 12))
    got = gen.generate(ctx, 8)
    np.testing.assert_array_equal(got, cpu.generate(ctx, 8))
    a0 = fa.fused_attention_qkv.launches
    np.testing.assert_array_equal(got, gen.generate_full_recompute(ctx, 8))
    assert fa.fused_attention_qkv.launches - a0 == 8 * cfg.num_layers


LN_SHAPES = [(8192, 768), (1001, 256), (1001, 1024), (1001, 4096),
             (77, 2048), (77, 8192), (37, 100)]


def _ln_inputs(dev, R, N, dtype, affine, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(R, N, generator=g, device=dev) * 2 + 0.5).to(dtype)
    dy = torch.randn(R, N, generator=g, device=dev).to(dtype)
    s = 1 + 0.1 * torch.randn(N, generator=g, device=dev)
    b = 0.1 * torch.randn(N, generator=g, device=dev)
    if affine is None:
        return x, dy, None, None
    return x, dy, s.to(affine), b.to(affine)


@pytest.mark.parametrize("affine", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", LN_SHAPES)
def test_layer_norm_kernels_match_their_plain_versions(dev, R, N, dtype,
                                                       affine):
    """#10 and #11 at GPT's [8192, 768], at R = 1001 (a multiple of no
    block size) for N in {256, 1024, 4096}, and at the other row layouts
    (two and eight warps a row, N not a multiple of 32)."""
    x, dy, s, b = _ln_inputs(dev, R, N, dtype, affine)
    before = (lnk.layer_norm_fwd.launches, lnk.layer_norm_bwd.launches,
              sp.sum_partials.launches)
    y, mean, var = lnk.layer_norm_fwd(x, s, b, 1e-5)
    dx, ds, db = lnk.layer_norm_bwd(x, s, dy, 1e-5)
    assert (lnk.layer_norm_fwd.launches, lnk.layer_norm_bwd.launches,
            sp.sum_partials.launches) == tuple(n + 1 for n in before)
    want = lnk.reference_fwd(x, s, b, 1e-5)
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    _close(y, want[0], "residual", dtype)
    for got_t, want_t in zip((mean, var), want[1:]):
        torch.testing.assert_close(got_t, want_t, atol=5e-6, rtol=1e-5)
    want = lnk.reference_bwd(x, s, dy, 1e-5)
    assert dx.dtype == dtype and ds.dtype == db.dtype == torch.float32
    _close(dx, want[0], "residual_bwd", dtype)
    for got_t, want_t in zip((ds, db), want[1:]):
        torch.testing.assert_close(got_t, want_t, atol=1e-3, rtol=1e-5)


def test_layer_norm_backward_is_deterministic(dev):
    """#11's column sums go through per-block partials and sum_partials in
    a fixed order: two runs give the same bits."""
    x, dy, s, _ = _ln_inputs(dev, 8192, 768, torch.bfloat16, torch.bfloat16)
    first = lnk.layer_norm_bwd(x, s, dy, 1e-5)
    second = lnk.layer_norm_bwd(x, s, dy, 1e-5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_layer_norm_wrappers_refuse_what_the_kernels_do_not_take(dev):
    counts = (lnk.layer_norm_fwd.launches, lnk.layer_norm_bwd.launches)
    x = torch.randn(16, 256, device=dev)
    with pytest.raises(InvalidArgumentError):  # fp16
        lnk.layer_norm_fwd(x.half(), None, None)
    with pytest.raises(InvalidArgumentError):  # fp16
        lnk.layer_norm_bwd(x.half(), None, x.half())
    with pytest.raises(InvalidArgumentError):  # wider than 8192
        lnk.layer_norm_fwd(torch.randn(8, 8320, device=dev))
    with pytest.raises(InvalidArgumentError):  # scale on the CPU
        lnk.layer_norm_fwd(x, torch.ones(256), None)
    with pytest.raises(InvalidArgumentError):  # fp16 bias
        lnk.layer_norm_fwd(x, None, torch.zeros(256, device=dev).half())
    with pytest.raises(InvalidArgumentError):  # dy of another dtype
        lnk.layer_norm_bwd(x, None, x.bfloat16())
    with pytest.raises(InvalidArgumentError):  # strided rows
        lnk.layer_norm_fwd(torch.randn(256, 16, device=dev).t())
    assert counts == (lnk.layer_norm_fwd.launches,
                      lnk.layer_norm_bwd.launches)


def _amp_program(which, flag):
    """bench.py's AMP-decorated program at tiny size, dropout 0."""
    fluid.set_flags({"FLAGS_paddle_tpu_pallas_layer_norm": flag})
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if which == "gpt":
            cfg = GPTConfig.tiny()
            cfg.hidden_dropout = cfg.attention_dropout = 0.0
            ids = fluid.data("ids", [2, 64], "int64")
            loss = gpt_lm_loss(ids, cfg)
            feed = {"ids": np.random.RandomState(1).randint(0, 512, (2, 64))}
        else:
            cfg = BertConfig.tiny()
            cfg.hidden_dropout = cfg.attention_dropout = 0.0
            B, S, P = 4, 64, 38
            rng = np.random.RandomState(1)
            names = ("ids", "types", "mask", "mask_pos", "labels")
            shapes = ([B, S], [B, S], [B, S], [P], [P])
            v = [fluid.data(n, s, "float32" if n == "mask" else "int64")
                 for n, s in zip(names, shapes)]
            loss = bert_pretrain(*v[:3], v[4], cfg, mask_pos=v[3])
            feed = {"ids": rng.randint(0, cfg.vocab_size, (B, S)),
                    "types": rng.randint(0, 2, (B, S)),
                    "mask": np.ones((B, S), np.float32),
                    "mask_pos": rng.choice(B * S, P, replace=False),
                    "labels": rng.randint(0, cfg.vocab_size, P)}
        opt = mp.decorate(
            Adam(1e-3), amp_lists=mp.AutoMixedPrecisionLists(
                custom_white_list={"softmax", "layer_norm"}),
            use_dynamic_loss_scaling=False, init_loss_scaling=1.0)
        _, pg = opt.minimize(loss, startup)
    return main, startup, loss, pg, feed


@pytest.mark.parametrize("which,flag", [("bert", False), ("gpt", True)])
def test_amp_programs_run_the_kernels_in_bf16_like_the_cpu(dev, which, flag):
    """One AMP step of BERT-tiny (#1-#4 on bf16 activations, #2/#4 with
    fp32 LN scale and bias as the rewrite keeps them) and of GPT-tiny
    with FLAGS_paddle_tpu_pallas_layer_norm on (#10/#11 on bf16 x, scale
    and bias) on the card and on the CPU from one state."""
    try:
        main, startup, loss, pg, feed = _amp_program(which, flag)
        fetch = [loss] + [g for _, g in pg]
        gscope, exe = fluid.Scope(), fluid.Executor()
        exe.run(startup, scope=gscope)
        cscope, cexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        convert.state_from_numpy(convert.state_to_numpy(gscope), cscope,
                                 fluid.CPUPlace(), program=main)
        counters = [fr.fused_dropout_add_ln_fwd, fr.fused_dropout_add_ln_bwd,
                    lnk.layer_norm_fwd, lnk.layer_norm_bwd]
        before = [c.launches for c in counters]
        gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gscope)
        cpu = cexe.run(main, feed=feed, fetch_list=fetch, scope=cscope)
    finally:
        fluid.set_flags({"FLAGS_paddle_tpu_pallas_layer_norm": False})
    step = [c.launches - b for c, b in zip(counters, before)]
    n_ln = sum(op.type == "layer_norm" for op in main.global_block.ops)
    if which == "bert":
        assert step == [4, 4, 0, 0]  # 2 layers x 2 residual LNs
    else:
        assert step == [0, 0, n_ln, n_ln] and n_ln == 5
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=2 ** -8)
    for g, c, (p, _) in zip(gpu[1:], cpu[1:], pg):
        err = np.linalg.norm(g - c) / max(np.linalg.norm(c), 1e-30)
        assert err <= 2 ** -4, (p.name, err)


# ---------------------------------------------------------------------------
# 4-D attention (#5, #6) and the ERNIE-layout saved-model path
# ---------------------------------------------------------------------------


def _heads(dev, B, S, H, D, dtype, seed=0):
    """q, k, v as the program hands them over: [B, H, S, D] head-split
    views (reshape + transpose) of one projection; a padded key bias."""
    qkv, bias = _qkv(dev, B, S, H, D, dtype, seed)
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
    return q, k, v, qkv, bias


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_mha_kernels_match_their_plain_versions(dev, D, dtype, causal,
                                                training):
    """#5 and #6 against their plain versions: test-mode scaling or
    training dropout, dbias on, S not a multiple of the tile."""
    H, S = 3, 150
    q, k, v, _, bias = _heads(dev, 2, S, H, D, dtype, seed=4)
    g = torch.Generator(device=dev).manual_seed(5)
    do = torch.randn(2, H, S, D, generator=g, device=dev).to(dtype)
    kw = dict(scale=1 / math.sqrt(D), dropout_rate=0.2, is_test=not training,
              causal=causal, seed=SEED if training else None)
    before = (fa.fused_attention.launches, fa.attention_grads.launches_dq,
              fa.attention_grads.launches_dkv)
    out = fa.fused_attention(q, k, v, bias, **kw)
    got = fa.attention_grads(q, k, v, bias, do, **kw)
    assert (fa.fused_attention.launches, fa.attention_grads.launches_dq,
            fa.attention_grads.launches_dkv) == tuple(n + 1 for n in before)
    _close(out, fa.reference(q, k, v, bias, **kw), "attention", dtype)
    want = fa.reference_bwd(q, k, v, bias, do, **kw)
    for a, w in zip(got[:3], want[:3]):
        _close(a, w, "attention_bwd", dtype)
    _close(got[3], want[3], "attention_bwd", torch.float32)


def test_mha_kernels_read_views_and_draw_the_packed_kernels_mask(dev):
    """On the head-split views of a projection (read in place) #5/#6 give
    the bits they give on contiguous copies, and the bits #1/#3 give on
    the projection itself, training dropout on (one mask)."""
    B, S, H, D = 2, 200, 4, 64
    q, k, v, qkv, bias = _heads(dev, B, S, H, D, torch.float32, seed=6)
    kw = dict(scale=0.125, dropout_rate=0.2, is_test=False, seed=SEED)
    do = torch.randn(B, S, H * D, device=dev)
    do4 = do.view(B, S, H, D).transpose(1, 2)
    out = fa.fused_attention(q, k, v, bias, **kw)
    grads = fa.attention_grads(q, k, v, bias, do4, **kw)
    copies = [t.contiguous() for t in (q, k, v)]
    assert torch.equal(out, fa.fused_attention(*copies, bias, **kw))
    again = fa.attention_grads(*copies, bias, do4.contiguous(), **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    packed = fa.fused_attention_qkv(qkv, H, bias, **kw)
    assert torch.equal(out.transpose(1, 2).reshape(B, S, H * D), packed)
    dqkv, dbias = fa.fused_attention_qkv_bwd(qkv, H, bias, do,
                                             want_dbias=True, **kw)
    cat = torch.cat([t.transpose(1, 2).reshape(B, S, H * D)
                     for t in grads[:3]], -1)
    assert torch.equal(cat, dqkv) and torch.equal(grads[3], dbias)


def _mha_counts():
    return (fa.fused_attention.launches, fa.attention_grads.launches_dq,
            fa.attention_grads.launches_dkv)


def test_mha_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Every shape the JAX package answers gets an answer, routed by shape
    and dtype (flash_attention.route): past S=1024 #7-#9 on the 4-D views
    (#7 twice: the backward runs the forward again for its lse), D=48 #5
    and #6 on heads zero-padded to 64, fp16 the plain version with no
    launch of ours; each against the plain version. Malformed inputs
    still raise, launching nothing."""
    f32 = torch.float32
    q, k, v, _, bias = _heads(dev, 1, 1025, 2, 64, f32)
    t0, m0 = _tiled_counts(), _mha_counts()
    kw = dict(scale=0.125, causal=True)
    out = fa.fused_attention(q, k, v, bias, causal=True)
    grads = fa.attention_grads(q, k, v, bias, q, causal=True)
    assert _tiled_counts() == (t0[0] + 2, t0[1] + 1, t0[2] + 1)
    assert _mha_counts() == m0
    _close(out, fa.reference(q, k, v, bias, **kw), "attention", f32)
    for a, w in zip(grads, fa.reference_bwd(q, k, v, bias, q, **kw)):
        _close(a, w, "attention_bwd", f32)

    q, k, v, _, bias = _heads(dev, 2, 70, 2, 48, f32)
    t0, m0 = _tiled_counts(), _mha_counts()
    out = fa.fused_attention(q, k, v, bias)
    grads = fa.attention_grads(q, k, v, bias, q)
    assert out.shape == q.shape and all(g.shape == q.shape for g in grads[:3])
    assert _mha_counts() == tuple(n + 1 for n in m0)
    assert _tiled_counts() == t0
    kw = dict(scale=1 / math.sqrt(48))
    _close(out, fa.reference(q, k, v, bias, **kw), "attention", f32)
    for a, w in zip(grads, fa.reference_bwd(q, k, v, bias, q, **kw)):
        _close(a, w, "attention_bwd", f32)

    q, k, v, _, bias = _heads(dev, 1, 16, 2, 64, f32)
    counts = (_tiled_counts(), _mha_counts())
    h = [t.half() for t in (q, k, v)]
    out = fa.fused_attention(*h, bias)
    assert out.dtype == torch.float16
    assert torch.equal(out, fa.reference(*h, bias, scale=0.125))
    fa.attention_grads(*h, bias, h[0])
    assert counts == (_tiled_counts(), _mha_counts())
    with pytest.raises(InvalidArgumentError):  # training without seed words
        fa.fused_attention(q, k, v, bias, dropout_rate=0.1, is_test=False)
    with pytest.raises(InvalidArgumentError):  # shapes differ
        fa.fused_attention(q, k[:, :1], v, bias)
    with pytest.raises(InvalidArgumentError):  # bias of another shape
        fa.fused_attention(q, k, v, bias[:, :8])
    with pytest.raises(InvalidArgumentError):  # d_out of another dtype
        fa.attention_grads(q, k, v, bias, q.bfloat16())
    assert counts == (_tiled_counts(), _mha_counts())


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D", [(1152, 64), (70, 48), (1152, 48)])
def test_routed_attention_matches_its_plain_versions(dev, S, D, dtype,
                                                     training):
    """The routed 4-D shapes (#7-#9 past S=1024, heads zero-padded from
    D=48 to 64) in fp32 and bf16, test mode and training dropout, causal
    with the key bias: out, dq, dk, dv and dbias against the plain
    versions, and the launches. The tiled plain backward takes the
    kernel's output, as the kernels' backward does."""
    q, k, v, _, bias = _heads(dev, 2, S, 3, D, dtype, seed=S + D)
    do = torch.randn(q.shape, device=dev).to(dtype)
    kw = dict(scale=1 / math.sqrt(D), causal=True, dropout_rate=0.2,
              is_test=not training, seed=SEED if training else None)
    t0, m0 = _tiled_counts(), _mha_counts()
    out = fa.fused_attention(q, k, v, bias, **kw)
    grads = fa.attention_grads(q, k, v, bias, do, **kw)
    if S > fa.MAX_SEQ:
        assert _tiled_counts() == (t0[0] + 2, t0[1] + 1, t0[2] + 1)
        assert _mha_counts() == m0
        tkw = dict(scale=kw["scale"], rate=0.2, is_test=not training,
                   causal=True)
        want, lse = ft.reference_fwd4(q, k, v, bias, kw["seed"], **tkw)
        gwant = ft.reference_bwd4(q, k, v, bias, kw["seed"], do, out, lse,
                                  **tkw)
    else:
        assert _mha_counts() == tuple(n + 1 for n in m0)
        assert _tiled_counts() == t0
        want = fa.reference(q, k, v, bias, **kw)
        gwant = fa.reference_bwd(q, k, v, bias, do, **kw)
    assert out.shape == q.shape
    _close(out, want, "attention", dtype)
    for a, w in zip(grads[:3], gwant[:3]):
        assert a.shape == q.shape
        _close(a, w, "attention_bwd", dtype)
    _close(grads[3], gwant[3], "attention_bwd", torch.float32)


def test_mha_classifier_trains_saves_and_serves_on_the_card(dev, tmp_path):
    """The ERNIE-layout classifier at BertConfig.tiny() widths: a training
    step on the card against the CPU, io.save/io.load bit for bit, and
    the exported model answered by the predictor on the card against the
    CPU predictor."""
    from paddle_tpu_torch import inference, io
    from torch_mha_classifier import build_mha_classifier, mha_feed

    cfg = BertConfig.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    with fluid.unique_name.guard():
        main, startup, loss, prob = build_mha_classifier(
            fluid, layers, cfg, -1, 64, False)
        with fluid.program_guard(main, startup):
            _, pg = Adam(1e-3).minimize(loss, startup)
    main.random_seed = startup.random_seed = 3
    feed = mha_feed(cfg, 4, 64, 0)
    fetch = [loss] + [g for _, g in pg]
    exe, gscope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=gscope)
    cscope = fluid.Scope()
    convert.state_from_numpy(convert.state_to_numpy(gscope), cscope,
                             fluid.CPUPlace(), program=main)
    before = (fa.fused_attention.launches, fa.attention_grads.launches_dq)
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gscope)
    assert (fa.fused_attention.launches - before[0],
            fa.attention_grads.launches_dq - before[1]) == (2, 2)
    cpu = fluid.Executor(fluid.CPUPlace()).run(main.clone(), feed=feed,
                                               fetch_list=fetch, scope=cscope)
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-5)
    for g, c in zip(gpu[1:], cpu[1:]):
        np.testing.assert_allclose(g, c, rtol=1e-3, atol=1e-5)

    path = str(tmp_path / "ernie")
    with fluid.scope_guard(gscope):
        io.save(main, path)
    loaded = fluid.Scope()
    with fluid.scope_guard(loaded):
        io.load(main, path, executor=exe)
    assert all(loaded.find_var(n).is_cuda
               and torch.equal(loaded.find_var(n), gscope.find_var(n))
               for n in loaded.local_var_names())
    model = str(tmp_path / "model")
    with fluid.scope_guard(gscope):
        io.save_inference_model(model, ["ids", "types", "mask"], [prob],
                                exe, main_program=main)
    inputs = [feed[k][:3] for k in ("ids", "types", "mask")]
    answers = []
    for place in (None, fluid.CPUPlace()):
        config = inference.AnalysisConfig(model, place=place)
        config.set_batch_buckets([4])
        answers.append(inference.create_paddle_predictor(config).run(
            inputs)[0].as_ndarray())
    assert answers[0].shape == (3, 2)
    np.testing.assert_allclose(answers[0], answers[1], atol=1e-5)


# (row0, col0) of the ring-block cases: the diagonal shard; a key shard
# wholly before the query shard; one wholly after it (every row masked);
# straddling ones, with wholly masked rows; tile-aligned offsets
RING_OFFSETS = [(0, 0), (512, 0), (0, 512), (40, 100), (100, 40), (64, 64)]


def _ring_inputs(dev, D, dtype):
    """q [2, 3, 200, D] and k, v [2, 3, 130, D] as strided head-split
    views of packed projections, dO, and fp32 accumulators already
    holding values (the backward adds into them)."""
    g = torch.Generator(device=dev).manual_seed(D)
    B, H, Sq, Sk = 2, 3, 200, 130
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
    kv = torch.randn(B, Sk, 2, H, D, generator=g, device=dev).to(dtype)
    do = torch.randn(B, H, Sq, D, generator=g, device=dev).to(dtype)
    acc = [torch.randn(B, H, n, D, generator=g, device=dev)
           for n in (Sq, Sk, Sk)]
    return (q.transpose(1, 2), kv[:, :, 0].transpose(1, 2),
            kv[:, :, 1].transpose(1, 2), do, acc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_ring_block_kernels_match_their_plain_versions(dev, D, dtype, causal):
    """#12-#14 against their plain versions at runtime offsets (rows that
    see no key: o = 0, lse = -1e30 exactly), Sq != Sk and neither a
    multiple of the tile, q, k, v read as strided views, fp32 outputs for
    either input dtype (both sides compute in fp32 from the same inputs:
    fp32 tolerances), the backward added into the accumulators; one
    launch of each kernel a case."""
    q, k, v, do, acc = _ring_inputs(dev, D, dtype)
    scale = 1 / math.sqrt(D)
    before = (rb.ring_block_fwd.launches, rb.ring_block_bwd.launches_dq,
              rb.ring_block_bwd.launches_dkv)
    for row0, col0 in RING_OFFSETS:
        args = (row0, col0, causal, scale)
        o, lse = rb.ring_block_fwd(q, k, v, *args)
        o_ref, lse_ref = rb.shard_fwd_ref(q, k, v, *args)
        assert o.dtype == lse.dtype == torch.float32
        _close(o, o_ref, "attention", torch.float32)
        torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=0)
        dead = lse_ref == rb.NEG_INF
        assert torch.equal(lse[dead], lse_ref[dead])
        assert not o[dead].any()
        # a global lse is finite on every row (the diagonal is visible)
        glse = torch.where(dead, torch.zeros_like(lse), lse)
        delta = (do.float() * o).sum(-1)
        got = rb.ring_block_bwd(q, k, v, do, glse, delta, *args,
                                *[a.clone() for a in acc])
        want = rb.add_shard_bwd_ref(q, k, v, do, glse, delta, *args,
                                    *[a.clone() for a in acc])
        for a, w in zip(got, want):
            _close(a, w, "attention_bwd", torch.float32)
    n = len(RING_OFFSETS)
    assert (rb.ring_block_fwd.launches, rb.ring_block_bwd.launches_dq,
            rb.ring_block_bwd.launches_dkv) == tuple(c + n for c in before)


def _ring_bwd_case(q, k, v, do, causal, row0=0, col0=0, seed=1):
    """The plain forward's lse (finite: wholly masked rows at 0) and
    delta, and fp32 accumulators already holding values, for the
    backward pair on (q, k, v, dO)."""
    scale = 1 / math.sqrt(q.shape[3])
    o, lse = rb.shard_fwd_ref(q, k, v, row0, col0, causal, scale)
    lse = torch.where(lse == rb.NEG_INF, torch.zeros_like(lse), lse)
    delta = (do.float() * o).sum(-1)
    g = torch.Generator(device=q.device).manual_seed(seed)
    acc = [torch.randn(t.shape, generator=g, device=q.device)
           for t in (q, k, v)]
    return (lse, delta, row0, col0, causal, scale), acc


def _ring_bwd_launches():
    return rb.ring_block_bwd.launches_dq, rb.ring_block_bwd.launches_dkv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_block_backward_gives_the_same_bits_twice(dev, dtype):
    """#13 and #14 sum in a fixed order (no atomics): two launches on the
    same inputs and accumulators give the same bits."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn(2, 3, 700, 64, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    args, acc = _ring_bwd_case(q, k, v, do, True)
    first = rb.ring_block_bwd(q, k, v, do, *args, *[a.clone() for a in acc])
    second = rb.ring_block_bwd(q, k, v, do, *args, *[a.clone() for a in acc])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _misaligned(dev, layout, B, H, S, D, dtype, parts, seed):
    """`parts` [B, H, S, D] views of one buffer whose rows the kernels
    cannot copy 16 bytes at a time: the base one element off a 16-byte
    boundary, or rows an odd number of elements apart."""
    g = torch.Generator(device=dev).manual_seed(seed)
    row = parts * H * D + (layout == "odd_row_stride")
    buf = torch.randn(1 + B * S * row, generator=g, device=dev).to(dtype)
    base = 1 if layout == "base_off_by_one" else 0
    return [buf.as_strided((B, H, S, D), (S * row, D, row, 1),
                           base + i * H * D) for i in range(parts)]


@pytest.mark.parametrize("layout", ["base_off_by_one", "odd_row_stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_block_backward_reads_misaligned_views(dev, dtype, layout):
    """Views whose rows are not 16-byte aligned take the kernels'
    synchronous copy path: they agree with the plain versions at the
    fp32 tolerance and count one launch of each kernel."""
    q, = _misaligned(dev, layout, 2, 3, 200, 64, dtype, 1, 5)
    k, v = _misaligned(dev, layout, 2, 3, 130, 64, dtype, 2, 6)
    do, = _misaligned(dev, layout, 2, 3, 200, 64, dtype, 1, 7)
    assert q.data_ptr() % 16 or q.stride(2) % 2
    for row0, col0 in [(40, 100), (0, 0)]:
        args, acc = _ring_bwd_case(q, k, v, do, True, row0, col0)
        before = _ring_bwd_launches()
        got = rb.ring_block_bwd(q, k, v, do, *args,
                                *[a.clone() for a in acc])
        assert _ring_bwd_launches() == (before[0] + 1, before[1] + 1)
        want = rb.add_shard_bwd_ref(q, k, v, do, *args,
                                    *[a.clone() for a in acc])
        for a, w in zip(got, want):
            _close(a, w, "attention_bwd", torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_block_backward_at_s8192_matches_the_plain_version(dev, dtype):
    """One head at the SP path's S=8192, D=64, causal: #13 and #14 sum
    over up to 8192 rows, against their plain versions at the fp32
    tolerance (fp32 outputs from either input dtype)."""
    g = torch.Generator(device=dev).manual_seed(8192)
    q, k, v, do = (torch.randn(1, 1, 8192, 64, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    args, acc = _ring_bwd_case(q, k, v, do, True)
    got = rb.ring_block_bwd(q, k, v, do, *args, *[a.clone() for a in acc])
    want = rb.add_shard_bwd_ref(q, k, v, do, *args, *[a.clone() for a in acc])
    for a, w in zip(got, want):
        _close(a, w, "attention_bwd", torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_block_forward_at_s8192_matches_the_plain_version(dev, dtype):
    """#12 on two heads at the SP path's S=8192, D=64, causal, at offsets
    (0, 0) and (4096, 0): an online softmax over up to 8192 keys, each
    tile's P V summed from zero on the tensor cores and added in fp32,
    against the plain version at the forward's fp32 tolerance and lse
    1e-5 (fp32 outputs from either input dtype)."""
    g = torch.Generator(device=dev).manual_seed(8193)
    q, k, v = (torch.randn(1, 2, 8192, 64, generator=g, device=dev)
               .to(dtype) for _ in range(3))
    for row0, col0 in [(0, 0), (4096, 0)]:
        args = (row0, col0, True, 0.125)
        o, lse = rb.ring_block_fwd(q, k, v, *args)
        o_ref, lse_ref = rb.shard_fwd_ref(q, k, v, *args)
        _close(o, o_ref, "attention", torch.float32)
        torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", ["base_off_by_one", "odd_row_stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_block_forward_reads_misaligned_views(dev, dtype, layout):
    """Views whose rows are not 16-byte aligned take #12's synchronous
    copy path: it agrees with the plain version (rows that see no key at
    o = 0, lse = -1e30 exactly) and counts one launch a call."""
    q, = _misaligned(dev, layout, 2, 3, 200, 64, dtype, 1, 5)
    k, v = _misaligned(dev, layout, 2, 3, 130, 64, dtype, 2, 6)
    assert q.data_ptr() % 16 or q.stride(2) % 2
    for row0, col0 in [(40, 100), (0, 0), (0, 512)]:
        args = (row0, col0, True, 0.125)
        before = rb.ring_block_fwd.launches
        o, lse = rb.ring_block_fwd(q, k, v, *args)
        assert rb.ring_block_fwd.launches == before + 1
        o_ref, lse_ref = rb.shard_fwd_ref(q, k, v, *args)
        _close(o, o_ref, "attention", torch.float32)
        dead = lse_ref == rb.NEG_INF
        assert torch.equal(lse[dead], lse_ref[dead]) and not o[dead].any()
        torch.testing.assert_close(lse[~dead], lse_ref[~dead], atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_block_forward_gives_the_same_bits_twice(dev, dtype):
    """#12 sums in a fixed order: two launches on the same inputs give
    the same o and lse bits."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(2, 3, 700, 64, generator=g, device=dev)
               .to(dtype) for _ in range(3))
    first, second = (rb.ring_block_fwd(q, k, v, 40, 100, True, 0.125)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_ring_block_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v, do, acc = _ring_inputs(dev, 64, torch.float32)
    before = (rb.ring_block_fwd.launches, rb.ring_block_bwd.launches_dq)
    with pytest.raises(InvalidArgumentError):  # fp16
        rb.ring_block_fwd(q.half(), k.half(), v.half(), 0, 0, True, 0.125)
    with pytest.raises(InvalidArgumentError):  # head dim 48
        rb.ring_block_fwd(q[..., :48], k[..., :48], v[..., :48], 0, 0,
                          True, 0.125)
    with pytest.raises(InvalidArgumentError):  # k on the CPU
        rb.ring_block_fwd(q, k.cpu(), v, 0, 0, True, 0.125)
    o, lse = rb.ring_block_fwd(q, k, v, 0, 0, True, 0.125)
    delta = (do * o).sum(-1)
    with pytest.raises(InvalidArgumentError):  # a bf16 accumulator
        rb.ring_block_bwd(q, k, v, do, lse, delta, 0, 0, True, 0.125,
                          acc[0].bfloat16(), acc[1], acc[2])
    with pytest.raises(InvalidArgumentError):  # lse of another layout
        rb.ring_block_bwd(q, k, v, do, lse.transpose(1, 2), delta, 0, 0,
                          True, 0.125, *acc)
    assert (rb.ring_block_fwd.launches,
            rb.ring_block_bwd.launches_dq) == (before[0] + 1, before[1])


@pytest.mark.parametrize("op", ["ring_attention", "ulysses_attention"])
def test_sp_program_on_a_one_rank_nccl_mesh_matches_the_cpu(dev, op):
    """build_sp_leg's program (tests/torch_sp_worker.py) at b=1, h=4,
    s=256, d=64 on a 1-rank NCCL "sp" mesh against the same program
    without a mesh on the CPU (the ring at n=1 is dense attention; the
    collectives over one rank are the identity), two SGD steps from one
    state. Each step launches #12 twice (the forward, and the grad op's
    forward again) and #13 and #14 once. Loss rtol 1e-5; gradients atol
    1e-5 + rtol 1e-3 (fp32 sums in other orders)."""
    from paddle_tpu_torch.parallel import (
        insert_grad_allreduce,
        make_mesh,
        shard_program,
    )
    from torch_sp_worker import build_sp_leg

    shape = (1, 4, 256, 64)
    main, startup, loss, pg = build_sp_leg(fluid, layers, fluid.unique_name,
                                           insert_grad_allreduce, shape, op)
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    convert.state_from_numpy(convert.state_to_numpy(cpu_scope), card_scope,
                             fluid.CUDAPlace(0), program=main)
    card_main = main.clone()
    mesh = make_mesh({"sp": 1})
    try:
        shard_program(card_main, mesh, {"x": (None, None, "sp")})
        x = np.random.RandomState(0).randn(*shape).astype(np.float32)
        fetch = [loss.name] + [g.name for _, g in pg]
        card = fluid.Executor(fluid.CUDAPlace(0))
        before = (rb.ring_block_fwd.launches, rb.ring_block_bwd.launches_dq,
                  rb.ring_block_bwd.launches_dkv)
        for _ in range(2):
            got = card.run(card_main, feed={"x": x}, fetch_list=fetch,
                           scope=card_scope)
            want = cpu.run(main, feed={"x": x}, fetch_list=fetch,
                           scope=cpu_scope)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
            for g, w, n in zip(got[1:], want[1:], fetch[1:]):
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-3,
                                           err_msg=n)
        assert (rb.ring_block_fwd.launches, rb.ring_block_bwd.launches_dq,
                rb.ring_block_bwd.launches_dkv) == (before[0] + 4,
                                                    before[1] + 2,
                                                    before[2] + 2)
    finally:
        mesh.close()


# ---------------------------------------------------------------------------
# the whole-row backward pair (#3/#6) on the tensor cores
# ---------------------------------------------------------------------------


def _pair_launches():
    return (fa.attention_grads.launches_dq, fa.attention_grads.launches_dkv,
            fa.fused_attention_qkv_bwd.launches_dq,
            fa.fused_attention_qkv_bwd.launches_dkv)


def _pair_kw(D, causal=False):
    return dict(scale=1 / math.sqrt(D), dropout_rate=0.1, is_test=False,
                causal=causal, seed=SEED)


@pytest.mark.parametrize("want_dbias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [100, 512, 1024])
def test_attention_backward_pair_matches_its_plain_version(dev, S, D, dtype,
                                                           causal,
                                                           want_dbias):
    """#6's two kernels (3xTF32 products on the tensor cores) on the
    head-split views of a projection, with training dropout 0.1 and a key
    bias with padded tails, against the plain version: S = 100 (no
    multiple of the 64-row tile), 512 (BERT's) and 1024 (the whole-row
    cap); dbias computed (sum_partials) or not. One launch of each."""
    q, k, v, _, bias = _heads(dev, 2, S, 3, D, dtype, seed=S + D)
    g = torch.Generator(device=dev).manual_seed(7)
    do = torch.randn(2, 3, S, D, generator=g, device=dev).to(dtype)
    kw = _pair_kw(D, causal)
    before = _pair_launches()
    got = fa.attention_grads(q, k, v, bias, do, want_dbias=want_dbias, **kw)
    assert _pair_launches() == (before[0] + 1, before[1] + 1) + before[2:]
    want = fa.reference_bwd(q, k, v, bias, do, **kw)
    for a, w in zip(got[:3], want[:3]):
        _close(a, w, "attention_bwd", dtype)
    if want_dbias:
        _close(got[3], want[3], "attention_bwd", torch.float32)
    else:
        assert got[3] is None


@pytest.mark.parametrize("layout", ["packed", "head_split",
                                    "base_off_by_one", "odd_row_stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_pair_reads_every_layout(dev, dtype, layout):
    """The pair reads its operands in place: the packed projection (#3,
    rows 3*H*D apart), its head-split views (#6), and views whose rows are
    not 16-byte aligned (the base one element off, or rows an odd number
    of elements apart: the kernels' synchronous copy path), causal, with
    training dropout and dbias, against the plain versions."""
    B, S, H, D = 2, 200, 3, 64
    kw = _pair_kw(D, causal=True)
    g = torch.Generator(device=dev).manual_seed(9)
    before = _pair_launches()
    if layout == "packed":
        qkv, bias = _qkv(dev, B, S, H, D, dtype, seed=8)
        do = torch.randn(B, S, H * D, generator=g, device=dev).to(dtype)
        dqkv, dbias = fa.fused_attention_qkv_bwd(qkv, H, bias, do,
                                                 want_dbias=True, **kw)
        assert _pair_launches() == before[:2] + (before[2] + 1,
                                                 before[3] + 1)
        want_q, want_b = fa.reference_qkv_bwd(qkv, H, bias, do, **kw)
        _close(dqkv, want_q, "attention_bwd", dtype)
        _close(dbias, want_b, "attention_bwd", torch.float32)
        return
    if layout == "head_split":
        q, k, v, _, bias = _heads(dev, B, S, H, D, dtype, seed=8)
    else:
        q, k, v = _misaligned(dev, layout, B, H, S, D, dtype, 3, 8)
        _, bias = _qkv(dev, B, S, H, D, dtype, seed=8)
        assert q.data_ptr() % 16 or q.stride(2) % 2
    do = torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
    got = fa.attention_grads(q, k, v, bias, do, **kw)
    assert _pair_launches() == (before[0] + 1, before[1] + 1) + before[2:]
    want = fa.reference_bwd(q, k, v, bias, do, **kw)
    for a, w in zip(got[:3], want[:3]):
        _close(a, w, "attention_bwd", dtype)
    _close(got[3], want[3], "attention_bwd", torch.float32)


@pytest.mark.parametrize("layout", ["packed", "head_split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_pair_gives_the_same_bits_twice(dev, dtype,
                                                           layout):
    """Fixed-order sums and no float atomics: two launches of the pair on
    the same inputs give the same dq, dk, dv and dbias bits."""
    B, S, H, D = 2, 700, 3, 64
    kw = _pair_kw(D)
    if layout == "packed":
        qkv, bias = _qkv(dev, B, S, H, D, dtype, seed=10)
        do = torch.randn(B, S, H * D, device=dev).to(dtype)
        first, second = (fa.fused_attention_qkv_bwd(qkv, H, bias, do,
                                                    want_dbias=True, **kw)
                         for _ in range(2))
    else:
        q, k, v, _, bias = _heads(dev, B, S, H, D, dtype, seed=10)
        do = torch.randn(B, H, S, D, device=dev).to(dtype)
        first, second = (fa.attention_grads(q, k, v, bias, do, **kw)
                         for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the whole-row forward (#1/#5) on the tensor cores
# ---------------------------------------------------------------------------


def _fwd_launches():
    return fa.fused_attention_qkv.launches, fa.fused_attention.launches


@pytest.mark.parametrize("layout", ["packed", "head_split",
                                    "packed_base_off_by_one",
                                    "base_off_by_one", "odd_row_stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_forward_reads_every_layout(dev, dtype, layout):
    """The forward reads its operands in place: the packed projection
    (#1), its head-split views (#5), and views whose rows are not 16-byte
    aligned (a projection one element off, 4-D views one element off or
    rows an odd number of elements apart: the kernel's synchronous copy
    path), causal, with training dropout, against the plain versions;
    one launch a call."""
    B, S, H, D = 2, 200, 3, 64
    kw = dict(scale=0.125, dropout_rate=0.2, is_test=False, seed=SEED,
              causal=True)
    before = _fwd_launches()
    _, bias = _qkv(dev, B, S, H, D, dtype, seed=11)
    if layout.startswith("packed"):
        qkv, _ = _qkv(dev, B, S, H, D, dtype, seed=11)
        if layout == "packed_base_off_by_one":
            buf = torch.empty(1 + qkv.numel(), device=dev, dtype=dtype)
            qkv = buf[1:].view(qkv.shape).copy_(qkv)
            assert qkv.data_ptr() % 16
        got = fa.fused_attention_qkv(qkv, H, bias, **kw)
        assert _fwd_launches() == (before[0] + 1, before[1])
        _close(got, fa.reference_qkv(qkv, H, bias, **kw), "attention", dtype)
        return
    if layout == "head_split":
        q, k, v, _, _ = _heads(dev, B, S, H, D, dtype, seed=11)
    else:
        q, k, v = _misaligned(dev, layout, B, H, S, D, dtype, 3, 11)
        assert q.data_ptr() % 16 or q.stride(2) % 2
    got = fa.fused_attention(q, k, v, bias, **kw)
    assert _fwd_launches() == (before[0], before[1] + 1)
    _close(got, fa.reference(q, k, v, bias, **kw), "attention", dtype)


@pytest.mark.parametrize("layout", ["packed", "head_split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_forward_gives_the_same_bits_twice(dev, dtype, layout):
    """Two launches of the forward on the same inputs give the same bits
    (each output element is summed by one thread in a fixed order)."""
    B, S, H, D = 2, 700, 3, 64
    kw = dict(scale=0.125, dropout_rate=0.1, is_test=False, seed=SEED,
              causal=True)
    if layout == "packed":
        qkv, bias = _qkv(dev, B, S, H, D, dtype, seed=12)
        first, second = (fa.fused_attention_qkv(qkv, H, bias, **kw)
                         for _ in range(2))
    else:
        q, k, v, _, bias = _heads(dev, B, S, H, D, dtype, seed=12)
        first, second = (fa.fused_attention(q, k, v, bias, **kw)
                         for _ in range(2))
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 37, 64, 65, 130])
def test_attention_forward_takes_every_sequence_length(dev, S, D, dtype):
    """S below one 64-row tile, at it, one past it and not a multiple of
    it, every head dim, both dtypes: test mode without a mask, and
    causal with training dropout, against the plain version."""
    H = 2
    qkv, bias = _qkv(dev, 2, S, H, D, dtype, seed=S)
    for kw in (dict(scale=1 / math.sqrt(D), dropout_rate=0.1, is_test=True),
               dict(scale=1 / math.sqrt(D), dropout_rate=0.2, is_test=False,
                    seed=SEED, causal=True)):
        got = fa.fused_attention_qkv(qkv, H, bias, **kw)
        _close(got, fa.reference_qkv(qkv, H, bias, **kw), "attention", dtype)


# ---------------------------------------------------------------------------
# the KV-tiled forward (#7) on the tensor cores: the whole-row forward's
# body with the lse row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1025, 1537, 2049])
def test_tiled_forward_takes_every_length_past_1024(dev, S, D, dtype,
                                                    causal):
    """#7 past S=1024 at lengths no multiple of the 64-row tile (the
    causal diagonal's last tile and the sequence end cut one tile), every
    head dim (D=128 streams key tiles of 32), both dtypes, causal or not,
    with a padded key bias and training dropout: out within the forward
    tolerance and lse within 1e-5 of the plain version; one launch."""
    H = 2
    qkv, bias = _qkv(dev, 2, S, H, D, dtype, seed=S + D)
    kw = dict(scale=1 / math.sqrt(D), rate=0.1, is_test=False,
              causal=causal)
    before = _tiled_counts()
    out, lse = ft.flash_tiled_fwd(qkv, bias, SEED, H, D, **kw)
    assert _tiled_counts() == (before[0] + 1, before[1], before[2])
    want_o, want_l = ft.reference_fwd(qkv, bias, SEED, H, D, **kw)
    _close(out, want_o, "attention", dtype)
    torch.testing.assert_close(lse, want_l, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", ["base_off_by_one", "odd_row_stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_forward_reads_misaligned_views(dev, dtype, layout):
    """The 4-D op past S=1024 on views whose rows are not 16-byte aligned
    (the base one element off, or rows an odd number of elements apart)
    takes #7's synchronous copy path: one launch of #7, out within the
    forward tolerance of the plain tiled version, causal, with training
    dropout."""
    B, S, H, D = 2, 1100, 3, 64
    q, k, v = _misaligned(dev, layout, B, H, S, D, dtype, 3, 15)
    _, bias = _qkv(dev, B, S, H, D, dtype, seed=15)
    assert q.data_ptr() % 16 or q.stride(2) % 2
    fkw = dict(scale=0.125, dropout_rate=0.1, is_test=False, causal=True,
               seed=SEED)
    before = _tiled_counts()
    got = fa.fused_attention(q, k, v, bias, **fkw)
    assert _tiled_counts() == (before[0] + 1, before[1], before[2])
    want, _ = ft.reference_fwd4(q, k, v, bias, SEED, scale=0.125, rate=0.1,
                                is_test=False, causal=True)
    _close(got, want, "attention", dtype)


@pytest.mark.parametrize("layout", ["packed", "four_d", "odd_row_stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_forward_gives_the_same_bits_twice(dev, dtype, layout):
    """Two launches of #7 on the same inputs give the same out (and lse)
    bits: each output element is summed by one thread in a fixed order."""
    B, S, H, D = 2, 1300, 3, 64
    kw = _tiled_kw(D)
    if layout == "packed":
        qkv, bias = _qkv(dev, B, S, H, D, dtype, seed=16)
        first, second = (ft.flash_tiled_fwd(qkv, bias, SEED, H, D, **kw)
                         for _ in range(2))
    else:
        if layout == "four_d":
            q, k, v, _, bias = _heads(dev, B, S, H, D, dtype, seed=16)
        else:
            q, k, v = _misaligned(dev, layout, B, H, S, D, dtype, 3, 16)
            _, bias = _qkv(dev, B, S, H, D, dtype, seed=16)
        fkw = dict(scale=kw["scale"], dropout_rate=kw["rate"],
                   is_test=False, causal=True, seed=SEED)
        first, second = ((fa.fused_attention(q, k, v, bias, **fkw),)
                         for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the KV-tiled backward pair (#9 dq, #8 dkv) on the tensor cores
# ---------------------------------------------------------------------------


def _tiled_kw(D, training=True):
    return dict(scale=1 / math.sqrt(D), rate=0.1, is_test=not training,
                causal=True)


@pytest.mark.parametrize("layout", ["packed", "four_d", "base_off_by_one",
                                    "odd_row_stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_backward_pair_reads_every_layout(dev, dtype, layout):
    """#9 and #8 (3xTF32 products on the tensor cores) read their operands
    in place: the packed projection (flash_tiled_bwd, rows 3*H*D apart),
    the 4-D op's head-split views past S=1024 (attention_grads), and views
    whose rows are not 16-byte aligned (the base one element off, or rows
    an odd number of elements apart: the kernels' synchronous copy path);
    S=1100 (no multiple of the 64-row tile), causal, training dropout and
    dbias, against the plain tiled versions. One launch of each."""
    B, S, H, D = 2, 1100, 3, 64
    kw = _tiled_kw(D)
    g = torch.Generator(device=dev).manual_seed(11)
    if layout == "packed":
        qkv, bias = _qkv(dev, B, S, H, D, dtype, seed=12)
        do = torch.randn(B, S, H * D, generator=g, device=dev).to(dtype)
        out, lse = ft.flash_tiled_fwd(qkv, bias, SEED, H, D, **kw)
        before = _tiled_counts()
        dqkv, dbias = ft.flash_tiled_bwd(qkv, bias, SEED, do, out, lse, H,
                                         D, want_dbias=True, **kw)
        assert _tiled_counts() == (before[0], before[1] + 1, before[2] + 1)
        want_q, want_b = ft.reference_bwd(qkv, bias, SEED, do, out, lse, H,
                                          D, **kw)
        _close(dqkv, want_q, "attention_bwd", dtype)
        _close(dbias, want_b, "attention_bwd", torch.float32)
        return
    if layout == "four_d":
        q, k, v, _, bias = _heads(dev, B, S, H, D, dtype, seed=12)
        do = torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
    else:
        q, k, v = _misaligned(dev, layout, B, H, S, D, dtype, 3, 12)
        do, = _misaligned(dev, layout, B, H, S, D, dtype, 1, 13)
        _, bias = _qkv(dev, B, S, H, D, dtype, seed=12)
        assert q.data_ptr() % 16 or q.stride(2) % 2
    fkw = dict(scale=kw["scale"], dropout_rate=kw["rate"], is_test=False,
               causal=True, seed=SEED)
    out = fa.fused_attention(q, k, v, bias, **fkw)
    before = _tiled_counts()
    got = fa.attention_grads(q, k, v, bias, do, **fkw)
    # the 4-D op saves no lse: its backward runs #7 once more
    assert _tiled_counts() == tuple(n + 1 for n in before)
    _, lse = ft.reference_fwd4(q, k, v, bias, SEED, **kw)
    want = ft.reference_bwd4(q, k, v, bias, SEED, do, out, lse, **kw)
    for a, w in zip(got[:3], want[:3]):
        _close(a, w, "attention_bwd", dtype)
    _close(got[3], want[3], "attention_bwd", torch.float32)


@pytest.mark.parametrize("layout", ["packed", "four_d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_backward_pair_gives_the_same_bits_twice(dev, dtype, layout):
    """Fixed-order sums and no float atomics: two launches of #9/#8 on the
    same inputs give the same dq, dk, dv and dbias bits."""
    B, S, H, D = 2, 1300, 3, 64
    kw = _tiled_kw(D)
    if layout == "packed":
        qkv, bias = _qkv(dev, B, S, H, D, dtype, seed=14)
        do = torch.randn(B, S, H * D, device=dev).to(dtype)
        out, lse = ft.flash_tiled_fwd(qkv, bias, SEED, H, D, **kw)
        first, second = (ft.flash_tiled_bwd(qkv, bias, SEED, do, out, lse,
                                            H, D, want_dbias=True, **kw)
                         for _ in range(2))
    else:
        q, k, v, _, bias = _heads(dev, B, S, H, D, dtype, seed=14)
        do = torch.randn(B, H, S, D, device=dev).to(dtype)
        fkw = dict(scale=kw["scale"], dropout_rate=kw["rate"],
                   is_test=False, causal=True, seed=SEED)
        first, second = (fa.attention_grads(q, k, v, bias, do, **fkw)
                         for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 128])
def test_tiled_kernels_take_every_head_dim_in_bf16(dev, D, causal):
    """#7-#9 at S=1100 with D=32 and D=128 (#9/#8 stream tiles of 32 rows
    at D=128) on bf16 inputs, training dropout and dbias, against the
    plain tiled versions."""
    qkv, bias = _qkv(dev, 2, 1100, 2, D, torch.bfloat16, seed=D + 1)
    do = torch.randn(2, 1100, 2 * D, device=dev).to(torch.bfloat16)
    kw = dict(scale=D ** -0.5, rate=0.2, is_test=False, causal=causal)
    out, lse = ft.flash_tiled_fwd(qkv, bias, SEED, 2, D, **kw)
    dqkv, dbias = ft.flash_tiled_bwd(qkv, bias, SEED, do, out, lse, 2, D,
                                     want_dbias=True, **kw)
    want_o, _ = ft.reference_fwd(qkv, bias, SEED, 2, D, **kw)
    want_q, want_b = ft.reference_bwd(qkv, bias, SEED, do, out, lse, 2, D,
                                      **kw)
    _close(out, want_o, "attention", torch.bfloat16)
    _close(dqkv, want_q, "attention_bwd", torch.bfloat16)
    _close(dbias, want_b, "attention_bwd", torch.float32)
