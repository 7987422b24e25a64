#!/usr/bin/env python3
"""Smoke run of the paddle_tpu_torch port on one NVIDIA card.

    python3 chip_smoke.py          (from the repository root; one CUDA card)

Phases, each fatal on failure:

1. device: require a card, print its name and power limit, turn TF32 off;
2. build: compile every hand-written kernel from paddle_tpu_torch/kernels/
   csrc with nvcc, one process per source, all started together;
3. parity: hold each kernel against its plain PyTorch version on the card,
   at the serving path's shapes in test mode, and at the training path's
   shapes with training dropout (both draw the same Philox mask), forward
   and backward, in fp32 and bf16; check the kernels' keep mask against
   the plain one, its keep rate and its independence from the tiling; the
   KV-tiled kernels at S = 1152 and 2048, training dropout on and off; the
   standalone LayerNorm kernels (#10, #11) at [8192, 768] and R = 1001,
   fp32 and bf16, scale and bias fp32, bf16 or absent, and #11's bits
   equal over two runs; the 4-D kernels (#5, #6) at B=32, S=512 and small
   shapes, fp32 and bf16, with and without the key bias, causal, test
   mode and training dropout, and on the heads of a packed projection
   against #1/#3 on the projection (the same bits);
4. serving path: build the BERT-base classifier of bench_serving.py's
   bert_classify mix (full width, random weights from a seed), freeze it,
   serve requests through paddle_tpu_torch.serving.Server, check every
   answer against a direct run on the card and against the same frozen
   program run by the port on the CPU, and check from the launch counters
   that every served batch went through both forward kernels; then the
   server's requests/s, p50 and p99 latency at each bucket (median and
   spread of several windows of at least 1000 requests);
5. training, reduced depth: bench.py's bench_bert program at BERT-base
   width with 2 layers, B=2, S=128, no dropout, Adam at a constant lr,
   two steps on the card and on the CPU from one state: loss, every
   @GRAD and the parameters after Adam agree;
6. training path: bench_bert's program at BertConfig.base(), B=32, S=512,
   P=2457, dropout 0.1, Adam under linear warmup over polynomial decay,
   fp32: 3 warm-up and 5 timed steps through Executor.run, then one
   under torch.profiler and one with the host's time taken by op type;
   every loss finite, the weights held at lr 0 and moved after, the step
   counter advanced, and each step launched 12 attention forward, 12 + 12
   attention backward, 24 residual forward and 24 residual backward
   kernels; step time, tokens/s, peak memory, the profiled step's card
   busy time by kind of kernel, idle share and host-device
   synchronisations, and the host's ms in each op type's emitters;
7. GPT training, reduced depth: bench.py's bench_gpt_longctx program at
   GPT-small width with 2 layers, B=1, S=2048 (the KV-tiled path), no
   dropout, two Adam steps on the card and on the CPU from one state,
   under phase 5's tolerances;
8. GPT training path: bench_gpt_longctx at GPT-small (V=32000), B=4,
   S=2048, dropout 0.1, Adam(1e-4), fp32 (the yardstick of its AMP
   training in phase 12): 3 warm-up and 5 timed steps, one under
   torch.profiler, one timed by op type; every step launches the tiled
   forward, dq and dkv kernels 12 times each and the whole-row attention
   never;
9. GPT serving path: GPTConfig.small() through the KV-cache generator
   (batch 8, context 128, 128 new tokens) behind serving.Server on a
   generate endpoint; the served tokens against full recompute on the card
   (the whole-row kernel, causal, test mode), near-ties counted, and the
   prefill and first decode step's logits against the CPU;
10. AMP, reduced depth: phase 7's program under bench.py's `_amp` (bf16,
   static loss scale 1.0, layer_norm and softmax white-listed) with
   FLAGS_paddle_tpu_pallas_layer_norm on, two Adam steps on the card and
   on the CPU from one state, under bf16 tolerances (AMP_TOL), with the
   share of exempt update elements under its cap;
11. BERT AMP path: phase 6's step under `_amp`: every loss finite, the
   weights held at lr 0 and moved after, the loss scale still 1.0 and
   good_steps counting the steps, #1 12, #3 12 + 12, #2 24 and #4 24
   launches a step on bf16 activations; the same figures as phase 6, the
   rewritten program's op count and the cost of check_finite_and_unscale
   and of its unread outputs;
12. GPT AMP path: phase 8's step under `_amp`, twice: with the flag off
   (bench.py's default; #10/#11 never launch) and on (#10 and #11 25
   times each a step, and #11's sum_partials as often); #7-#9 12 times
   each a step in both; the same figures as phase 8;
13. ERNIE-layout training, reduced depth: the classifier of phase 14 at 2
   layers, B=2, S=128, no dropout, two Adam steps on the card and on the
   CPU from one state, under phase 5's tolerances;
14. ERNIE-layout path: a classifier at BertConfig.base() widths whose
   layers project query, key and value with three fc's, split heads with
   reshape + transpose and attend through layers.fused_multihead_attention
   (#5, #6), B=32, S=512, dropout 0.1, Adam(1e-4), fp32: 3 warm-up and 5
   timed steps, one profiled, one timed by op type, #5 and #6 12 times
   each a step and #1/#3 never; then io.save -> io.load into a fresh scope
   (every persistable bit-equal), one step from the saved scope and one
   from the loaded scope on the program read back from the .pdmodel (loss
   and persistables bit-equal), save_persistables/load_persistables the
   same, the files in a temporary directory that is deleted; then
   io.save_inference_model and inference.create_paddle_predictor with
   batch buckets (1, 2, 4, 8), fp32 and enable_bf16(): batches 1, 2, 3, 4,
   6 and 8 at S=512 against a direct Executor.run of the predictor's
   program, #5 12 times a predicted batch, the bf16 program's attention on
   bf16 q, k, v, run_zero_copy, latency by bucket;
15. sequence parallelism, kernels (run after phase 3's parity): the ring
   blocks #12-#14 against their plain versions at runtime causal offsets
   (row0, col0), causal and not, fp32 and bf16 inputs, rows that see no
   key (o = 0, lse = -1e30 exactly), the backward added into
   accumulators, the backward also on views whose rows are not 16-byte
   aligned (its synchronous copy path); the attention kernels as built,
   every one on the tensor cores, the backward pairs #13/#14, #3/#6 and
   #9/#8 and the forwards #1/#5, #7 and #12 (run after phase 3's
   parity): the tensor-core instructions (HMMA) of each instance in its
   library's SASS, its blocks an SM and shared memory, and the residual
   backward #4's blocks an SM; the port's ring forward and backward
   (ring_fwd_steps, ring_bwd_steps) for n=4 shards in one process over
   an in-process exchange (drive_lockstep), against dense attention, each
   kernel
   launched once per live shard (1 + 2 + 3 + 4); the attention shapes the
   4-D op takes only routed: S > 1024 on #7-#9 (4-D views), D=48 on
   heads zero-padded to 64, fp16 on the plain version with no launch;
16. SP training path: __graft_entry__.py's sp_ring leg (build_sp_leg: fc
   projections, causal ring or Ulysses attention over "sp", the global
   loss through mp_allreduce_sum, SGD, c_allreduce_sum on every gradient)
   at x [1, 12, 8192, 64] fp32 on a 1-rank NCCL "sp" mesh, ring and
   Ulysses: 3 warm-up and 5 timed steps, one profiled, one timed by op
   type; every loss finite, every weight moved; #12 twice, #13 and #14
   once a step, nothing else of ours; then the same program at S=1024,
   two steps on the card (NCCL) and on the CPU (a 1-rank gloo mesh) from
   one state, under phase 5's tolerances;
17. kernel times: each kernel beside its plain version, its bound and one
   PyTorch call, at the serving, the BERT training (#1 and the backward
   pair #3 also in bf16 at the BERT AMP path's activations, beside
   SDPA's bf16 forward and backward) and the GPT shapes (#7 also in bf16
   at the GPT AMP path's activations beside SDPA's bf16 causal forward;
   the tiled backward pair #9/#8 with its TFLOP/s and the 3xTF32 bound
   beside the fp32 one, and again in bf16 at the GPT AMP path's
   activations against the plain version, beside SDPA's bf16 causal
   backward), #10/#11 at the GPT AMP path's [8192, 768] in bf16 (an fp32
   line printed beside), #5/#6 at the ERNIE-layout path's shapes (#5
   also at the predictor's bucket 8, test mode, fp32 and bf16; #6 with
   its TFLOP/s, the 3xTF32 bound beside the fp32 one, two launches that
   give the same bits, and head 0 against fp64), and #12-#14 at the SP
   path's [1, 12, 8192, 64] fp32, causal (scaled_dot_product_attention
   causal as the yardstick; #13/#14 with two launches that give the same
   bits). The kernels on the tensor cores, the forwards #1/#5 and #12
   and the backward pairs, carry their TFLOP/s of products and the bound
   of their 3xTF32 arithmetic, with the fp32 CUDA-core bound beside it.

The line before the last is the card's name and power limit; the line
before that is a JSON object with one entry per kernel and path. The last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when there is no CUDA card or any phase fails.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 2024
SEQ = 128
BUCKETS = (1, 2, 4, 8)
RATE = 0.1
# server timing: each window lasts at least this long and this many
# requests; each bucket gets WINDOW_REPS windows
WINDOW_S = 5.0
WINDOW_REQUESTS = 1000
WINDOW_REPS = 3
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; operations/s of fp32
# outside the tensor cores, and of dense bf16 and TF32 ("tf32") on them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32": 495e12}
# kernel vs plain version on the card, |got - want| <= atol + rtol*|want|,
# per kernel and dtype. fp32: sums in another order (observed on the H100
# up to 9.5e-7 for attention, 1.2e-6 for the residual). bf16: both sum in
# fp32 from the same bf16 inputs and round the output once to 8 mantissa
# bits, which may land one unit apart (at most 2^-7 of |want|), beside the
# fp32 term
TOL = {
    "attention": {torch.float32: (5e-6, 0.0),
                  torch.bfloat16: (5e-6, 2 ** -7)},
    "residual": {torch.float32: (5e-6, 0.0),
                 torch.bfloat16: (5e-6, 2 ** -7)},
    # backward: dq, dk, dv and dbias are sums over up to S=512 rows of
    # terms of magnitude ~1, and dg, dc over 2048 rows, in other orders
    "attention_bwd": {torch.float32: (5e-5, 0.0),
                      torch.bfloat16: (5e-5, 2 ** -7)},
    "residual_bwd": {torch.float32: (5e-5, 0.0),
                     torch.bfloat16: (5e-5, 2 ** -7)},
    "residual_sums": {torch.float32: (1e-3, 1e-5),
                      torch.bfloat16: (1e-3, 1e-5)},
    # the tiled forward's row logsumexp, fp32 for both input dtypes: a
    # log of up to 2048 terms summed in another order, values near 10
    "lse": {torch.float32: (1e-5, 0.0)},
    # the standalone LayerNorm (#10, #11): as the residual kernels; its
    # fp32 statistics, and its column sums over up to 8192 rows
    "layer_norm": {torch.float32: (5e-6, 0.0),
                   torch.bfloat16: (5e-6, 2 ** -7)},
    "layer_norm_bwd": {torch.float32: (5e-5, 0.0),
                       torch.bfloat16: (5e-5, 2 ** -7)},
    "ln_stats": {torch.float32: (5e-6, 1e-5)},
    "ln_sums": {torch.float32: (1e-3, 1e-5)},
}
# training parity (phases 3 and 6): BERT's dropout, seed words of a mask
TRAIN_RATE = 0.1
MASK_SEED = (0x2024ABCD, 0x5EED0001)
# reduced-depth card vs CPU training (phase 5), fp32 both, sums in other
# orders: loss rtol 1e-5; every @GRAD atol 1e-5 + rtol 1e-3; moments atol
# 1e-7 + rtol 1e-3; beta powers and lr rtol 1e-6. Each parameter's update
# over the two steps (end - start) within 1e-3 of (|update| + lr): a step
# moves a weight by about lr, so its error scales with lr even where the
# second step undoes the first. Exempt are the elements whose card and CPU
# gradients differ by more than 1e-4 of the CPU's at a step: Adam's step
# follows that disagreement, and near a zero gradient (a first-step
# gradient of ~1e-8 against Adam's epsilon of 1e-8) its size and sign.
# They are counted and must stay under 2% of the elements
SMALL_LR = 1e-3
FP32_TOL = dict(loss=1e-5, grad=("elementwise", 1e-5, 1e-3),
                moment=("elementwise", 1e-7, 1e-3), update=(1e-3, 1e-4, 0.02))
# the same under AMP (bf16 activations and gradients on both sides; a
# bf16 unit is 2^-8 relative), as tests/test_torch_gpt_amp.py holds the
# port against the JAX package: cuBLAS and the CPU round their bf16
# matmuls' sums at other places, so a gradient is held by its relative
# L2 error and an update by the elements whose gradients agree within
# 2^-4; the rest are exempt (an element whose gradient is rounding noise,
# as the key bias's, may move the other way under Adam) and must stay
# under 20% of the elements. Loss rtol one bf16 unit; @GRAD relative L2
# 2^-4; moments 2^-3 (moment2 squares the error); updates 2^-4 of
# (|update| + lr)
AMP_TOL = dict(loss=2 ** -8, grad=("l2", 2 ** -4), moment=("l2", 2 ** -3),
               update=(2 ** -4, 2 ** -4, 0.2))
# served / direct / CPU probabilities: 12 fp32 layers summed in other orders
PROB_ATOL = 1e-4
# bench_gpt_longctx's batch and sequence on an accelerator
GPT_B, GPT_S = 4, 2048
# the flag that routes layer_norm through #10/#11
LN_FLAG = "FLAGS_paddle_tpu_pallas_layer_norm"
# GPT serving (GPTConfig.small()): a batch of 8 generates 128 tokens after
# a context of 128 (full recompute at S=256); prefill and decode logits on
# the card vs the CPU, and the top two logits of a near-tie, within 1e-4
GEN_BATCH, GEN_CTX, GEN_MAX, GEN_NEW, GEN_ROUNDS = 8, 128, 256, 128, 3
LOGIT_ATOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def counters(fa, fr, sp, ft, lnk, rb):
    """{kernel: (wrapper, attribute)} of every launch counter."""
    return {
        "ring_fwd": (rb.ring_block_fwd, "launches"),
        "ring_bwd_dq": (rb.ring_block_bwd, "launches_dq"),
        "ring_bwd_dkv": (rb.ring_block_bwd, "launches_dkv"),
        "layer_norm_fwd": (lnk.layer_norm_fwd, "launches"),
        "layer_norm_bwd": (lnk.layer_norm_bwd, "launches"),
        "attention_fwd": (fa.fused_attention_qkv, "launches"),
        "attention_bwd_dq": (fa.fused_attention_qkv_bwd, "launches_dq"),
        "attention_bwd_dkv": (fa.fused_attention_qkv_bwd, "launches_dkv"),
        "residual_fwd": (fr.fused_dropout_add_ln_fwd, "launches"),
        "residual_bwd": (fr.fused_dropout_add_ln_bwd, "launches"),
        "sum_partials": (sp.sum_partials, "launches"),
        "tiled_fwd": (ft.flash_tiled_fwd, "launches"),
        "tiled_bwd_dq": (ft.flash_tiled_bwd, "launches_dq"),
        "tiled_bwd_dkv": (ft.flash_tiled_bwd, "launches_dkv"),
        "mha_fwd": (fa.fused_attention, "launches"),
        "mha_bwd_dq": (fa.attention_grads, "launches_dq"),
        "mha_bwd_dkv": (fa.attention_grads, "launches_dkv"),
    }


def reset_counts(kc):
    for obj, attr in kc.values():
        setattr(obj, attr, 0)


def read_counts(kc):
    return {name: getattr(obj, attr) for name, (obj, attr) in kc.items()}


def ptxas_usage(report):
    """[(kernel, registers, spill line)] from ptxas -v output: each entry
    function's name (with its dtype, its head dim or chunk count, and #4's
    copy path where it is a template), its spills and its registers."""
    out, kernel, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"entry function '.*?\d+([a-z_]+_kernel)(I\w*)?",
                      line)
        if m:
            kernel, spill = m.group(1), ""
            args = m.group(2) or ""
            if args:
                dtype = "bf16" if "bfloat16" in args else "f32"
                dim = re.search(r"Li(\d+)E", args)
                # #4's copy path: 16-byte vectors or element by element
                vec = re.search(r"Lb([01])E", args)
                tags = [dtype] + ([dim.group(1)] if dim else []) + (
                    [("elem", "vec")[int(vec.group(1))]] if vec else [])
                kernel += f"<{', '.join(tags)}>"
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and kernel:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((kernel, regs, spill))
            kernel = None
    return out


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=40, reps=7):
    """Median device time of one call of fn, in ms. A sleep kernel holds
    the stream while the host queues the timed calls, so the events
    bracket device work rather than the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def launch_ms(fn, entries, iters=10, reps=3):
    """{entry: median device time in ms of one launch} of each kernel
    library entry point in `entries` ((library, function) names) that fn
    calls once a call. Each ctypes call of such an entry is bracketed by
    CUDA events recorded on the launching stream, and a sleep kernel holds
    the stream while the host queues the calls, so each pair of events
    spans its kernel's device time and not the host's launch gap. Unlike a
    torch.profiler trace, which lost up to two thirds of a kernel's launches
    on the H100, every launch is timed: each entry must be called exactly
    once a call."""
    from paddle_tpu_torch.kernels import _build

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spans = {e: [] for e in entries}
    patched = []

    def bracket(key, launch):
        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = launch(*args)
            end.record()
            spans[key].append((start, end))
            return err
        timed.argtypes, timed.restype = launch.argtypes, launch.restype
        return timed

    try:
        for key in entries:
            lib = _build.load(key[0])
            launch = getattr(lib, key[1])
            setattr(lib, key[1], bracket(key, launch))
            patched.append((lib, key[1], launch))
        for _ in range(reps):
            torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    finally:
        for lib, name, launch in patched:
            setattr(lib, name, launch)
    out = {}
    for (lib_name, name), ev in spans.items():
        check(len(ev) == iters * reps,
              f"{lib_name}.{name} launched {len(ev)} times in "
              f"{iters * reps} calls")
        out[name] = statistics.median(a.elapsed_time(b) for a, b in ev)
    return out


# ---------------------------------------------------------------------------
# kernels: inputs, bounds, parity
# ---------------------------------------------------------------------------


def attn_inputs(B, H, D, dtype, seed, S=SEQ):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda").to(dtype)
    bias = torch.zeros(B, S, device="cuda")
    for b in range(B):  # a padded tail of keys per sample, as BERT masks it
        bias[b, S - 1 - (b * 13) % (S // 2):] = -1e4
    return qkv, bias


def res_inputs(R, N, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(R, N, generator=g, device="cuda").to(dtype)
    y = (torch.randn(R, N, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    gam = 1 + 0.1 * torch.randn(N, generator=g, device="cuda")
    beta = 0.1 * torch.randn(N, generator=g, device="cuda")
    return x, y, gam, beta


def live_pairs(S, causal):
    """(query, key) pairs an attention row set computes: S^2, or the
    S(S+1)/2 on and below the diagonal under a causal mask."""
    return S * (S + 1) // 2 if causal else S * S


def attn_bound(qkv, bias, H, causal=False):
    """fwd_bound of the whole-row forward on the packed qkv (read once,
    out written once, the key bias read once), with its operations."""
    B, S, three_hd = qkv.shape
    D = three_hd // 3 // H
    es = qkv.element_size()
    nbytes = qkv.numel() * es + B * S * H * D * es
    if bias is not None:
        nbytes += bias.numel() * 4
    # q k^T and p v over the live pairs, two flops per product
    ops = 4 * B * H * D * live_pairs(S, causal)
    return (*fwd_bound(nbytes, ops, qkv.dtype), ops)


def fwd_bound(nbytes, ops, dtype):
    """(bound, fp32 CUDA-core bound) of a forward on the tensor cores
    (#1/#5, #7, #12): its two products' `ops` as three TF32 terms each
    (3xTF32) at 495 TFLOP/s in fp32, at 989 TFLOP/s bf16 in bf16, or the
    bytes where they take longer; beside it the same function on the fp32
    CUDA cores (67 TFLOP/s), where the forwards ran before."""
    if dtype == torch.float32:
        return bound(nbytes, 3 * ops, "tf32"), bound(nbytes, ops, dtype)
    return bound(nbytes, ops, dtype), bound(nbytes, ops, torch.float32)


def res_bound(x, N):
    es = x.element_size()
    nbytes = 3 * x.numel() * es + 2 * N * 4
    ops = 10 * x.numel()
    return bound(nbytes, ops, x.dtype)


def bound(nbytes, ops, peak):
    """The larger of nbytes over 3.35 TB/s and ops at PEAK_OPS[peak] (a
    dtype, or "tf32"), in ms, with the name of the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# TF32 products the whole-row backward pair (#3/#6) does on the tensor
# cores, (dq, dkv), each 2*B*H*S^2*D flops, recomputation included: fp32
# operands in the 3xTF32 split, three terms a product (dq: S and dP twice,
# dS K; dkv: S^T, dP^T, P^T dO, dS^T Q); bf16 Q, K, V and dO are TF32
# already, so one term for the products of two of them and two for dS K,
# P^T dO and dS^T Q (the fp32 P and dS split). Printed beside the bound,
# which counts the function's operations only.
PAIR_TF32 = {torch.float32: (15, 12), torch.bfloat16: (6, 6)}
# the same for the KV-tiled pair (#9, #8), which takes the forward's lse
# and output and recomputes nothing but S (and dP): dq S, dP, dS K; dkv
# S^T, dP^T, P^T dO, dS^T Q
TILED_TF32 = {torch.float32: (9, 12), torch.bfloat16: (4, 6)}


def pair_f64_line(q, k, v, bias, do, kernel, plain, scale, rate, seed,
                  what):
    """Head (0, 0) of the whole-row pair's dq, dk, dv, the kernels' and
    the plain version's, against fp64 (training dropout under
    downgrade_in_infer: the kernels' Philox mask, kept values unscaled):
    a measurement, not a check."""
    from paddle_tpu_torch.kernels import prng_mask as pm

    Q, K, V, DO = (x[0, 0].double() for x in (q, k, v, do))
    S = Q.shape[0]
    w = pm.keep_mask(seed, rate, S, S, lead=(1, 1),
                     device="cuda")[0, 0].double()
    s = Q @ K.T * scale + bias[0].double()
    p = torch.softmax(s, -1)
    dp = DO @ V.T * w
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ref = (ds @ K * scale, ds.T @ Q * scale, (p * w).T @ DO)
    f64 = {side: ", ".join(f"{n} {(a[0, 0].double() - r).abs().max():.3e}"
                           for n, a, r in zip(("dq", "dk", "dv"), got, ref))
           for side, got in (("kernels", kernel), ("plain", plain))}
    print(f"{what} head 0 against fp64: kernels {f64['kernels']}; plain "
          f"version {f64['plain']}")


def compare(got, want, kernel, dtype, what):
    """Max abs error of a kernel's output against its plain version;
    fails beyond the kernel's tolerance for the dtype."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    atol, rtol = TOL[kernel][dtype]
    diff = (got - want).abs()
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= atol + rtol * want.abs()).all())
    print(f"{what}: max_abs_err={err:.3e} (atol {atol:g}, rtol {rtol:g})")
    check(ok, f"{what}: the kernel disagrees with its plain version")
    return err


def parity(fa, fr):
    """Every kernel against its plain version on the card; returns the
    fp32 error at the main path's case of each."""
    print("== parity: kernel vs plain version on the card")
    main_err = {}
    cases = []
    for B in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                for impl in ("downgrade_in_infer", "upscale_in_train"):
                    cases.append((B, 12, 64, SEQ, dtype, causal, impl))
    # the kernel's edges: other head dims, S not a multiple of the tile
    cases += [(2, 4, 32, 77, torch.float32, True, "downgrade_in_infer"),
              (2, 2, 128, 200, torch.float32, False, "downgrade_in_infer"),
              (2, 2, 128, 200, torch.bfloat16, True, "upscale_in_train")]
    for i, (B, H, D, S, dtype, causal, impl) in enumerate(cases):
        qkv, bias = attn_inputs(B, H, D, dtype, SEED + i, S=S)
        kw = dict(scale=1.0 / math.sqrt(D), dropout_rate=RATE, causal=causal)
        got = fa.fused_attention_qkv(qkv, H, bias, is_test=True,
                                     dropout_implementation=impl, **kw)
        want = fa.reference_qkv(qkv, H, bias, upscale=impl.startswith("up"),
                                **kw)
        err = compare(got, want, "attention", dtype,
                      f"attention B={B} S={S} H={H} D={D} "
                      f"{str(dtype)[6:]} causal={causal} {impl}")
        if (B, S, D, dtype, causal, impl) == (
                8, SEQ, 64, torch.float32, False, "downgrade_in_infer"):
            main_err["attention"] = err
    for B in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            for upscale in (False, True):
                x, y, g, c = res_inputs(B * SEQ, 768, dtype, SEED + B)
                kw = dict(rate=RATE, upscale=upscale, eps=1e-5)
                got = fr.fused_dropout_add_ln_fwd(x, y, g, c, is_test=True,
                                                  **kw)
                want = fr.reference_fwd(x, y, g, c, **kw)
                err = compare(got, want, "residual", dtype,
                              f"residual R={B * SEQ} N=768 "
                              f"{str(dtype)[6:]} upscale={upscale}")
                if (B, dtype, upscale) == (8, torch.float32, False):
                    main_err["residual"] = err
    return main_err


def train_parity(fa, fr, pm):
    """The kernels against their plain versions with training dropout (one
    Philox mask on both sides), forward and backward, at the training
    path's shapes; the kernels' mask against the plain one, its keep rate
    and its independence from the tiling. Returns the fp32 error at the
    main path's case of each kernel."""
    print("== parity, training: kernel vs plain version on the card, "
          f"dropout {TRAIN_RATE} in training")
    err = {}
    kw0 = dict(dropout_rate=TRAIN_RATE, is_test=False, seed=MASK_SEED)
    for B in (1, 4):
        for S in (128, 512):
            for dtype in (torch.float32, torch.bfloat16):
                for causal in (False, True):
                    qkv, bias = attn_inputs(B, 12, 64, dtype, SEED + S + B,
                                            S=S)
                    g = torch.Generator(device="cuda").manual_seed(SEED)
                    do = torch.randn(B, S, 768, generator=g,
                                     device="cuda").to(dtype)
                    kw = dict(kw0, scale=0.125, causal=causal)
                    tag = (f"B={B} S={S} H=12 D=64 {str(dtype)[6:]} "
                           f"causal={causal}")
                    e_f = compare(fa.fused_attention_qkv(qkv, 12, bias, **kw),
                                  fa.reference_qkv(qkv, 12, bias, **kw),
                                  "attention", dtype, f"attention fwd {tag}")
                    dqkv, dbias = fa.fused_attention_qkv_bwd(
                        qkv, 12, bias, do, want_dbias=True, **kw)
                    want_q, want_b = fa.reference_qkv_bwd(qkv, 12, bias, do,
                                                          **kw)
                    e_q = compare(dqkv, want_q, "attention_bwd", dtype,
                                  f"attention bwd dqkv {tag}")
                    compare(dbias, want_b, "attention_bwd", torch.float32,
                            f"attention bwd dbias {tag}")
                    if (B, S, dtype, causal) == (4, 512, torch.float32,
                                                 False):
                        err["attention_fwd"] = e_f
                        err["attention_bwd"] = e_q
    R, N = 2048, 768
    for dtype in (torch.float32, torch.bfloat16):
        for upscale in (False, True):
            x, y, gam, beta = res_inputs(R, N, dtype, SEED + 7)
            do = torch.randn(R, N, device="cuda").to(dtype)
            kw = dict(kw0, rate=kw0["dropout_rate"], upscale=upscale,
                      eps=1e-5)
            del kw["dropout_rate"]
            tag = f"R={R} N={N} {str(dtype)[6:]} upscale={upscale}"
            e_f = compare(fr.fused_dropout_add_ln_fwd(x, y, gam, beta, **kw),
                          fr.reference_fwd(x, y, gam, beta, **kw),
                          "residual", dtype, f"residual fwd {tag}")
            got = fr.fused_dropout_add_ln_bwd(x, y, gam, do, **kw)
            want = fr.reference_bwd(x, y, gam, do, **kw)
            e_b = max(compare(a, b, "residual_bwd", dtype,
                              f"residual bwd {n} {tag}")
                      for n, a, b in zip(("dx", "dy"), got[:2], want[:2]))
            for n, a, b in zip(("dg", "dc"), got[2:], want[2:]):
                compare(a, b, "residual_sums", dtype,
                        f"residual bwd {n} {tag}")
            if (dtype, upscale) == (torch.float32, False):
                err["residual_fwd"], err["residual_bwd"] = e_f, e_b
                dy = got[1]
    # the kernel's mask is the plain mask: dy is zero exactly where dropped
    whole = pm.keep_mask(MASK_SEED, TRAIN_RATE, R, N, device="cuda")
    check(torch.equal(dy != 0, whole),
          "the residual kernel's mask differs from the plain mask")
    p = 1 - pm.threshold(TRAIN_RATE) / 65536
    rate = whole.float().mean().item()
    sigma = math.sqrt(p * (1 - p) / whole.numel())
    print(f"keep rate over {whole.numel()} elements: {rate:.6f} "
          f"(expected {p:.6f}, sigma {sigma:.2e})")
    check(abs(rate - p) < 5 * sigma, "keep rate beyond 5 sigma of 1-p")
    full = pm.keep_mask(MASK_SEED, TRAIN_RATE, 512, 512, lead=(4, 12),
                        device="cuda")
    for r0, c0 in ((0, 0), (64, 448), (448, 64), (200, 333)):
        tile = pm.keep_mask(MASK_SEED, TRAIN_RATE, 64, 64, lead=(4, 12),
                            row0=r0, col0=c0, device="cuda")
        check(torch.equal(tile, full[..., r0:r0 + 64, c0:c0 + 64]),
              f"mask tile at ({r0}, {c0}) differs from the whole mask")
    print("kernel mask == plain mask; tiles == slices of the whole mask")
    return err


def tiled_parity(ft):
    """#7-#9 against their plain versions on the card at GPT's width (H=12,
    D=64), S in {1152, 2048}, B in {1, 4}: causal without a key bias (as
    GPT) and non-causal with padded keys, dropout 0.1 in training and in
    test mode, fp32 and bf16. Returns the fp32 errors at the GPT training
    path's case (B=4, S=2048, causal, training)."""
    print("== parity, tiled: #7-#9 vs plain version on the card")
    H, D, err = 12, 64, {}
    for B, S in ((1, 1152), (GPT_B, GPT_S)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                for training in (False, True):
                    qkv, bias = attn_inputs(B, H, D, dtype, SEED + S + B,
                                            S=S)
                    bias = None if causal else bias
                    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
                    do = torch.randn(B, S, H * D, generator=g,
                                     device="cuda").to(dtype)
                    seed = MASK_SEED if training else None
                    kw = dict(scale=0.125, rate=TRAIN_RATE,
                              is_test=not training, causal=causal)
                    tag = (f"B={B} S={S} {str(dtype)[6:]} causal={causal} "
                           f"training={training}")
                    out, lse = ft.flash_tiled_fwd(qkv, bias, seed, H, D, **kw)
                    want_o, want_l = ft.reference_fwd(qkv, bias, seed, H, D,
                                                      **kw)
                    e_f = compare(out, want_o, "attention", dtype,
                                  f"tiled fwd {tag}")
                    compare(lse, want_l, "lse", torch.float32,
                            f"tiled fwd lse {tag}")
                    dqkv, dbias = ft.flash_tiled_bwd(
                        qkv, bias, seed, do, out, lse, H, D,
                        want_dbias=bias is not None, **kw)
                    want_q, want_b = ft.reference_bwd(qkv, bias, seed, do,
                                                      out, lse, H, D, **kw)
                    e_q = compare(dqkv[..., :H * D], want_q[..., :H * D],
                                  "attention_bwd", dtype, f"tiled dq {tag}")
                    e_kv = compare(dqkv[..., H * D:], want_q[..., H * D:],
                                   "attention_bwd", dtype, f"tiled dkv {tag}")
                    if bias is not None:
                        compare(dbias, want_b, "attention_bwd", torch.float32,
                                f"tiled dbias {tag}")
                    if (B, S, dtype, causal, training) == (
                            GPT_B, GPT_S, torch.float32, True, True):
                        err = dict(tiled_fwd=e_f, tiled_bwd_dq=e_q,
                                   tiled_bwd_dkv=e_kv)
    return err


def ln_inputs(R, N, dtype, affine, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(R, N, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    dy = torch.randn(R, N, generator=g, device="cuda").to(dtype)
    s = (1 + 0.1 * torch.randn(N, generator=g, device="cuda"))
    b = 0.1 * torch.randn(N, generator=g, device="cuda")
    if affine is None:
        return x, dy, None, None
    return x, dy, s.to(affine), b.to(affine)


def ln_parity(lnk):
    """#10 and #11 against their plain versions on the card at GPT's
    [8192, 768] and at R = 1001 (a multiple of no block size) with N in
    {256, 1024, 4096}, fp32 and bf16 x, scale and bias fp32, bf16 or
    absent; #11 twice on the same inputs gives the same bits. Returns the
    errors at the GPT AMP path's case ([8192, 768], bf16 x, scale and
    bias) and in fp32."""
    print("== parity, layer_norm: #10/#11 vs plain version on the card")
    err = {}
    for R, N in ((8192, 768), (1001, 256), (1001, 1024), (1001, 4096)):
        for dtype in (torch.float32, torch.bfloat16):
            for affine in (torch.float32, torch.bfloat16, None):
                x, dy, s, b = ln_inputs(R, N, dtype, affine, SEED + N)
                tag = (f"R={R} N={N} {str(dtype)[6:]} scale/bias "
                       f"{str(affine)[6:] if affine else 'none'}")
                y, mean, var = lnk.layer_norm_fwd(x, s, b, 1e-5)
                want = lnk.reference_fwd(x, s, b, 1e-5)
                e_f = compare(y, want[0], "layer_norm", dtype,
                              f"layer_norm fwd {tag}")
                for n, a, w in zip(("mean", "var"), (mean, var), want[1:]):
                    compare(a, w, "ln_stats", torch.float32,
                            f"layer_norm fwd {n} {tag}")
                dx, ds, db = lnk.layer_norm_bwd(x, s, dy, 1e-5)
                want = lnk.reference_bwd(x, s, dy, 1e-5)
                e_b = compare(dx, want[0], "layer_norm_bwd", dtype,
                              f"layer_norm bwd dx {tag}")
                for n, a, w in zip(("dscale", "dbias"), (ds, db), want[1:]):
                    compare(a, w, "ln_sums", torch.float32,
                            f"layer_norm bwd {n} {tag}")
                if (R, N, affine) == (8192, 768, dtype):
                    key = "" if dtype == torch.bfloat16 else "_fp32"
                    err["layer_norm_fwd" + key] = e_f
                    err["layer_norm_bwd" + key] = e_b
    x, dy, s, _ = ln_inputs(8192, 768, torch.bfloat16, torch.bfloat16, SEED)
    first = lnk.layer_norm_bwd(x, s, dy, 1e-5)
    second = lnk.layer_norm_bwd(x, s, dy, 1e-5)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "two runs of #11 on the same inputs differ")
    print("layer_norm bwd: two runs give the same bits (dx, dscale, dbias)")
    return err


# ---------------------------------------------------------------------------
# main path: BERT-base classifier behind the Server
# ---------------------------------------------------------------------------


def build_classifier(fluid, layers, cfg):
    """bench_serving.py's bert_classify model, in test mode: the [CLS]
    hidden state -> fc(4) -> softmax."""
    from paddle_tpu_torch.models.bert import bert_encoder
    from paddle_tpu_torch.serving import freeze_program

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [-1, SEQ], "int64")
        types = fluid.data("types", [-1, SEQ], "int64")
        mask = fluid.data("mask", [-1, SEQ], "float32")
        seq = bert_encoder(ids, types, mask, cfg, is_test=True)
        pooled = layers.slice(seq, [1], [0], [1])
        prob = layers.softmax(layers.fc(pooled, 4))
    frozen = freeze_program(main, [prob], feed_names=("ids", "types", "mask"))
    return startup, frozen


def sample(rng, cfg, length):
    mask = np.zeros(SEQ, np.float32)
    mask[:length] = 1.0
    ids = rng.randint(0, cfg.vocab_size, SEQ).astype(np.int64)
    types = np.zeros(SEQ, np.int64)
    types[length // 2:length] = 1
    return {"ids": ids * (mask > 0), "types": types, "mask": mask}


def main_path(fluid, layers, kc):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.serving import EndpointConfig, Server

    print("== serving path: BERT-base classifier through serving.Server")
    cfg = BertConfig.base()
    startup, frozen = build_classifier(fluid, layers, cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(scope.find_var(n).numel() for n in scope.local_var_names())
    print(f"startup on the card: {time.perf_counter() - t0:.2f}s, "
          f"{n_params / 1e6:.1f}M parameters, "
          f"{len(frozen.program.global_block.ops)} frozen ops")
    check(all(scope.find_var(n).is_cuda for n in scope.local_var_names()),
          "startup left a parameter off the card")

    rng = np.random.RandomState(SEED)
    # groups submitted together: full, partial and small buckets
    groups = (8, 5, 3, 1, 2)
    lengths = [int(v) for v in rng.randint(8, SEQ + 1, sum(groups))]
    samples = [sample(rng, cfg, n) for n in lengths]

    srv = Server()
    try:
        ep = srv.add_endpoint(
            "bert", frozen=frozen, executor=exe, scope=scope,
            config=EndpointConfig(buckets=BUCKETS, max_wait_ms=20.0),
        )
        srv.warmup()
        torch.cuda.synchronize()
        reset_counts(kc)
        served, i = [], 0
        for g in groups:
            futs = [srv.submit("bert", samples[j]) for j in range(i, i + g)]
            served += [f.result(timeout=300)[0] for f in futs]
            i += g
        counts = read_counts(kc)
        attn_n, res_n = counts["attention_fwd"], counts["residual_fwd"]
        batches = list(ep.batches)
    finally:
        check(srv.close(timeout=300), "server did not drain")
    served = np.stack(served)
    print(f"served {len(served)} requests in {len(batches)} batches "
          f"(bucket, rows): {batches}")
    print(f"launches on the main path: attention {attn_n}, residual {res_n}")
    check(len(served) == len(samples) >= 16, "fewer than 16 answers")
    # one attention and two residual tails per encoder layer and batch
    n_layers = cfg.num_layers
    check(attn_n == n_layers * len(batches) and attn_n > 0,
          f"attention kernel: {attn_n} launches for {len(batches)} batches")
    check(res_n == 2 * n_layers * len(batches) and res_n > 0,
          f"residual kernel: {res_n} launches for {len(batches)} batches")
    check(sum(counts.values()) == attn_n + res_n,
          f"a backward kernel ran while serving: {counts}")
    check(served.shape == (len(samples), 4) and np.isfinite(served).all(),
          f"served probabilities: shape {served.shape} or not finite")
    sum_err = np.abs(served.sum(-1) - 1).max()
    check(sum_err < 1e-5, f"probability rows sum to 1 +- {sum_err}")

    direct = np.concatenate([
        exe.run(frozen.program, feed={k: v[None] for k, v in s.items()},
                fetch_list=list(frozen.fetch_names), scope=scope)[0]
        for s in samples
    ])
    d_err = np.abs(served - direct).max()
    print(f"served vs direct run on the card, one sample each: "
          f"max_abs_err={d_err:.3e} (tol {PROB_ATOL:g})")
    check(d_err <= PROB_ATOL, f"served and direct answers differ: {d_err}")

    cpu_scope = fluid.Scope()
    convert.state_from_numpy(convert.state_to_numpy(scope), cpu_scope,
                             fluid.CPUPlace())
    feed = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    t0 = time.perf_counter()
    cpu, = fluid.Executor(fluid.CPUPlace()).run(
        frozen.program, feed=feed, fetch_list=list(frozen.fetch_names),
        scope=cpu_scope)
    c_err = np.abs(served - cpu).max()
    print(f"served vs the port on CPUPlace() (plain versions), same weights: "
          f"max_abs_err={c_err:.3e} (tol {PROB_ATOL:g}), "
          f"CPU run {time.perf_counter() - t0:.1f}s")
    check(c_err <= PROB_ATOL, f"card and CPU answers differ: {c_err}")
    spread = np.abs(served - served.mean(0)).max()
    check(spread > 1e-6, "every request got the same answer")
    return frozen, exe, scope, samples, counts


def serve_window(srv, name, b, samples):
    """One closed-loop window at bucket b: submit a full bucket, wait for
    every answer, repeat until WINDOW_S seconds and WINDOW_REQUESTS
    requests have both passed. A request's latency is its round's: from
    the bucket's first submit to its last answer. Returns (requests/s,
    p50 ms, p99 ms, requests)."""
    lat, n = [], 0
    t_all = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        futs = [srv.submit(name, samples[(n + j) % len(samples)])
                for j in range(b)]
        for f in futs:
            f.result(timeout=300)
        t1 = time.perf_counter()
        lat += [(t1 - t0) * 1e3] * b
        n += b
        if t1 - t_all >= WINDOW_S and n >= WINDOW_REQUESTS:
            break
    lat.sort()
    return (n / (t1 - t_all), lat[len(lat) // 2],
            lat[min(len(lat) - 1, int(0.99 * len(lat)))], n)


def serve_times(frozen, exe, scope, samples):
    """Closed loop at each bucket, one endpoint per bucket, in WINDOW_REPS
    windows per bucket; the buckets run in alternating order (1, 2, 4, 8,
    8, 4, 2, 1, ...) so drift in the host's speed falls on every bucket
    alike. Prints each window, then each bucket's median and spread."""
    from paddle_tpu_torch.serving import EndpointConfig, Server

    print(f"== server times (closed loop, one full bucket in flight; "
          f"windows of >= {WINDOW_S:g} s and >= {WINDOW_REQUESTS} requests, "
          f"{WINDOW_REPS} per bucket in alternating order)")
    srv = Server()
    runs = {b: [] for b in BUCKETS}
    try:
        for b in BUCKETS:
            srv.add_endpoint(f"bert{b}", frozen=frozen, executor=exe,
                             scope=scope, config=EndpointConfig(buckets=(b,)))
        srv.warmup()
        for rep in range(WINDOW_REPS):
            for b in (BUCKETS if rep % 2 == 0 else BUCKETS[::-1]):
                rps, p50, p99, n = serve_window(srv, f"bert{b}", b, samples)
                runs[b].append((rps, p50, p99))
                print(f"  window {rep} bucket {b}: {n} requests, "
                      f"{rps:.1f} requests/s, p50 {p50:.3f} ms, "
                      f"p99 {p99:.3f} ms")
    finally:
        check(srv.close(timeout=300), "server did not drain")
    summary = {}
    for b in BUCKETS:
        rps, p50, p99 = (sorted(col) for col in zip(*runs[b]))
        summary[b] = dict(rps=statistics.median(rps), rps_min=rps[0],
                          rps_max=rps[-1], p50_ms=statistics.median(p50),
                          p50_min=p50[0], p50_max=p50[-1],
                          p99_ms=statistics.median(p99))
        s = summary[b]
        print(f"bucket {b}: {s['rps']:.1f} requests/s "
              f"[{s['rps_min']:.1f}, {s['rps_max']:.1f}], "
              f"p50 {s['p50_ms']:.3f} ms [{s['p50_min']:.3f}, "
              f"{s['p50_max']:.3f}], p99 {s['p99_ms']:.3f} ms "
              f"(median [min, max] of {WINDOW_REPS} windows)")
    print("server: " + json.dumps({str(b): s for b, s in summary.items()}))


# ---------------------------------------------------------------------------
# training: bench.py's bench_bert program
# ---------------------------------------------------------------------------


def bench_amp(opt):
    """bench.py's `_amp`: the optimizer under AMP as bench.py trains on an
    accelerator (bf16, static loss scale 1.0, layer_norm and softmax
    white-listed)."""
    from paddle_tpu_torch.contrib import mixed_precision as mp

    return mp.decorate(
        opt,
        amp_lists=mp.AutoMixedPrecisionLists(
            custom_white_list={"softmax", "layer_norm"}),
        use_dynamic_loss_scaling=False, init_loss_scaling=1.0,
        dest_dtype="bfloat16",
    )


def build_bench_bert(fluid, layers, cfg, B, S, lr, amp=False):
    """bench.py's bench_bert program: MLM pretraining with the gathered
    head and Adam (under bench_amp with amp=True); lr a float, or None for
    bench_bert's schedule (linear warmup over polynomial decay). Returns
    (main, startup, loss, lr (the float or the schedule's Variable),
    params_grads, P, optimizer)."""
    from paddle_tpu_torch.models.bert import bert_pretrain
    from paddle_tpu_torch.optimizer import Adam

    P = max(1, int(0.15 * B * S))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [B, S], "int64")
        types = fluid.data("types", [B, S], "int64")
        mask = fluid.data("mask", [B, S], "float32")
        mask_pos = fluid.data("mask_pos", [P], "int64")
        labels = fluid.data("labels", [P], "int64")
        loss = bert_pretrain(ids, types, mask, labels, cfg, mask_pos=mask_pos)
        if lr is None:
            lr = layers.linear_lr_warmup(
                layers.polynomial_decay(1e-4, 100000, 1e-5), 1000, 0.0, 1e-4)
        opt = bench_amp(Adam(lr)) if amp else Adam(lr)
        _, pg = opt.minimize(loss, startup)
    return main, startup, loss, lr, pg, P, opt


def bench_batches(cfg, B, S, P, n):
    """bench_bert's batches: int32 arrays from RandomState(0)."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        pos = rng.choice(B * S, P, replace=False).astype("int32")
        out.append({
            "ids": rng.randint(0, cfg.vocab_size, (B, S)).astype("int32"),
            "types": rng.randint(0, cfg.type_vocab_size,
                                 (B, S)).astype("int32"),
            "mask": np.ones((B, S), "float32"),
            "mask_pos": pos,
            "labels": rng.randint(0, cfg.vocab_size, P).astype("int32"),
        })
    return out


def train_small(fluid, layers):
    """Two Adam steps at BERT-base width, 2 layers, on the card and on the
    CPU from one state."""
    from paddle_tpu_torch.models.bert import BertConfig

    print("== training, reduced depth: BERT-base width, 2 layers, B=2, "
          f"S=128, no dropout, lr {SMALL_LR:g}; card vs CPUPlace()")
    cfg = BertConfig.base()
    cfg.num_layers = 2
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    main, startup, loss, _, pg, P, _ = build_bench_bert(fluid, layers, cfg,
                                                        2, 128, SMALL_LR)
    feeds = bench_batches(cfg, 2, 128, P, 2)
    for f in feeds:
        f["mask"][1, 100:] = 0.0  # padded keys in the second sample
    card_vs_cpu(fluid, main, startup, loss, pg, feeds)


def _held(got, want, spec):
    """(error, within the spec?) of got against want: ("elementwise",
    atol, rtol) -> max |got - want|, each within atol + rtol |want|;
    ("l2", bound) -> ||got - want|| / ||want|| within bound."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    d = np.abs(got - want)
    if spec[0] == "elementwise":
        return float(d.max()), bool((d <= spec[1] + spec[2] * np.abs(want))
                                    .all())
    err = float(np.linalg.norm(got - want)
                / max(np.linalg.norm(want), 1e-30))
    return err, err <= spec[1]


def card_vs_cpu(fluid, main, startup, loss, pg, feeds, tol=FP32_TOL):
    """One Adam step per feed on the card and on the CPU from one state,
    under `tol` (FP32_TOL or AMP_TOL): the loss, every @GRAD, the moments,
    beta powers, lr, loss scale and counters, and each parameter's
    update. Returns (exempt update elements, elements)."""
    from paddle_tpu_torch import convert

    gexe, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gexe.run(startup, scope=gscope)
    start = convert.state_to_numpy(gscope)
    cexe, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    convert.state_from_numpy(start, cscope, fluid.CPUPlace(), program=main)
    cpu_main = main.clone()  # the same seed and run counter
    fetch = [loss] + [g for _, g in pg]
    worst = {"loss": 0.0, "grad": 0.0}
    grads = {p.name: [] for p, _ in pg}  # (card, CPU) per step
    t0 = time.perf_counter()
    for step, feed in enumerate(feeds):
        gpu = gexe.run(main, feed=feed, fetch_list=fetch, scope=gscope)
        cpu = cexe.run(cpu_main, feed=feed, fetch_list=fetch, scope=cscope)
        for (p, _), g, c in zip(pg, gpu[1:], cpu[1:]):
            grads[p.name].append((g, c))
        check(np.isfinite(gpu[0]).all(), f"card loss not finite: {gpu[0]}")
        rel = float(np.abs(gpu[0] - cpu[0]).max() / np.abs(cpu[0]).max())
        worst["loss"] = max(worst["loss"], rel)
        check(rel <= tol["loss"], f"step {step}: loss {gpu[0]} vs CPU "
              f"{cpu[0]}")
        for (p, _), g, c in zip(pg, gpu[1:], cpu[1:]):
            err, ok = _held(g, c, tol["grad"])
            worst["grad"] = max(worst["grad"], err)
            check(ok, f"step {step}: {p.name}@GRAD differs by {err:.3e}")
    gend, cend = convert.state_to_numpy(gscope), convert.state_to_numpy(cscope)
    worst_m = worst_s = 0.0
    moved = 0
    for name, c in cend.items():
        g = gend[name]
        d = np.abs(g.astype(np.float64) - c)
        if name in grads:
            continue  # parameters: their updates, below
        if name.endswith(("_moment1_0", "_moment2_0")):
            err, ok = _held(g, c, tol["moment"])
            worst_m = max(worst_m, err)
            check(ok, f"moment {name} differs by {err:.3e}")
        elif c.dtype.kind == "f":  # beta powers, the lr, the loss scale
            worst_s = max(worst_s, float((d / np.abs(c)).max()))
            check((d <= 1e-6 * np.abs(c)).all(),
                  f"{name} differs by {d.max():.3e}")
        else:
            check(np.array_equal(g, c), f"{name}: {g} vs {c}")
        moved += not np.array_equal(start[name], c)
    worst_u, exempt, total = check_updates(start, gend, cend, grads,
                                           SMALL_LR, *tol["update"])
    moved += sum(not np.array_equal(start[n], cend[n]) for n in grads)
    check(moved > 3 * len(pg), f"only {moved} state tensors moved")
    print(f"{len(feeds)} steps, {len(pg)} gradients, {len(cend)} state "
          f"tensors ({moved} moved); max error vs CPU: loss "
          f"{worst['loss']:.2e} relative, @GRAD {worst['grad']:.2e} "
          f"({tol['grad'][0]}), moments {worst_m:.2e} ({tol['moment'][0]}), "
          f"beta powers, lr and loss scale {worst_s:.2e} relative, "
          f"parameter updates {worst_u:.2e} of (|update| + lr) over "
          f"{total - exempt} elements ({exempt} of {total} exempt, "
          f"{exempt / total:.2%}, gradients apart by more than "
          f"{tol['update'][1]:g}; cap {tol['update'][2]:.0%}) (bounds "
          f"{tol['loss']:g}, {tol['grad'][1:]}, {tol['moment'][1:]}, 1e-6, "
          f"{tol['update'][0]:g}); {time.perf_counter() - t0:.1f}s")
    return exempt, total


def check_updates(start, got, want, grads, lr, rtol, agree, cap):
    """Holds each parameter's update over the steps, end - start, against
    the reference's: |got - want| <= rtol * (|want| + lr), but for
    elements whose two gradients (got's, want's) differ by more than
    agree of want's at some step; those must stay under cap of the
    elements. Returns (worst |got - want| / (|want| + lr), exempt
    elements, elements)."""
    worst, exempt, total = 0.0, 0, 0
    for name, steps in grads.items():
        du = got[name].astype(np.float64) - start[name]
        dw = want[name].astype(np.float64) - start[name]
        noisy = np.zeros(dw.shape, bool)
        for g, w in steps:
            w = w.astype(np.float64)
            noisy |= np.abs(g - w) > agree * np.abs(w)
        rel = (np.abs(du - dw) / (np.abs(dw) + lr))[~noisy]
        if rel.size:  # empty where every element is exempt
            worst = max(worst, float(rel.max()))
            check(not (rel > rtol).any(),
                  f"{name}: {(rel > rtol).sum()} updates differ, worst "
                  f"{rel.max():.3e} of (|update| + lr)")
        exempt += int(noisy.sum())
        total += noisy.size
    check(exempt < cap * total, f"{exempt} of {total} updates exempt")
    return worst, exempt, total


# kernel-name fragments of the profile's kinds, in the order tried
KINDS = (
    ("attention forward (ours)", ("attn_fwd_kernel",)),
    ("attention backward (ours)", ("attn_bwd_dq_kernel",
                                   "attn_bwd_dkv_kernel")),
    ("tiled attention forward (ours)", ("tiled_fwd_kernel",)),
    ("tiled attention backward (ours)", ("tiled_dq_kernel",
                                         "tiled_dkv_kernel")),
    ("ring block forward (ours)", ("ring_fwd_kernel",)),
    ("ring block backward (ours)", ("ring_dq_kernel", "ring_dkv_kernel")),
    ("NCCL collectives", ("nccl",)),
    ("layer_norm fwd/bwd (ours)", ("ln_row_fwd_kernel",
                                   "ln_row_bwd_kernel")),
    ("residual fwd/bwd + sum_partials (ours)",
     ("ln_fwd_kernel", "ln_bwd_kernel", "sum_partials_")),
    ("matmul (cuBLAS)", ("gemm", "sgemm", "cutlass", "xmma", "sm90_",
                         "nvjet")),
    ("index/scatter", ("index", "scatter", "gather", "sort", "radix")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise and other", ("",)),
)


def profile_step(run):
    """One call of run() under torch.profiler: the card's busy time (the
    sum of its kernels' durations; one stream, so they do not overlap),
    its idle share of the wall time, busy time by kind of kernel, and the
    host-device synchronisations and copies inside the step by the
    outermost op that issued them."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds, syncs = {k: 0.0 for k, _ in KINDS}, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kind = next(k for k, frags in KINDS
                        if any(f in ev.name for f in frags))
            kinds[kind] += ev.device_time / 1e3
        elif ev.name in ("cudaStreamSynchronize", "cudaMemcpyAsync"):
            top = ev
            while top.cpu_parent is not None:
                top = top.cpu_parent
            if top is not ev:  # inside an op, not the closing synchronize
                key = f"{ev.name} in {top.name}"
                syncs[key] = syncs.get(key, 0) + 1
    busy = sum(kinds.values())
    check(busy > 0, "the profiler saw no kernel on the card")
    print(f"profiled step: wall {wall:.1f} ms, card busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {ms:.1f} ms ({ms / busy:.1%} of busy)")
    print(f"  host-device syncs and copies inside the step: {syncs}")
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                busy_ms_by_kind=kinds, syncs=syncs)


def host_by_op(run):
    """One call of run() with the executor's run_op timed on the host: the
    ms the host spends in each op type's emitter (building and enqueueing
    its kernels, or waiting where it synchronises with the card), a
    `__vjp__` op under its forward op's type, largest first. No profiler
    runs, so the times are the eager executor's own."""
    from paddle_tpu_torch.framework import executor

    real, by = executor.run_op, {}

    def timed(ctx, op, env):
        t0 = time.perf_counter()
        out = real(ctx, op, env)
        key = (f"__vjp__({op.attr('fwd_type')})" if op.type == "__vjp__"
               else op.type)
        by[key] = by.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    executor.run_op = timed
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        executor.run_op = real
    top = dict(sorted(by.items(), key=lambda kv: -kv[1])[:10])
    total = sum(by.values())
    print(f"host time in the emitters: {total:.1f} ms of a {wall:.1f} ms "
          "step; by op type: "
          + ", ".join(f"{k} {v:.1f}" for k, v in top.items()))
    return dict(host_emit_ms=total, host_ms_by_op=top)


def run_steps(exe, main, scope, batches, fetch, labels, kc, expect, tokens,
              after=None, warm=3, timed=5):
    """warm + timed steps through Executor.run, then one under
    torch.profiler and one with the host's time taken by op type; each
    step must launch the kernels of `expect`. after(i, values) checks step
    i's fetched scalars. Returns (every step's values, stats: step time
    median [min, max] of the timed steps, tokens/s, the time until
    Executor.run returned, peak memory, the profile, the host's time by op
    type)."""
    steps = warm + timed + 2  # then one profiled, one timed by op type
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kc)
    values, host, wall = [], [], []
    for i in range(steps):
        before = read_counts(kc)
        outs = []

        def run(i=i, outs=outs):
            outs += exe.run(main, feed=batches[i % len(batches)],
                            fetch_list=fetch, scope=scope,
                            return_numpy=False)

        if i == steps - 2:
            prof = profile_step(run)
        elif i == steps - 1:
            by_op = host_by_op(run)
        else:
            t0 = time.perf_counter()
            run()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        now = read_counts(kc)
        step = {k: now[k] - before[k] for k in now}
        check(step == expect, f"step {i} launched {step}, want {expect}")
        values.append([o.item() for o in outs])
        if after is not None:
            after(i, values[-1])
        if i >= steps - 2:
            continue
        if i >= warm:
            host.append(t1 - t0)
            wall.append(t2 - t0)
        shown = ", ".join(f"{n} {v:.4g}" for n, v in zip(labels, values[-1]))
        print(f"  step {i}: {shown}, {(t2 - t0) * 1e3:.1f} ms "
              f"({(t1 - t0) * 1e3:.1f} ms until Executor.run returned)")
    check(all(math.isfinite(v[0]) for v in values),
          f"losses {[v[0] for v in values]}")
    med = statistics.median(wall)
    stats = dict(step_ms=med * 1e3, step_ms_min=min(wall) * 1e3,
                 step_ms_max=max(wall) * 1e3,
                 host_ms=statistics.median(host) * 1e3,
                 tokens_per_s=tokens / med,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 final_loss=values[-1][0], steps=steps, profile=prof,
                 **by_op)
    print(f"step time (median [min, max] of {timed} after {warm} warm-up "
          f"steps): {stats['step_ms']:.1f} ms [{stats['step_ms_min']:.1f}, "
          f"{stats['step_ms_max']:.1f}], {stats['tokens_per_s']:.0f} "
          f"tokens/s; Executor.run returned after {stats['host_ms']:.1f} ms "
          f"(host); peak memory {stats['peak_gib']:.2f} GiB")
    return values, stats


def amp_checks(main, opt, scope, steps, kernel_inputs):
    """Under bench_amp: the program's ops and casts; the kernels' ops read
    bf16 activations (each (op type, slot) of kernel_inputs declares
    bfloat16: the CPU tests hold every op's runtime dtype to its
    declaration); after `steps` steps the static loss scale is still 1.0
    and good_steps counted every step."""
    blk = main.global_block
    casts = sum(op.type == "cast" for op in blk.ops)
    for op in blk.ops:
        for slot in kernel_inputs.get(op.type, ()):
            dt = blk.var(op.inputs[slot][0]).dtype
            check(dt == "bfloat16", f"{op.type} reads {slot} as {dt}")
    state = opt.state_dict(scope)
    check(state == {"loss_scaling": 1.0, "good_steps": steps,
                    "bad_steps": 0}, f"loss-scale state {state}")
    print(f"AMP: {len(blk.ops)} ops of which {casts} casts; kernel inputs "
          f"in bf16: {kernel_inputs}; loss-scale state {state}")


def unscale_cost(pg):
    """Card ms of check_finite_and_unscale on gradients of the parameters'
    shapes (fp32), and of its unscaled outputs alone, which nothing reads
    (the decorator keeps the op's semantics; the eager executor computes
    them)."""
    from paddle_tpu_torch.framework.registry import OpView, get_op_def

    xs = [torch.randn(tuple(p.shape), device="cuda") for p, _ in pg]
    scale = torch.ones(1, device="cuda")
    emit = get_op_def("check_finite_and_unscale").emit
    op = OpView("check_finite_and_unscale", {})
    t_op = cuda_ms(lambda: emit(None, op, {"X": xs, "Scale": [scale]}),
                   iters=5, reps=3)
    t_out = cuda_ms(lambda: [x / scale for x in xs], iters=5, reps=3)
    n = sum(x.numel() for x in xs)
    print(f"check_finite_and_unscale over {n / 1e6:.1f}M fp32 gradient "
          f"elements: {t_op:.3f} ms, of which the unread unscaled outputs "
          f"{t_out:.3f} ms")
    del xs
    torch.cuda.empty_cache()
    return dict(unscale_op_ms=t_op, unscale_dead_outputs_ms=t_out,
                grad_elements=n)


def train_full(fluid, layers, kc, amp=False):
    """bench_bert's training step at BertConfig.base(), B=32, S=512, in
    fp32 or under bench_amp."""
    from paddle_tpu_torch.models.bert import BertConfig

    B, S = 32, 512
    mode = "AMP (bf16, bench.py's _amp)" if amp else "fp32"
    print(f"== training path: bench_bert at BertConfig.base(), B={B}, "
          f"S={S}, dropout 0.1, Adam under linear warmup over polynomial "
          f"decay, {mode}")
    cfg = BertConfig.base()
    t0 = time.perf_counter()
    main, startup, loss, lr, pg, P, opt = build_bench_bert(
        fluid, layers, cfg, B, S, None, amp=amp)
    ops = main.global_block.ops
    print(f"P={P}; {len(ops)} ops of {len({op.type for op in ops})} types, "
          f"{len(pg)} parameters; built in {time.perf_counter() - t0:.1f}s")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in bench_batches(cfg, B, S, P, 4)]
    watch = ("bert_l0_attn_qkv_w", "bert_l11_ffn_out_w", "mlm_out_w")
    snap = {n: scope.find_var(n).clone() for n in watch}
    expect = dict.fromkeys(kc, 0)
    expect.update(attention_fwd=12, attention_bwd_dq=12,
                  attention_bwd_dkv=12, residual_fwd=24, residual_bwd=24,
                  sum_partials=24)

    def after(i, values):
        lr_i = values[1]
        changed = [n for n in watch
                   if not torch.equal(scope.find_var(n), snap[n])]
        if i == 0:
            check(lr_i == 0.0 and not changed,
                  f"step 0 (lr {lr_i}) moved {changed}")
        elif i == 1:
            check(lr_i > 0.0 and len(changed) == len(watch),
                  f"step 1 (lr {lr_i}) moved only {changed}")

    values, stats = run_steps(exe, main, scope, batches, [loss, lr],
                              ("loss", "lr"), kc, expect, B * S, after)
    counts = read_counts(kc)
    counter = int(scope.find_var("@LR_DECAY_COUNTER@").item())
    check(counter == stats["steps"] - 1, f"step counter {counter}")
    print(f"step counter {counter}; launches on the training path "
          f"({stats['steps']} steps): {counts}")
    if amp:
        amp_checks(main, opt, scope, stats["steps"], {
            "fused_qkv_attention": ("QKV",),
            "fused_qkv_attention_grad": ("QKV", "OutGrad"),
            "fused_dropout_add_ln": ("X", "Y"),
            "fused_dropout_add_ln_grad": ("X", "Y", "OutGrad")})
        stats.update(ops=len(ops), **unscale_cost(pg))
    print(("bert amp training: " if amp else "training: ")
          + json.dumps(stats))
    del exe, scope, batches, snap
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# GPT: bench.py's bench_gpt_longctx program, and KV-cache serving
# ---------------------------------------------------------------------------

def gpt_longctx_config(num_layers=12):
    """bench_gpt_longctx's GPT-small on an accelerator, S = 2048."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=32000, hidden_size=768,
                     num_layers=num_layers, num_heads=12,
                     intermediate_size=3072, max_position=GPT_S)


def build_bench_gpt(fluid, cfg, B, S, lr, amp=False):
    """bench.py's bench_gpt_longctx program: gpt_lm_loss with Adam at a
    constant lr (under bench_amp with amp=True). The layer_norm grad ops
    follow FLAGS_paddle_tpu_pallas_layer_norm as it stands now. Returns
    (main, startup, loss, params_grads, optimizer)."""
    from paddle_tpu_torch.models.gpt import gpt_lm_loss
    from paddle_tpu_torch.optimizer import Adam

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [B, S], "int64")
        loss = gpt_lm_loss(ids, cfg)
        opt = bench_amp(Adam(lr)) if amp else Adam(lr)
        _, pg = opt.minimize(loss, startup)
    return main, startup, loss, pg, opt


def gpt_batches(cfg, B, S):
    """bench_gpt_longctx's two int32 batches from RandomState(0)."""
    rng = np.random.RandomState(0)
    return [{"ids": rng.randint(0, cfg.vocab_size, (B, S)).astype("int32")}
            for _ in range(2)]


def gpt_train_small(fluid, amp=False):
    """Two Adam steps of the bench_gpt_longctx program at GPT-small width
    with 2 layers, B=1, S=2048 (the tiled path), dropout 0, on the card
    and on the CPU from one state: in fp32 under phase 5's tolerances, or
    under bench_amp with FLAGS_paddle_tpu_pallas_layer_norm on (#10/#11
    on the card, their plain versions on the CPU) under AMP_TOL."""
    mode = ("AMP, FLAGS_paddle_tpu_pallas_layer_norm on" if amp
            else "fp32")
    print("== GPT training, reduced depth: GPT-small width, 2 layers, B=1, "
          f"S={GPT_S}, no dropout, lr {SMALL_LR:g}, {mode}; card vs "
          "CPUPlace()")
    cfg = gpt_longctx_config(num_layers=2)
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    fluid.set_flags({LN_FLAG: amp})
    try:
        main, startup, loss, pg, _ = build_bench_gpt(fluid, cfg, 1, GPT_S,
                                                     SMALL_LR, amp=amp)
        check(sum(op.type == "fused_qkv_attention_grad"
                  and "Lse" in op.inputs
                  for op in main.global_block.ops) == 2,
              "the grad ops do not read the saved Lse")
        check(sum(op.type == "layer_norm_grad"
                  for op in main.global_block.ops) == (5 if amp else 0),
              "layer_norm_grad ops do not follow the flag")
        exempt, total = card_vs_cpu(fluid, main, startup, loss, pg,
                                    gpt_batches(cfg, 1, GPT_S),
                                    AMP_TOL if amp else FP32_TOL)
    finally:
        fluid.set_flags({LN_FLAG: False})
    return exempt / total


def gpt_train_full(fluid, kc, amp=False, ln_kernels=False):
    """bench_gpt_longctx's training step at GPT-small, B=4, S=2048,
    dropout 0.1, Adam(1e-4): fp32, or under bench_amp as the JAX package
    trains it on an accelerator, with FLAGS_paddle_tpu_pallas_layer_norm
    off (bench.py's default) or on (#10/#11, 25 each a step: 12 layers x
    (ln1, ln2) and gpt_lnf). The flag is set before the program is built
    and stays on while it runs. Returns (launch counts, step stats)."""
    B, S = GPT_B, GPT_S
    mode = "fp32"
    if amp:
        mode = ("AMP (bf16, bench.py's _amp), FLAGS_paddle_tpu_pallas_"
                f"layer_norm {'on' if ln_kernels else 'off'}")
    print(f"== GPT training path: bench_gpt_longctx at GPT-small (V=32000, "
          f"hidden 768, 12 layers, 12 heads), B={B}, S={S}, dropout 0.1, "
          f"Adam(1e-4), {mode}")
    cfg = gpt_longctx_config()
    fluid.set_flags({LN_FLAG: ln_kernels})
    try:
        t0 = time.perf_counter()
        main, startup, loss, pg, opt = build_bench_gpt(fluid, cfg, B, S,
                                                       1e-4, amp=amp)
        ops = main.global_block.ops
        print(f"{len(ops)} ops of {len({op.type for op in ops})} types, "
              f"{len(pg)} parameters; built in "
              f"{time.perf_counter() - t0:.1f}s")
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                   for b in gpt_batches(cfg, B, S)]
        watch = ("gpt_l0_attn_qkv_w", "gpt_l11_mlp_out_w", "lm_head_w",
                 "gpt_l0_ln1_scale", "gpt_lnf_bias")
        snap = {n: scope.find_var(n).clone() for n in watch}
        # the tiled kernels once per layer each, the forward never again
        # in the backward; no whole-row attention, no residual kernel, no
        # dbias; with the flag, #10/#11 (and #11's sum_partials) once per LN
        expect = dict.fromkeys(kc, 0)
        expect.update(tiled_fwd=12, tiled_bwd_dq=12, tiled_bwd_dkv=12)
        if ln_kernels:
            expect.update(layer_norm_fwd=25, layer_norm_bwd=25,
                          sum_partials=25)

        def after(i, values):
            if i == 0:
                moved = [n for n in watch
                         if not torch.equal(scope.find_var(n), snap[n])]
                check(len(moved) == len(watch), f"step 0 moved only {moved}")

        _, stats = run_steps(exe, main, scope, batches, [loss], ("loss",),
                             kc, expect, B * S, after)
    finally:
        fluid.set_flags({LN_FLAG: False})
    counts = read_counts(kc)
    print(f"launches on the GPT training path ({stats['steps']} steps): "
          f"{counts}")
    tag = "gpt training: "
    if amp:
        inputs = {"fused_qkv_attention": ("QKV",),
                  "fused_qkv_attention_grad": ("QKV", "OutGrad")}
        inputs["layer_norm"] = ("X", "Scale", "Bias")
        if ln_kernels:
            inputs["layer_norm_grad"] = ("X", "Scale", "Bias", "YGrad")
        amp_checks(main, opt, scope, stats["steps"], inputs)
        stats["ops"] = len(ops)
        if not ln_kernels:
            stats.update(unscale_cost(pg))
        tag = f"gpt amp training (layer_norm kernels {ln_kernels}): "
    print(tag + json.dumps(stats))
    del exe, scope, batches, snap
    torch.cuda.empty_cache()
    return counts, stats


def near_ties(gen, ctx, cached, full):
    """Rows where the cached tokens differ from full recompute's. At a
    row's first difference the two top logits of full recompute at that
    step (a run over the shared prefix) must lie within LOGIT_ATOL: greedy
    decoding on random weights meets near-ties, which sums in another
    order may break either way. A row is not compared past it. Returns
    (rows, full-recompute runs made)."""
    diff = cached != full
    rows = np.nonzero(diff.any(1))[0]
    if not len(rows):
        return 0, 0
    logits = gen.full_recompute_logits(np.concatenate([ctx, cached], 1))
    for r in rows:
        t = int(np.argmax(diff[r]))  # its first differing step
        top = logits[r, GEN_CTX + t - 1].topk(2).values
        gap = (top[0] - top[1]).item()
        print(f"  row {r}: tokens differ from step {t}; top two logits "
              f"{gap:.2e} apart")
        check(gap <= LOGIT_ATOL, f"row {r} step {t}: cached and full "
              f"recompute disagree where no tie is ({gap:.2e})")
    return len(rows), 1


def gpt_serving(fluid, kc):
    """GPTConfig.small() through the KV-cache generator behind
    serving.Server, checked against full recompute on the card (#1, causal,
    test mode) and against the port's CPU run of the prefill and the first
    decode step. Returns the phase's launch counts."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.errors import InvalidArgumentError
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_cache_names
    from paddle_tpu_torch.serving import (
        EndpointConfig,
        GPTGenerateRunner,
        GPTGenerator,
        Server,
    )

    print(f"== GPT serving path: GPTConfig.small() (V=50257, 12 layers) "
          f"through the KV cache, batch {GEN_BATCH}, context {GEN_CTX}, "
          f"{GEN_NEW} new tokens, behind serving.Server")
    cfg = GPTConfig.small()
    gen = GPTGenerator(cfg, GEN_BATCH, GEN_CTX, GEN_MAX,
                       executor=fluid.Executor(fluid.CUDAPlace(0)))
    gen.init_params(seed=SEED)
    rng = np.random.RandomState(SEED)
    contexts = [rng.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_CTX))
                for _ in range(GEN_ROUNDS)]

    cpu = GPTGenerator(cfg, GEN_BATCH, GEN_CTX, GEN_MAX,
                       executor=fluid.Executor(fluid.CPUPlace()))
    convert.state_from_numpy(convert.state_to_numpy(gen.scope), cpu.scope,
                             fluid.CPUPlace(), program=cpu.prefill_prog,
                             exclude=gpt_cache_names(cfg))
    errs = []
    for g in (gen, cpu):
        g.reset()
    logits = [g.prefill(contexts[0]).cpu() for g in (gen, cpu)]
    errs.append((logits[0] - logits[1]).abs().max().item())
    tok = logits[0][:, -1].argmax(-1).numpy()
    logits = [g.decode(tok, GEN_CTX).cpu() for g in (gen, cpu)]
    errs.append((logits[0] - logits[1]).abs().max().item())
    print(f"card vs CPUPlace(), same weights: prefill logits max_abs_err "
          f"{errs[0]:.3e}, first decode step {errs[1]:.3e} (tol "
          f"{LOGIT_ATOL:g})")
    check(max(errs) <= LOGIT_ATOL, f"card and CPU logits differ: {errs}")
    del cpu

    # the steps alone: prefill, then decode steps with the host's argmax
    prefill_ms, decode_ms = [], []
    for _ in range(3):
        gen.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = gen.prefill(contexts[0])[:, -1].argmax(-1).cpu().numpy()
        t1 = time.perf_counter()
        for t in range(1, GEN_NEW):
            tok = gen.decode(tok, GEN_CTX + t - 1)[:, -1].argmax(-1)
            tok = tok.cpu().numpy()
        t2 = time.perf_counter()
        prefill_ms.append((t1 - t0) * 1e3)
        decode_ms.append((t2 - t1) * 1e3 / (GEN_NEW - 1))

    runner = GPTGenerateRunner(gen, GEN_NEW)
    srv = Server()
    reset_counts(kc)
    try:
        try:
            srv.add_endpoint("gpt_bad", runner, EndpointConfig(buckets=(1, 8)))
            check(False, "a generate endpoint took buckets (1, 8)")
        except InvalidArgumentError:
            pass
        ep = srv.add_endpoint("gpt", runner, EndpointConfig(
            buckets=(GEN_BATCH,), max_wait_ms=50.0))
        served, walls = [], []
        for ctx in contexts:
            t0 = time.perf_counter()
            futs = [srv.submit("gpt", {"context_ids": r}) for r in ctx]
            served.append(np.stack([f.result(timeout=600)[0] for f in futs]))
            walls.append(time.perf_counter() - t0)
        batches = list(ep.batches)
    finally:
        check(srv.close(timeout=300), "server did not drain")
    check(batches == [(GEN_BATCH, GEN_BATCH)] * GEN_ROUNDS,
          f"served batches {batches}")
    ties, extra = 0, 0
    for ctx, cached in zip(contexts, served):
        check(cached.shape == (GEN_BATCH, GEN_NEW)
              and ((cached >= 0) & (cached < cfg.vocab_size)).all(),
              f"served tokens: shape {cached.shape} or out of range")
        full = gen.generate_full_recompute(ctx, GEN_NEW)
        rows, runs = near_ties(gen, ctx, cached, full)
        ties, extra = ties + rows, extra + runs
    counts = read_counts(kc)
    want = cfg.num_layers * (GEN_ROUNDS * GEN_NEW + extra)
    check(counts["attention_fwd"] == want and
          sum(counts.values()) == want,
          f"launches {counts}: want {want} of #1 (full recompute) only")
    stats = dict(prefill_ms=statistics.median(prefill_ms),
                 decode_ms_per_step=statistics.median(decode_ms),
                 tokens_per_s=GEN_BATCH * GEN_NEW / statistics.median(walls),
                 round_s=walls, near_tie_rows=ties,
                 rows=GEN_ROUNDS * GEN_BATCH)
    print(f"served {GEN_ROUNDS} rounds of {GEN_BATCH} requests: "
          f"{[f'{w:.2f}' for w in walls]} s a round; cached tokens == full "
          f"recompute on the card but for {ties} of "
          f"{GEN_ROUNDS * GEN_BATCH} rows (near-ties); prefill "
          f"{stats['prefill_ms']:.1f} ms, decode {stats['decode_ms_per_step']:.2f} "
          f"ms a step, {stats['tokens_per_s']:.0f} generated tokens/s at "
          f"batch {GEN_BATCH}; launches {counts}")
    print("gpt serving: " + json.dumps(stats))
    del gen, runner
    torch.cuda.empty_cache()
    return counts


def row(name, path, source, replaces, launches, err, t_k, t_p, b, t_l):
    return dict(name=f"{name}@{path}", route="cuda",
                source=f"paddle_tpu_torch/kernels/csrc/{source}",
                replaces=replaces, launches=launches, max_abs_err=err,
                ms=t_k, plain_ms=t_p, bound_ms=b[0], bound_by=b[1],
                library_ms=t_l)


def kernel_times(fa, fr, main_err, launches):
    """The forward kernels at the serving path's shapes (test mode)."""
    import torch.nn.functional as F

    print("== kernel times, serving shapes (B=8, S=128, H=12, D=64; "
          "R=1024, N=768; test mode)")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        qkv, bias = attn_inputs(8, 12, 64, dtype, SEED)
        kw = dict(scale=0.125, dropout_rate=RATE)
        q, k, v = qkv.view(8, SEQ, 3, 12, 64).permute(2, 0, 3, 1, 4)
        mask = bias[:, None, None, :].to(dtype)
        t_k = cuda_ms(lambda: fa.fused_attention_qkv(qkv, 12, bias,
                                                     is_test=True, **kw))
        t_p = cuda_ms(lambda: fa.reference_qkv(qkv, 12, bias, **kw))
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=0.125))
        b, c, ops = attn_bound(qkv, bias, 12)
        print(f"attention {name}: kernel {t_k:.4f} ms ({ops / t_k / 1e9:.1f} "
              f"TFLOP/s of products), plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}, tensor cores) / {c[0]:.4f} ms "
              "(fp32 CUDA cores)")
        if dtype == torch.float32:
            rows.append(row("flash_attention_qkv_fwd", "serving",
                            "flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:329",
                            launches["attention_fwd"],
                            main_err["attention"], t_k, t_p, b, t_l))

        x, y, g, c = res_inputs(8 * SEQ, 768, dtype, SEED)
        kw = dict(rate=RATE, eps=1e-5)
        t_k = cuda_ms(lambda: fr.fused_dropout_add_ln_fwd(x, y, g, c,
                                                          is_test=True, **kw))
        t_p = cuda_ms(lambda: fr.reference_fwd(x, y, g, c, **kw))
        gl, cl = g.to(dtype), c.to(dtype)
        t_l = cuda_ms(lambda: F.layer_norm(x + y * (1 - RATE), (768,), gl,
                                           cl, 1e-5))
        b = res_bound(x, 768)
        print(f"residual {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"F.layer_norm {t_l:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
        if dtype == torch.float32:
            rows.append(row("fused_dropout_add_ln_fwd", "serving",
                            "fused_dropout_add_ln.cu",
                            "paddle_tpu/kernels/fused_residual.py:90",
                            launches["residual_fwd"],
                            main_err["residual"], t_k, t_p, b, t_l))
    return rows


def train_kernel_times(fa, fr, sp, err, launches, amp_launches):
    """Every kernel at the training path's shapes, fp32, training dropout
    0.1: B=32, S=512, H=12, D=64 and R=16384, N=768. Bounds count each
    input read once and each output written once over 3.35 TB/s, and the
    fp32 arithmetic of the function (two flops per multiply-add; the
    backward's recomputation and the Philox integer work not counted)
    over 67 TFLOP/s; the attention forward (#1) runs its two products on
    the tensor cores, so its fp32 row carries them as three TF32 terms
    each at 495 TFLOP/s (fwd_bound), and it is timed again in bf16 at the
    BERT AMP path's activations (held against the plain version; its
    row's launches are that path's), beside SDPA's bf16 forward with
    dropout. The attention backward as a function does 8*B*H*S^2*D
    (dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q); its two kernels
    split that bound by the products each owns, dP and dQ to dq, dV and
    dK to dkv (dkv's own dP is recomputation), and the reads in halves, so
    the two bounds sum to the function's; the pair runs on the tensor
    cores, so its fp32 rows carry those operations as three TF32 terms
    each (3xTF32) at 495 TFLOP/s and its bf16 rows carry them at 989
    TFLOP/s bf16; the fp32 CUDA-core bound, and the time of the TF32
    products the kernels do (PAIR_TF32, recomputation included), are
    printed beside them. The pair is timed again in bf16 at the BERT
    AMP path's bf16 activations (its rows' launches are that path's), with
    scaled_dot_product_attention's bf16 backward beside it. The backward
    kernels' times come from CUDA events around each launch in the
    wrappers' own calls (launch_ms), so the pair's kernels, and the
    residual row kernel and its sum_partials, are timed apart. The
    residual backward (#4) is timed in fp32 and again at the BERT AMP
    path's bf16 activations (x, y and dO bf16, scale and bias fp32; its
    row's launches are that path's), each beside F.layer_norm(x + y)'s
    backward (whose scale and bias take x's dtype); its row groups
    (fr.bwd_groups) are printed, and sum_partials is timed at that
    count."""
    import torch.nn.functional as F

    B, S, H, D, R, N = 32, 512, 12, 64, 32 * 512, 768
    print(f"== kernel times, training shapes (B={B}, S={S}, H={H}, D={D}; "
          f"R={R}, N={N}; fp32, dropout {TRAIN_RATE} in training)")
    f32 = torch.float32
    kw = dict(scale=0.125, dropout_rate=TRAIN_RATE, is_test=False,
              seed=MASK_SEED)
    qkv, bias = attn_inputs(B, H, D, f32, SEED, S=S)
    do = torch.randn(B, S, H * D, device="cuda")
    q, k, v = (t.contiguous() for t in
               qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4))
    mask = bias[:, None, None, :]
    es, rows = 4, []
    for dtype in (f32, torch.bfloat16):
        name = str(dtype)[6:]
        x, m4 = qkv.to(dtype), mask.to(dtype)
        q4, k4, v4 = (t.to(dtype) for t in (q, k, v))
        if dtype == f32:
            e_fwd = err["attention_fwd"]
        else:  # BERT AMP's bf16 activations
            e_fwd = compare(fa.fused_attention_qkv(x, H, bias, **kw),
                            fa.reference_qkv(x, H, bias, **kw), "attention",
                            dtype, f"attention fwd B={B} S={S} {name}")
        t_k = cuda_ms(lambda: fa.fused_attention_qkv(x, H, bias, **kw),
                      iters=10, reps=5)
        t_p = cuda_ms(lambda: fa.reference_qkv(x, H, bias, **kw), iters=3,
                      reps=3)
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, dropout_p=TRAIN_RATE, scale=0.125),
            iters=10, reps=5)
        b, c, ops = attn_bound(x, bias, H)
        print(f"attention fwd {name}: kernel {t_k:.3f} ms "
              f"({ops / t_k / 1e9:.1f} TFLOP/s of products), plain "
              f"{t_p:.3f} ms, sdpa {name} {t_l:.3f} ms ({t_k / t_l:.2f}x), "
              f"bound {b[0]:.3f} ms ({b[1]}, tensor cores) / {c[0]:.3f} ms "
              "(fp32 CUDA cores)")
        path, n = (("training", launches) if dtype == f32
                   else ("amp_training", amp_launches))
        rows.append(row("flash_attention_qkv_fwd", path,
                        "flash_attention.cu",
                        "paddle_tpu/kernels/flash_attention.py:329",
                        n["attention_fwd"], e_fwd, t_k, t_p, b, t_l))
        del x, m4, q4, k4, v4

    pairs = B * H * S * S
    for dtype in (f32, torch.bfloat16):
        name = str(dtype)[6:]
        if dtype != f32:  # BERT AMP's bf16 activations
            qkv, do = qkv.to(dtype), do.to(dtype)
            q, k, v = (x.to(dtype) for x in (q, k, v))
            mask = mask.to(dtype)
            dqkv, dbias = fa.fused_attention_qkv_bwd(qkv, H, bias, do,
                                                     want_dbias=True, **kw)
            want_q, want_b = fa.reference_qkv_bwd(qkv, H, bias, do, **kw)
            e_pair = compare(dqkv, want_q, "attention_bwd", dtype,
                             f"attention bwd dqkv B={B} S={S} {name}")
            compare(dbias, want_b, "attention_bwd", f32,
                    f"attention bwd dbias B={B} S={S} {name}")
            del dqkv, dbias, want_q, want_b
        else:
            e_pair = err["attention_bwd"]
        t = launch_ms(lambda: fa.fused_attention_qkv_bwd(qkv, H, bias, do,
                                                         **kw),
                      (("flash_attention", "flash_attention_bwd_dq"),
                       ("flash_attention", "flash_attention_bwd_dkv")))
        t_dq, t_dkv = (t["flash_attention_bwd_dq"],
                       t["flash_attention_bwd_dkv"])
        t_pair = cuda_ms(lambda: fa.fused_attention_qkv_bwd(qkv, H, bias, do,
                                                            **kw),
                         iters=10, reps=5)
        t_p = cuda_ms(lambda: fa.reference_qkv_bwd(qkv, H, bias, do, **kw),
                      iters=2, reps=3)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                             dropout_p=TRAIN_RATE,
                                             scale=0.125)
        do4 = do.view(B, S, H, D).transpose(1, 2)
        t_l = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                                  retain_graph=True),
                      iters=10, reps=5)
        esz = qkv.element_size()
        head = B * S * H * D * esz
        reads = qkv.numel() * esz + head + bias.numel() * 4  # qkv, dO, bias
        # the function's 8*B*H*S^2*D split by the products each kernel
        # owns (dP, dQ to dq; dV, dK to dkv): on the fp32 CUDA cores; the
        # rows' bound: 3xTF32 on the tensor cores in fp32, bf16's peak in
        # bf16
        ops = 4 * pairs * D
        b_pair = bound(reads + 3 * head, 2 * ops, f32)
        c_dq = bound(reads / 2 + head, ops, f32)
        c_dkv = bound(reads / 2 + 2 * head, ops, f32)
        ops, peak = (3 * ops, "tf32") if dtype == f32 else (ops, dtype)
        b_dq = bound(reads / 2 + head, ops, peak)
        b_dkv = bound(reads / 2 + 2 * head, ops, peak)
        # not a bound: the TF32 products the kernels do at 495 TFLOP/s
        n_dq, n_dkv = PAIR_TF32[dtype]
        r_dq, r_dkv = (n * 2 * pairs * D / PEAK_OPS["tf32"] * 1e3
                       for n in (n_dq, n_dkv))
        print(f"attention bwd {name}: dq kernel {t_dq:.3f} ms (bound "
              f"{b_dq[0]:.3f} {b_dq[1]}; fp32 CUDA cores {c_dq[0]:.3f}; "
              f"its {n_dq} TF32 products {r_dq:.3f}), dkv kernel "
              f"{t_dkv:.3f} ms (bound {b_dkv[0]:.3f} {b_dkv[1]}; CUDA "
              f"cores {c_dkv[0]:.3f}; its {n_dkv} TF32 products "
              f"{r_dkv:.3f}) (own launches); both through the wrapper "
              f"{t_pair:.3f} ms (bound {b_dq[0] + b_dkv[0]:.3f}; the "
              f"function on the fp32 CUDA cores {b_pair[0]:.3f}); plain "
              f"{t_p:.3f} ms; sdpa {name} backward {t_l:.3f} ms "
              f"({t_pair / t_l:.2f}x)")
        path = "training" if dtype == f32 else "amp_training"
        n = launches if dtype == f32 else amp_launches
        for which, t_k, b in (("dq", t_dq, b_dq), ("dkv", t_dkv, b_dkv)):
            rows.append(row(f"flash_attention_qkv_bwd_{which}", path,
                            "flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:342",
                            n[f"attention_bwd_{which}"], e_pair, t_k, t_p, b,
                            t_l))
        del qg, kg, vg, out, do4
    del qkv, bias, do, q, k, v, mask
    torch.cuda.empty_cache()

    x, y, g, c = res_inputs(R, N, f32, SEED)
    do = torch.randn(R, N, device="cuda")
    rkw = dict(rate=TRAIN_RATE, is_test=False, eps=1e-5, seed=MASK_SEED)
    t_k = cuda_ms(lambda: fr.fused_dropout_add_ln_fwd(x, y, g, c, **rkw))
    t_p = cuda_ms(lambda: fr.reference_fwd(x, y, g, c, **rkw), iters=10,
                  reps=5)
    t_l = cuda_ms(lambda: F.layer_norm(x + y, (N,), g, c, 1e-5))
    b = res_bound(x, N)
    print(f"residual fwd: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"F.layer_norm(x + y) {t_l:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    rows.append(row("fused_dropout_add_ln_fwd", "training",
                    "fused_dropout_add_ln.cu",
                    "paddle_tpu/kernels/fused_residual.py:90",
                    launches["residual_fwd"], err["residual_fwd"], t_k, t_p,
                    b, t_l))
    groups, rows_per_group = fr.bwd_groups(R)
    print(f"residual bwd: {groups} row groups of {rows_per_group} rows, "
          f"partials [2, {groups}, {N}]")
    for dtype in (f32, torch.bfloat16):
        name = str(dtype)[6:]
        # BERT AMP's activations: x, y and dO bf16, g and c fp32
        xd, yd, dod = (t.to(dtype) for t in (x, y, do))
        if dtype == f32:
            e_bwd = err["residual_bwd"]
        else:
            got = fr.fused_dropout_add_ln_bwd(xd, yd, g, dod, **rkw)
            want = fr.reference_bwd(xd, yd, g, dod, **rkw)
            e_bwd = max(compare(a, w, "residual_bwd", dtype,
                                f"residual bwd {n} R={R} {name}")
                        for a, w, n in zip(got[:2], want[:2], ("dx", "dy")))
            for a, w, n in zip(got[2:], want[2:], ("dg", "dc")):
                compare(a, w, "residual_sums", f32,
                        f"residual bwd {n} R={R} {name}")
            del got, want
        t = launch_ms(
            lambda: fr.fused_dropout_add_ln_bwd(xd, yd, g, dod, **rkw),
            (("fused_dropout_add_ln", "fused_dropout_add_ln_bwd"),
             ("sum_partials", "sum_partials")), iters=20)
        t_k = t["fused_dropout_add_ln_bwd"]
        if dtype == f32:  # the sum_partials row's time
            t_s = t["sum_partials"]
        t_both = cuda_ms(
            lambda: fr.fused_dropout_add_ln_bwd(xd, yd, g, dod, **rkw))
        t_p = cuda_ms(lambda: fr.reference_bwd(xd, yd, g, dod, **rkw),
                      iters=10, reps=5)
        # the library's layer_norm takes scale and bias of x's dtype
        xg, yg, gg, cg = (t.detach().to(dtype).requires_grad_()
                          for t in (xd, yd, g, c))
        ln = F.layer_norm(xg + yg, (N,), gg, cg, 1e-5)
        t_l = cuda_ms(lambda: torch.autograd.grad(ln, (xg, yg, gg, cg), dod,
                                                  retain_graph=True))
        # the function's bytes: x, y, dO and g read, dx, dy, dg and dc
        # written (not the kernel's own partials); fp32 arithmetic on
        # the CUDA cores in both dtypes
        esz = xd.element_size()
        b = bound(5 * R * N * esz + N * 4 + 2 * N * 4, 20 * R * N, f32)
        print(f"residual bwd {name}: row kernel {t_k:.4f} ms (own "
              f"launches), bound {b[0]:.4f} ms ({b[1]}); with "
              f"sum_partials through the wrapper {t_both:.4f} ms; plain "
              f"{t_p:.4f} ms, F.layer_norm backward {t_l:.4f} ms "
              f"({t_both / t_l:.2f}x)")
        path = "training" if dtype == f32 else "amp_training"
        n = launches if dtype == f32 else amp_launches
        rows.append(row("fused_dropout_add_ln_bwd", path,
                        "fused_dropout_add_ln.cu",
                        "paddle_tpu/kernels/fused_residual.py:104",
                        n["residual_bwd"], e_bwd, t_k, t_p, b, t_l))
        del xd, yd, dod, xg, yg, gg, cg, ln
    part = torch.randn(2, groups, N, device="cuda")
    t_sp = cuda_ms(lambda: sp.reference(part))
    b = bound(part.numel() * 4 + 2 * N * 4, part.numel(), f32)
    s_err = (sp.sum_partials(part) - sp.reference(part)).abs().max().item()
    print(f"sum_partials [2, {groups}, {N}]: kernel {t_s:.4f} ms (own "
          f"launches in the residual backward's calls), plain "
          f"(= library, part.sum(1)) {t_sp:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]}), max_abs_err {s_err:.2e}")
    check(s_err <= 1e-4, f"sum_partials disagrees: {s_err}")
    rows.append(row("sum_partials", "training", "sum_partials.cu",
                    "paddle_tpu/kernels/fused_residual.py:104",
                    launches["sum_partials"], s_err, t_s, t_sp, b, t_sp))
    return rows


def gpt_kernel_times(fa, ft, err, train_n, serve_n, amp_n):
    """#7-#9 at the GPT training path's shape (B=4, S=2048, H=12, D=64,
    causal, no key bias, fp32, dropout 0.1 in training) and #1 at the GPT
    serving path's full recompute (B=8, S=256, causal, test mode). Bounds
    count the live S(S+1)/2 pairs of each head, two flops per
    multiply-add, no recomputation; #7 reads qkv and writes out and lse,
    its two products on the tensor cores as 3xTF32 (fwd_bound, with the
    fp32 CUDA-core bound beside it); the backward as a function does 8*B*H*D*pairs flops
    (dP, dQ to #9; dV, dK to #8) and reads qkv, dO, out and lse once, split
    in halves between the two kernels, #9 writing dq and #8 dk and dv. The
    pair runs on the tensor cores, so its fp32 rows carry those operations
    as three TF32 terms each (3xTF32) at 495 TFLOP/s and its bf16 rows at
    989 TFLOP/s bf16 (or the bytes, whichever is larger); the fp32
    CUDA-core bound, the time of the TF32 products the kernels do
    (TILED_TF32) and their TFLOP/s of products are printed beside them.
    The pair is timed again in bf16 at the GPT AMP path's bf16 activations
    (its rows' launches are that path's, flag off), held against the plain
    version, with scaled_dot_product_attention's bf16 causal backward
    beside it. #8 and #9 are timed by CUDA events around each launch in the
    wrapper's calls (launch_ms). #7 is timed again in bf16 at the GPT AMP
    path's activations (its row's launches are that path's), held against
    the plain version, beside SDPA's bf16 causal forward; #1's row
    carries its two products as 3xTF32 (fwd_bound) too."""
    import torch.nn.functional as F

    B, S, H, D = GPT_B, GPT_S, 12, 64
    f32, es = torch.float32, 4
    print(f"== kernel times, GPT training shape (B={B}, S={S}, H={H}, D={D}, "
          f"causal, fp32, dropout {TRAIN_RATE} in training)")
    kw = dict(scale=0.125, rate=TRAIN_RATE, is_test=False, causal=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda")
    do = torch.randn(B, S, H * D, generator=g, device="cuda")
    q, k, v = (t.contiguous() for t in
               qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4))
    pairs = live_pairs(S, True)
    head = B * S * H * D * es
    lse_bytes = B * H * S * 4
    rows = []
    t_k = cuda_ms(lambda: ft.flash_tiled_fwd(qkv, None, MASK_SEED, H, D, **kw),
                  iters=10, reps=5)
    t_p = cuda_ms(lambda: ft.reference_fwd(qkv, None, MASK_SEED, H, D, **kw),
                  iters=2, reps=3)
    t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, dropout_p=TRAIN_RATE, scale=0.125),
        iters=10, reps=5)
    ops = 4 * B * H * D * pairs
    b, c = fwd_bound(qkv.numel() * es + head + lse_bytes, ops, f32)
    print(f"tiled fwd (#7): kernel {t_k:.3f} ms ({ops / t_k / 1e9:.1f} "
          f"TFLOP/s of products), plain {t_p:.3f} ms, sdpa {t_l:.3f} ms "
          f"({t_k / t_l:.2f}x), bound {b[0]:.3f} ms ({b[1]}, tensor cores) "
          f"/ {c[0]:.3f} ms (fp32 CUDA cores)")
    rows.append(row("flash_tiled_fwd", "gpt_training", "flash_tiled.cu",
                    "paddle_tpu/kernels/flash_tiled.py:127",
                    train_n["tiled_fwd"], err["tiled_fwd"], t_k, t_p, b, t_l))
    # at GPT AMP's bf16 activations (the bound at bf16's peak, as every
    # bf16 row's)
    bf = torch.bfloat16
    xb = qkv.to(bf)
    qb, kb, vb = (t.to(bf) for t in (q, k, v))
    out_b, lse_b = ft.flash_tiled_fwd(xb, None, MASK_SEED, H, D, **kw)
    want_o, want_l = ft.reference_fwd(xb, None, MASK_SEED, H, D, **kw)
    e_b = compare(out_b, want_o, "attention", bf,
                  f"tiled fwd B={B} S={S} bfloat16")
    compare(lse_b, want_l, "lse", f32, f"tiled fwd lse B={B} S={S} bfloat16")
    del out_b, lse_b, want_o, want_l
    t_k = cuda_ms(lambda: ft.flash_tiled_fwd(xb, None, MASK_SEED, H, D, **kw),
                  iters=10, reps=5)
    t_p = cuda_ms(lambda: ft.reference_fwd(xb, None, MASK_SEED, H, D, **kw),
                  iters=2, reps=3)
    t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True, dropout_p=TRAIN_RATE, scale=0.125),
        iters=10, reps=5)
    b, c = fwd_bound(xb.numel() * 2 + head // 2 + lse_bytes, ops, bf)
    print(f"tiled fwd (#7) bfloat16: kernel {t_k:.3f} ms, plain {t_p:.3f} "
          f"ms, sdpa bfloat16 causal {t_l:.3f} ms ({t_k / t_l:.2f}x), bound "
          f"{b[0]:.3f} ms ({b[1]}) / {c[0]:.3f} ms (fp32 CUDA cores)")
    rows.append(row("flash_tiled_fwd", "gpt_amp_training", "flash_tiled.cu",
                    "paddle_tpu/kernels/flash_tiled.py:127",
                    amp_n["tiled_fwd"], e_b, t_k, t_p, b, t_l))
    del xb, qb, kb, vb

    flops = 2 * B * H * D * pairs  # one product over the live pairs
    for dtype in (f32, torch.bfloat16):
        name = str(dtype)[6:]
        if dtype != f32:  # GPT AMP's bf16 activations
            qkv, do = qkv.to(dtype), do.to(dtype)
            q, k, v = (x.to(dtype) for x in (q, k, v))
        out, lse = ft.flash_tiled_fwd(qkv, None, MASK_SEED, H, D, **kw)
        if dtype != f32:
            dqkv, _ = ft.flash_tiled_bwd(qkv, None, MASK_SEED, do, out, lse,
                                         H, D, **kw)
            want, _ = ft.reference_bwd(qkv, None, MASK_SEED, do, out, lse, H,
                                       D, **kw)
            e_q = compare(dqkv[..., :H * D], want[..., :H * D],
                          "attention_bwd", dtype, f"tiled dq B={B} S={S} "
                          f"{name}")
            e_kv = compare(dqkv[..., H * D:], want[..., H * D:],
                           "attention_bwd", dtype, f"tiled dkv B={B} S={S} "
                           f"{name}")
            del dqkv, want
        else:
            e_q, e_kv = err["tiled_bwd_dq"], err["tiled_bwd_dkv"]
        t = launch_ms(lambda: ft.flash_tiled_bwd(qkv, None, MASK_SEED, do,
                                                 out, lse, H, D, **kw),
                      (("flash_tiled", "flash_tiled_bwd_dq"),
                       ("flash_tiled", "flash_tiled_bwd_dkv")))
        t_dq, t_dkv = t["flash_tiled_bwd_dq"], t["flash_tiled_bwd_dkv"]
        t_pair = cuda_ms(lambda: ft.flash_tiled_bwd(qkv, None, MASK_SEED, do,
                                                    out, lse, H, D, **kw),
                         iters=10, reps=5)
        t_p = cuda_ms(lambda: ft.reference_bwd(qkv, None, MASK_SEED, do, out,
                                               lse, H, D, **kw),
                      iters=2, reps=3)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                            dropout_p=TRAIN_RATE, scale=0.125)
        do4 = do.view(B, S, H, D).transpose(1, 2)
        t_l = cuda_ms(lambda: torch.autograd.grad(o4, (qg, kg, vg), do4,
                                                  retain_graph=True),
                      iters=10, reps=5)
        esz = qkv.element_size()
        head = B * S * H * D * esz
        reads = qkv.numel() * esz + 2 * head + lse_bytes  # qkv, dO, out, lse
        # the function's 8*B*H*D*pairs split by the products each kernel
        # owns (dP, dQ to #9; dV, dK to #8): on the fp32 CUDA cores; the
        # rows' bound: 3xTF32 on the tensor cores in fp32, bf16's peak in
        # bf16
        c_dq = bound(reads / 2 + head, 2 * flops, f32)
        c_dkv = bound(reads / 2 + 2 * head, 2 * flops, f32)
        ops, peak = (6 * flops, "tf32") if dtype == f32 else (2 * flops,
                                                              dtype)
        b_dq = bound(reads / 2 + head, ops, peak)
        b_dkv = bound(reads / 2 + 2 * head, ops, peak)
        # not a bound: the TF32 products the kernels do at 495 TFLOP/s
        n_dq, n_dkv = TILED_TF32[dtype]
        r_dq, r_dkv = (n * flops / PEAK_OPS["tf32"] * 1e3
                       for n in (n_dq, n_dkv))
        # TFLOP/s of the products done (#9: 3, #8: 4, each of `flops`)
        f_dq, f_dkv = 3 * flops / t_dq / 1e9, 4 * flops / t_dkv / 1e9
        f_pair = 7 * flops / t_pair / 1e9
        print(f"tiled bwd {name}: dq (#9) {t_dq:.3f} ms (bound "
              f"{b_dq[0]:.3f} {b_dq[1]}; fp32 CUDA cores {c_dq[0]:.3f}; its "
              f"{n_dq} TF32 products {r_dq:.3f}; {f_dq:.1f} TFLOP/s of "
              f"products), dkv (#8) {t_dkv:.3f} ms (bound {b_dkv[0]:.3f} "
              f"{b_dkv[1]}; CUDA cores {c_dkv[0]:.3f}; its {n_dkv} TF32 "
              f"products {r_dkv:.3f}; {f_dkv:.1f} TFLOP/s) (own launches); "
              f"both through the wrapper {t_pair:.3f} ms ({f_pair:.1f} "
              f"TFLOP/s of products, 7 of 2*B*H*D*pairs; bound "
              f"{b_dq[0] + b_dkv[0]:.3f}); plain {t_p:.3f} ms; sdpa {name} "
              f"causal backward {t_l:.3f} ms ({t_pair / t_l:.2f}x)")
        path = "gpt_training" if dtype == f32 else "gpt_amp_training"
        n = train_n if dtype == f32 else amp_n
        for which, src, t_w, b_w, e_w in (("dq", 342, t_dq, b_dq, e_q),
                                          ("dkv", 269, t_dkv, b_dkv, e_kv)):
            rows.append(row(f"flash_tiled_bwd_{which}", path,
                            "flash_tiled.cu",
                            f"paddle_tpu/kernels/flash_tiled.py:{src}",
                            n[f"tiled_bwd_{which}"], e_w, t_w, t_p, b_w,
                            t_l))
        del qg, kg, vg, o4, do4, out, lse
    del qkv, do, q, k, v
    torch.cuda.empty_cache()

    Bs, Ss = GEN_BATCH, GEN_MAX
    print(f"== kernel times, GPT serving's full recompute (B={Bs}, S={Ss}, "
          f"H={H}, D={D}, causal, test mode)")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    qkv = torch.randn(Bs, Ss, 3 * H * D, generator=g, device="cuda")
    skw = dict(scale=0.125, dropout_rate=RATE, is_test=True, causal=True)
    e = compare(fa.fused_attention_qkv(qkv, H, **skw),
                fa.reference_qkv(qkv, H, **skw), "attention", f32,
                f"attention B={Bs} S={Ss} causal test mode")
    q, k, v = qkv.view(Bs, Ss, 3, H, D).permute(2, 0, 3, 1, 4)
    t_k = cuda_ms(lambda: fa.fused_attention_qkv(qkv, H, **skw))
    t_p = cuda_ms(lambda: fa.reference_qkv(qkv, H, **skw))
    t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=0.125))
    b, c, ops = attn_bound(qkv, None, H, causal=True)
    print(f"attention (#1): kernel {t_k:.4f} ms ({ops / t_k / 1e9:.1f} "
          f"TFLOP/s of products), plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]}, tensor cores) / {c[0]:.4f} ms "
          "(fp32 CUDA cores)")
    rows.append(row("flash_attention_qkv", "gpt_serving",
                    "flash_attention.cu",
                    "paddle_tpu/kernels/flash_attention.py:329",
                    serve_n["attention_fwd"], e, t_k, t_p, b, t_l))
    return rows


def ln_kernel_times(lnk, err, launches):
    """#10 and #11 at the GPT AMP path's shape, R = B*S = 8192 rows of
    N = 768, with bf16 x, scale and bias (the path's dtypes), then an fp32
    line. Bounds: #10 reads x and writes y and the fp32 mean and var, #11
    reads x and dy and writes dx and the fp32 dscale and dbias (scale and
    bias read once), over 3.35 TB/s; ~8 (#10) and ~16 (#11) operations an
    element at the inputs' dtype's peak. #11's time is the wrapper's (the
    row kernel and its sum_partials), the split from CUDA events around
    each launch (launch_ms). Library: F.layer_norm and its autograd
    backward at the same shape and dtypes."""
    import torch.nn.functional as F

    R, N = GPT_B * GPT_S, 768
    print(f"== kernel times, GPT AMP path's layer_norm (R={R}, N={N})")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name, es = str(dtype)[6:], dtype.itemsize
        x, dy, s, b = ln_inputs(R, N, dtype, dtype, SEED)
        t_k = cuda_ms(lambda: lnk.layer_norm_fwd(x, s, b, 1e-5))
        t_p = cuda_ms(lambda: lnk.reference_fwd(x, s, b, 1e-5))
        t_l = cuda_ms(lambda: F.layer_norm(x, (N,), s, b, 1e-5))
        b_f = bound(2 * R * N * es + 2 * N * es + 2 * R * 4, 8 * R * N,
                    dtype)
        print(f"layer_norm fwd (#10) {name}: kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, F.layer_norm {t_l:.4f} ms, bound "
              f"{b_f[0]:.4f} ms ({b_f[1]})")
        t = launch_ms(lambda: lnk.layer_norm_bwd(x, s, dy, 1e-5),
                      (("layer_norm", "layer_norm_bwd"),
                       ("sum_partials", "sum_partials")), iters=20)
        t_b = cuda_ms(lambda: lnk.layer_norm_bwd(x, s, dy, 1e-5))
        t_pb = cuda_ms(lambda: lnk.reference_bwd(x, s, dy, 1e-5))
        xg, sg, bg = (v.detach().requires_grad_() for v in (x, s, b))
        out = F.layer_norm(xg, (N,), sg, bg, 1e-5)
        t_lb = cuda_ms(lambda: torch.autograd.grad(out, (xg, sg, bg), dy,
                                                   retain_graph=True))
        b_b = bound(3 * R * N * es + N * es + 2 * N * 4, 16 * R * N, dtype)
        print(f"layer_norm bwd (#11) {name}: {t_b:.4f} ms through the "
              f"wrapper (row kernel {t['layer_norm_bwd']:.4f} ms, "
              f"sum_partials {t['sum_partials']:.4f} ms), plain "
              f"{t_pb:.4f} ms, F.layer_norm backward {t_lb:.4f} ms, bound "
              f"{b_b[0]:.4f} ms ({b_b[1]})")
        if dtype == torch.bfloat16:
            rows.append(row("layer_norm_fwd", "gpt_amp_training",
                            "layer_norm.cu",
                            "paddle_tpu/kernels/layer_norm.py:50",
                            launches["layer_norm_fwd"],
                            err["layer_norm_fwd"], t_k, t_p, b_f, t_l))
            rows.append(row("layer_norm_bwd", "gpt_amp_training",
                            "layer_norm.cu",
                            "paddle_tpu/kernels/layer_norm.py:65",
                            launches["layer_norm_bwd"],
                            err["layer_norm_bwd"], t_b, t_pb, b_b, t_lb))
        del x, dy, s, b, xg, sg, bg, out
    return rows


# ---------------------------------------------------------------------------
# ERNIE-layout encoder: layers.fused_multihead_attention (#5, #6), io
# checkpoints and the inference predictor
# ---------------------------------------------------------------------------

# the slice's attention shapes: BertConfig.base() heads at B=32, S=512
MHA_B, MHA_S, MHA_H, MHA_D = 32, 512, 12, 64
MHA_BUCKETS = (1, 2, 4, 8)
# predictor answers vs a direct run of the frozen program (12 fp32 layers,
# probabilities; the padded batch may take other cuBLAS kernels)
PRED_ATOL = 1e-5
# bf16 predictor vs fp32 predictor: probabilities of a 2-way softmax
# after 12 layers on bf16 activations, batches of 8 from BF16_PROBES seeds.
# On the H100 the five seeds' readings ran 1.7e-4 to 8.7e-4 (PERF.md); the
# limit is about 3.5 times the largest
PRED_BF16_ATOL = 3e-3
BF16_PROBES = 5


def mha_inputs(B, S, H, D, dtype, seed):
    """q, k, v as the program hands them to #5: [B, H, S, D] head-split
    views (reshape + transpose) of one [B, S, 3*H*D] projection, which
    share their strides; the projection; a key bias with padded tails."""
    qkv, bias = attn_inputs(B, H, D, dtype, seed, S=S)
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
    return q, k, v, qkv, bias


def mha_parity(fa):
    """#5 and #6 against their plain versions on the card: fp32 and bf16,
    with and without the key bias, causal, test-mode scaling and training
    dropout, at the slice's shapes (B=32, S=512) and small ones, other head
    dims and an S that is no multiple of the tile; and #5/#6 on the heads
    of a packed projection against #1/#3 on the projection itself, dropout
    on (one mask, one set of kernels, two addressings). Returns the fp32
    errors at the training path's case."""
    print("== parity, 4-D attention: #5/#6 vs plain version on the card")
    err = {}
    cases = []
    for B, S in ((2, 128), (MHA_B, MHA_S)):
        for dtype in (torch.float32, torch.bfloat16):
            for training in (True, False):
                cases.append((B, S, 12, 64, dtype, training, True, False))
    cases += [(2, 128, 12, 64, torch.float32, True, False, False),
              (2, 128, 12, 64, torch.float32, True, True, True),
              (2, 128, 12, 64, torch.bfloat16, False, False, True),
              (2, 77, 4, 32, torch.float32, True, True, True),
              (2, 200, 2, 128, torch.bfloat16, True, True, False)]
    for i, (B, S, H, D, dtype, training, with_bias, causal) in \
            enumerate(cases):
        q, k, v, _, bias = mha_inputs(B, S, H, D, dtype, SEED + 31 * i)
        bias = bias if with_bias else None
        g = torch.Generator(device="cuda").manual_seed(SEED + i)
        do = torch.randn(B, H, S, D, generator=g, device="cuda").to(dtype)
        kw = dict(scale=1.0 / math.sqrt(D), dropout_rate=TRAIN_RATE,
                  is_test=not training, causal=causal,
                  seed=MASK_SEED if training else None)
        tag = (f"B={B} S={S} H={H} D={D} {str(dtype)[6:]} "
               f"{'training' if training else 'test mode'} "
               f"bias={with_bias} causal={causal}")
        e_f = compare(fa.fused_attention(q, k, v, bias, **kw),
                      fa.reference(q, k, v, bias, **kw), "attention", dtype,
                      f"mha fwd {tag}")
        got = fa.attention_grads(q, k, v, bias, do, want_dbias=True, **kw)
        want = fa.reference_bwd(q, k, v, bias, do, **kw)
        e_b = max(compare(a, w, "attention_bwd", dtype, f"mha bwd {n} {tag}")
                  for n, a, w in zip(("dq", "dk", "dv"), got[:3], want[:3]))
        compare(got[3], want[3], "attention_bwd", torch.float32,
                f"mha bwd dbias {tag}")
        if (B, S, dtype, training, with_bias) == (MHA_B, MHA_S,
                                                  torch.float32, True, True):
            err["mha_fwd"], err["mha_bwd"] = e_f, e_b
    # #5 on the heads of a packed projection is #1 on the projection, and
    # #6 is #3: the same kernels, launched by the 4-D wrappers on the
    # head-split views and by the packed ones on the projection's strides
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, qkv, bias = mha_inputs(MHA_B, MHA_S, MHA_H, MHA_D, dtype,
                                        SEED)
        kw = dict(scale=0.125, dropout_rate=TRAIN_RATE, is_test=False,
                  seed=MASK_SEED)
        B, S, HD = MHA_B, MHA_S, MHA_H * MHA_D
        out4 = fa.fused_attention(q, k, v, bias, **kw)
        out1 = fa.fused_attention_qkv(qkv, MHA_H, bias, **kw)
        packed = out4.transpose(1, 2).reshape(B, S, HD)
        do = torch.randn(B, S, HD, device="cuda").to(dtype)
        do4 = do.view(B, S, MHA_H, MHA_D).transpose(1, 2)
        dq, dk, dv, db4 = fa.attention_grads(q, k, v, bias, do4, **kw)
        dqkv, db1 = fa.fused_attention_qkv_bwd(qkv, MHA_H, bias, do,
                                               want_dbias=True, **kw)
        grads = torch.cat([t.transpose(1, 2).reshape(B, S, HD)
                           for t in (dq, dk, dv)], -1)
        torch.cuda.synchronize()
        same = [torch.equal(packed, out1), torch.equal(grads, dqkv),
                torch.equal(db4, db1)]
        diffs = [(a.float() - b.float()).abs().max().item()
                 for a, b in ((packed, out1), (grads, dqkv), (db4, db1))]
        print(f"#5/#6 on unpack(qkv) vs #1/#3 on qkv, {str(dtype)[6:]}, "
              f"dropout {TRAIN_RATE} in training: out, dqkv, dbias bit-equal "
              f"{same}, max_abs_diff {[f'{d:.2e}' for d in diffs]}")
        check(diffs[0] <= TOL["attention"][dtype][0] and
              max(diffs[1:]) <= TOL["attention_bwd"][dtype][0],
              "#5/#6 on the heads of a projection differ from #1/#3")
    return err


def build_mha_classifier(fluid, layers, cfg, B, S, is_test):
    """(main, startup, loss, prob) of the ERNIE-layout classifier at batch
    B (-1: set at run time) and sequence S: bert_encoder's embeddings and
    LayerNorm; per layer fc query/key/value projections (768 -> 768),
    reshape to [B, S, 12, 64] and transpose [0, 2, 1, 3],
    layers.fused_multihead_attention with the key bias of the input mask,
    transpose and reshape back, the output fc, fused_dropout_add_ln, the
    gelu FFN and fused_dropout_add_ln again; the [CLS] row -> fc(2) ->
    softmax_with_cross_entropy -> mean, and softmax for predictions.
    tests/torch_mha_classifier.py builds the same program."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    init = fluid.initializer.Normal(0.0, cfg.initializer_range)
    nh, h = cfg.num_heads, cfg.hidden_size
    dh = h // nh

    def dense(t, size, name, act=None):
        return layers.fc(
            t, size=size, num_flatten_dims=2, act=act,
            param_attr=fluid.ParamAttr(name=f"{name}_w", initializer=init),
            bias_attr=fluid.ParamAttr(name=f"{name}_b"))

    def heads(t):
        return layers.transpose(layers.reshape(t, [-1, S, nh, dh]),
                                [0, 2, 1, 3])

    def residual_ln(a, branch, name):
        return layers.fused_dropout_add_ln(
            a, branch, cfg.hidden_dropout, is_test=is_test,
            param_attr=fluid.ParamAttr(name=f"{name}_scale"),
            bias_attr=fluid.ParamAttr(name=f"{name}_bias"))

    with fluid.program_guard(main, startup):
        ids = fluid.data("ids", [B, S], "int64")
        types = fluid.data("types", [B, S], "int64")
        mask = fluid.data("mask", [B, S], "float32")
        label = fluid.data("label", [B, 1], "int64")
        emb = layers.embedding(
            ids, size=[cfg.vocab_size, h],
            param_attr=fluid.ParamAttr(name="word_embedding",
                                       initializer=init))
        pos = layers.reshape(layers.range(0, S, 1, "int64"), [1, S])
        emb = emb + layers.embedding(
            pos, size=[cfg.max_position, h],
            param_attr=fluid.ParamAttr(name="pos_embedding",
                                       initializer=init))
        emb = emb + layers.embedding(
            types, size=[cfg.type_vocab_size, h],
            param_attr=fluid.ParamAttr(name="sent_embedding",
                                       initializer=init))
        x = layers.layer_norm(
            emb, begin_norm_axis=2,
            param_attr=fluid.ParamAttr(name="pre_encoder_layer_norm_scale"),
            bias_attr=fluid.ParamAttr(name="pre_encoder_layer_norm_bias"))
        x = layers.dropout(x, cfg.hidden_dropout, is_test=is_test)
        key_bias = layers.scale(mask, scale=1e4, bias=-1e4)
        for i in range(cfg.num_layers):
            p = f"encoder_layer_{i}"
            q, k, v = (heads(dense(x, h, f"{p}_{n}"))
                       for n in ("query", "key", "value"))
            ctx = layers.fused_multihead_attention(
                q, k, v, key_bias, scale=1.0 / math.sqrt(dh),
                dropout_prob=cfg.attention_dropout, is_test=is_test)
            ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]),
                                 [-1, S, h])
            x = residual_ln(x, dense(ctx, h, f"{p}_output"),
                            f"{p}_post_att")
            ffn = layers.gelu(dense(x, cfg.intermediate_size, f"{p}_ffn_0"),
                              approximate=True)
            x = residual_ln(x, dense(ffn, h, f"{p}_ffn_1"), f"{p}_post_ffn")
        cls = layers.slice(x, [1], [0], [1])
        logits = layers.fc(
            cls, size=2,
            param_attr=fluid.ParamAttr(name="cls_out_w", initializer=init),
            bias_attr=fluid.ParamAttr(name="cls_out_b"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        prob = layers.softmax(logits)
    return main, startup, loss, prob


def build_mha_training(fluid, layers, cfg, B, S, lr):
    """The classifier with Adam(lr): (main, startup, loss, prob, pg)."""
    from paddle_tpu_torch.optimizer import Adam

    with fluid.unique_name.guard():
        main, startup, loss, prob = build_mha_classifier(fluid, layers, cfg,
                                                         B, S, False)
        with fluid.program_guard(main, startup):
            _, pg = Adam(lr).minimize(loss, startup)
    return main, startup, loss, prob, pg


def mha_feeds(cfg, B, S, n, seed=0):
    """n batches from RandomState(seed): random ids and types, a padded
    tail of keys in every other sample, random labels."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.ones((B, S), np.float32)
        for b in range(1, B, 2):
            mask[b, S - 1 - (b * 7) % (S // 2):] = 0.0
        out.append({
            "ids": rng.randint(0, cfg.vocab_size, (B, S)).astype("int64"),
            "types": rng.randint(0, cfg.type_vocab_size,
                                 (B, S)).astype("int64"),
            "mask": mask,
            "label": rng.randint(0, 2, (B, 1)).astype("int64"),
        })
    return out


def mha_train_small(fluid, layers):
    """Two Adam steps of the ERNIE-layout classifier at BERT-base width, 2
    layers, B=2, S=128, dropout 0, on the card and on the CPU from one
    state, under phase 5's tolerances."""
    from paddle_tpu_torch.models.bert import BertConfig

    print("== ERNIE-layout training, reduced depth: BERT-base width, 2 "
          f"layers, B=2, S=128, no dropout, lr {SMALL_LR:g}; card vs "
          "CPUPlace()")
    cfg = BertConfig.base()
    cfg.num_layers = 2
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    main, startup, loss, _, pg = build_mha_training(fluid, layers, cfg, -1,
                                                    128, SMALL_LR)
    check(sum(op.type == "fused_multihead_attention_grad"
              for op in main.global_block.ops) == 2,
          "the program lacks its fused_multihead_attention_grad ops")
    card_vs_cpu(fluid, main, startup, loss, pg, mha_feeds(cfg, 2, 128, 2))


def _bits_equal(scope_a, scope_b, names):
    """Names whose tensors differ between two scopes (bit for bit)."""
    return [n for n in names
            if not torch.equal(scope_a.find_var(n), scope_b.find_var(n))]


def mha_checkpoint(fluid, main, exe, scope, feed, loss):
    """io.save -> io.load into a fresh scope (every persistable bit-equal);
    then one step from the saved scope on `main` and one from the loaded
    scope on the program read back from the .pdmodel (the same seed state)
    give the same loss and persistables bit for bit;
    save_persistables/load_persistables the same. The files go to a
    temporary directory that is deleted. Returns the phase's figures."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import io

    print("== checkpoint: io.save / io.load, resume, save_persistables / "
          "load_persistables")
    names = [v.name for v in main.list_vars()
             if v.persistable and not v.is_data
             and scope.find_var(v.name) is not None]
    tmp = tempfile.mkdtemp(prefix="mha_ckpt_")
    stats = {}
    try:
        path = os.path.join(tmp, "ernie")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            io.save(main, path)
        stats["save_s"] = time.perf_counter() - t0
        stats["bytes"] = {ext: os.path.getsize(path + ext) for ext in
                          (".pdparams", ".pdmodel", ".manifest.json")}
        loaded = fluid.Scope()
        t0 = time.perf_counter()
        with fluid.scope_guard(loaded):
            io.load(main, path, executor=exe)
        torch.cuda.synchronize()
        stats["load_s"] = time.perf_counter() - t0
        check(sorted(loaded.local_var_names()) == sorted(names),
              "io.load restored another set of persistables")
        bad = _bits_equal(scope, loaded, names)
        check(not bad, f"loaded persistables differ: {bad[:5]}")
        resumed = io.load_program(path)
        check(resumed._rng_step == main._rng_step
              and resumed.random_seed == main.random_seed,
              "the saved program's seed state differs from the program's")
        a = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        b = exe.run(resumed, feed=feed, fetch_list=[loss.name],
                    scope=loaded)[0]
        bad = _bits_equal(scope, loaded, names)
        print(f"resumed step: loss {a.item():.6f} (saved scope) vs "
              f"{b.item():.6f} (loaded scope, program from the .pdmodel); "
              f"{len(names) - len(bad)} of {len(names)} persistables "
              "bit-equal after the step")
        check(np.array_equal(a, b) and not bad,
              f"the resumed step differs: loss {a} vs {b}, {bad[:5]}")
        del loaded

        pdir = os.path.join(tmp, "persistables")
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            io.save_persistables(exe, pdir, main)
        stats["save_persistables_s"] = time.perf_counter() - t0
        again = fluid.Scope()
        t0 = time.perf_counter()
        with fluid.scope_guard(again):
            io.load_persistables(exe, pdir, main)
        torch.cuda.synchronize()
        stats["load_persistables_s"] = time.perf_counter() - t0
        stats["persistables_bytes"] = os.path.getsize(
            os.path.join(pdir, "__params__.npz"))
        bad = _bits_equal(scope, again, names)
        check(not bad and len(again.local_var_names()) == len(names),
              f"load_persistables differs: {bad[:5]}")
        del again
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stats["persistables"] = len(names)
    print("checkpoint: " + json.dumps(stats))
    return stats


def mha_predictor(fluid, main, prob, scope, cfg, kc):
    """io.save_inference_model of the trained program, then
    inference.create_paddle_predictor with batch buckets (1, 2, 4, 8),
    fp32 and enable_bf16(): batches of 1-8 at S=512, each answer against
    a direct Executor.run of the predictor's frozen program, #5 12 times a
    predicted batch; the bf16 predictor runs #5 on bf16 q, k, v. Returns
    (launch counts, figures)."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import inference, io

    print("== export and serve: io.save_inference_model, "
          "create_paddle_predictor, batch buckets (1, 2, 4, 8), fp32 and "
          "bf16")
    tmp = tempfile.mkdtemp(prefix="mha_model_")
    feeds = ("ids", "types", "mask")
    pool = mha_feeds(cfg, 8, MHA_S, 1, seed=SEED)[0]
    # batches of 8 from further seeds, for the bf16-vs-fp32 readings
    probes = [[b[k] for k in feeds] for b in (
        mha_feeds(cfg, 8, MHA_S, 1, seed=SEED + i)[0]
        for i in range(1, BF16_PROBES))]
    stats, counts, probed = {}, {}, {}
    try:
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            io.save_inference_model(tmp, list(feeds), [prob],
                                    main_program=main)
        stats["export_s"] = time.perf_counter() - t0
        stats["params_bytes"] = os.path.getsize(
            os.path.join(tmp, "__params__.npz"))
        for mode in ("fp32", "bf16"):
            config = inference.AnalysisConfig(tmp)
            config.set_batch_buckets(MHA_BUCKETS)
            if mode == "bf16":
                config.enable_bf16()
            pred = inference.create_paddle_predictor(config)
            blk = pred.program.global_block
            attn = [op for op in blk.ops
                    if op.type == "fused_multihead_attention"]
            dts = {blk.var(op.inputs[s][0]).dtype
                   for op in attn for s in ("Q", "K", "V")}
            check(len(attn) == cfg.num_layers and dts == (
                {"bfloat16"} if mode == "bf16" else {"float32"}),
                f"{mode} predictor: {len(attn)} attention ops on {dts}")
            answers, lat = {}, {}
            # each predicted batch: #5 once and #2 twice a layer, no other
            want = dict.fromkeys(kc, 0)
            want.update(mha_fwd=cfg.num_layers,
                        residual_fwd=2 * cfg.num_layers)
            total = dict.fromkeys(kc, 0)
            for n in (1, 2, 3, 4, 6, 8):
                inp = [pool[k][:n] for k in feeds]
                reset_counts(kc)
                out = pred.run(inp)[0].as_ndarray()
                step = read_counts(kc)
                check(step == want,
                      f"{mode} batch {n} launched {step}, want {want}")
                total = {k: total[k] + step[k] for k in total}
                direct = pred.executor.run(
                    pred.program, feed=dict(zip(feeds, inp)),
                    fetch_list=pred.get_output_names(), scope=pred.scope)[0]
                err = float(np.abs(out - direct).max())
                check(out.shape == (n, 2) and np.isfinite(out).all()
                      and err <= PRED_ATOL,
                      f"{mode} batch {n}: shape {out.shape}, error {err}")
                answers[n] = out
            counts[mode] = total
            for n in MHA_BUCKETS:
                inp = [pool[k][:n] for k in feeds]
                times = []
                for _ in range(7):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pred.run(inp)
                    times.append((time.perf_counter() - t0) * 1e3)
                lat[n] = statistics.median(times)
            probed[mode] = [answers[8]] + [pred.run(inp)[0].as_ndarray()
                                           for inp in probes]
            names, arrays = pred.run_zero_copy([pool[k][:4] for k in feeds])
            check(names == pred.get_output_names()
                  and arrays[0].flags["C_CONTIGUOUS"]
                  and np.abs(arrays[0] - answers[4]).max() <= PRED_ATOL,
                  "run_zero_copy disagrees with run")
            if mode == "bf16":
                # one reading per seed: the largest difference of its 8
                # answers from the fp32 predictor's
                errs = [float(np.abs(a - b).max())
                        for a, b in zip(probed["bf16"], probed["fp32"])]
                stats["bf16_vs_fp32_max_abs_by_seed"] = errs
                check(max(errs) <= PRED_BF16_ATOL,
                      f"bf16 answers off by {errs} (seeds {SEED}.."
                      f"{SEED + BF16_PROBES - 1}), limit {PRED_BF16_ATOL}")
            stats[f"{mode}_batch_ms"] = lat
            print(f"{mode} predictor: answers within {PRED_ATOL:g} of a "
                  "direct run at batches 1, 2, 3, 4, 6, 8 (3 and 6 padded "
                  f"to buckets 4 and 8); ms a batch by bucket {lat}; "
                  f"launches {counts[mode]}")
            del pred
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("predictor: " + json.dumps(stats))
    return counts, stats


def mha_path(fluid, layers, kc):
    """The slice's path at full width: train the ERNIE-layout classifier
    at BertConfig.base(), B=32, S=512, dropout 0.1, Adam(1e-4), fp32 (3
    warm-up and 5 timed steps, one profiled, one timed by op type; #5 and
    #6 12 times each a step, #1/#3 never), checkpoint and resume it, then
    export it and answer through the predictor. Returns (the training
    launch counts, the predictor's)."""
    from paddle_tpu_torch.models.bert import BertConfig

    B, S = MHA_B, MHA_S
    print(f"== ERNIE-layout training path: BertConfig.base() widths, B={B}, "
          f"S={S}, dropout 0.1, Adam(1e-4), fp32, through "
          "layers.fused_multihead_attention")
    cfg = BertConfig.base()
    t0 = time.perf_counter()
    main, startup, loss, prob, pg = build_mha_training(fluid, layers, cfg, -1,
                                                       S, 1e-4)
    ops = main.global_block.ops
    print(f"{len(ops)} ops of {len({op.type for op in ops})} types, "
          f"{len(pg)} parameters; built in {time.perf_counter() - t0:.1f}s")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    host_feeds = mha_feeds(cfg, B, S, 3)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in host_feeds[:2]]
    watch = ("encoder_layer_0_query_w", "encoder_layer_11_ffn_1_w",
             "cls_out_w")
    snap = {n: scope.find_var(n).clone() for n in watch}
    expect = dict.fromkeys(kc, 0)
    expect.update(mha_fwd=12, mha_bwd_dq=12, mha_bwd_dkv=12,
                  residual_fwd=24, residual_bwd=24, sum_partials=24)

    def after(i, values):
        if i == 0:
            moved = [n for n in watch
                     if not torch.equal(scope.find_var(n), snap[n])]
            check(len(moved) == len(watch), f"step 0 moved only {moved}")

    _, stats = run_steps(exe, main, scope, batches, [loss], ("loss",), kc,
                         expect, B * S, after)
    train_counts = read_counts(kc)
    print("mha training: " + json.dumps(dict(stats, ops=len(ops))))
    del batches, snap
    ckpt = mha_checkpoint(fluid, main, exe, scope, host_feeds[2], loss)
    pred_counts, pred = mha_predictor(fluid, main, prob, scope, cfg, kc)
    del exe, scope
    torch.cuda.empty_cache()
    return train_counts, pred_counts, dict(train=stats, checkpoint=ckpt,
                                           predictor=pred)


def mha_kernel_times(fa, err, train_n, pred_n):
    """#5 and #6 at the training path's shape (B=32, S=512, H=12, D=64,
    fp32, key bias, dropout 0.1 in training), on the head-split views the
    program hands them; #5 at the predictor's largest bucket (B=8, test
    mode, fp32 and the bf16 predictor's bf16 q, k, v). Bounds: q, k, v
    (and dO) read once, out (dq, dk, dv) written once, the key bias read
    once, over 3.35 TB/s; 4*B*H*S^2*D operations forward and 8*B*H*S^2*D
    backward; both run on the tensor cores, so their fp32 rows carry them
    as three TF32 terms each (3xTF32) at 495 TFLOP/s (bf16: 989 TFLOP/s),
    with the fp32 CUDA-core bound (67 TFLOP/s) beside them, and the
    time of the 27 TF32 products the kernels do (PAIR_TF32,
    recomputation included) are printed beside it. #6's time is the
    wrapper's (both kernels), the
    split from CUDA events around each launch (launch_ms); two launches
    must give the same bits, and head 0 of the kernels and of the plain
    version is measured against fp64. Library:
    scaled_dot_product_attention (and its autograd backward) on the same
    tensors."""
    import torch.nn.functional as F

    B, S, H, D = MHA_B, MHA_S, MHA_H, MHA_D
    print(f"== kernel times, 4-D attention (B={B}, S={S}, H={H}, D={D}; "
          f"fp32, dropout {TRAIN_RATE} in training)")
    f32, es, rows = torch.float32, 4, []
    kw = dict(scale=0.125, dropout_rate=TRAIN_RATE, is_test=False,
              seed=MASK_SEED)
    q, k, v, qkv, bias = mha_inputs(B, S, H, D, f32, SEED)
    mask = bias[:, None, None, :]
    head = B * H * S * D * es
    t_k = cuda_ms(lambda: fa.fused_attention(q, k, v, bias, **kw), iters=10,
                  reps=5)
    t_p = cuda_ms(lambda: fa.reference(q, k, v, bias, **kw), iters=3, reps=3)
    t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, dropout_p=TRAIN_RATE, scale=0.125),
        iters=10, reps=5)
    ops = 4 * B * H * S * S * D
    b, c = fwd_bound(4 * head + bias.numel() * 4, ops, f32)
    print(f"#5 fwd: kernel {t_k:.3f} ms ({ops / t_k / 1e9:.1f} TFLOP/s of "
          f"fp32 products), plain {t_p:.3f} ms, sdpa {t_l:.3f} ms "
          f"({t_k / t_l:.2f}x), bound {b[0]:.3f} ms ({b[1]}, 3xTF32 tensor "
          f"cores) / {c[0]:.3f} ms (fp32 CUDA cores)")
    rows.append(row("fused_mha_fwd", "mha_training",
                    "flash_attention.cu",
                    "paddle_tpu/kernels/flash_attention.py:165",
                    train_n["mha_fwd"], err["mha_fwd"], t_k, t_p, b, t_l))

    do = torch.randn(B, H, S, D, device="cuda")
    t = launch_ms(lambda: fa.attention_grads(q, k, v, bias, do,
                                             want_dbias=False, **kw),
                  (("flash_attention", "flash_attention_bwd_dq"),
                   ("flash_attention", "flash_attention_bwd_dkv")))
    t_k = cuda_ms(lambda: fa.attention_grads(q, k, v, bias, do,
                                             want_dbias=False, **kw),
                  iters=10, reps=5)
    t_p = cuda_ms(lambda: fa.reference_bwd(q, k, v, bias, do, **kw),
                  iters=2, reps=3)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                         dropout_p=TRAIN_RATE, scale=0.125)
    t_l = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                              retain_graph=True),
                  iters=10, reps=5)
    pairs = B * H * S * S
    c = bound(7 * head + bias.numel() * 4, 8 * pairs * D, f32)
    b = bound(7 * head + bias.numel() * 4, 3 * 8 * pairs * D, "tf32")
    done = sum(PAIR_TF32[f32]) * 2 * pairs * D / PEAK_OPS["tf32"] * 1e3
    tflops = 9 * 2 * pairs * D / t_k / 1e9
    print(f"#6 bwd: {t_k:.3f} ms through the wrapper (dq kernel "
          f"{t['flash_attention_bwd_dq']:.3f} ms, dkv kernel "
          f"{t['flash_attention_bwd_dkv']:.3f} ms; {tflops:.1f} TFLOP/s of "
          f"fp32 products, 9 of 2*B*H*S^2*D), plain {t_p:.3f} ms, sdpa "
          f"backward {t_l:.3f} ms ({t_k / t_l:.2f}x), bound {b[0]:.3f} ms "
          f"({b[1]}, 3xTF32 tensor cores) / {c[0]:.3f} ms (fp32 CUDA "
          f"cores); its 27 TF32 products at 495 TFLOP/s {done:.3f} ms")
    rows.append(row("fused_mha_bwd", "mha_training",
                    "flash_attention.cu",
                    "paddle_tpu/kernels/flash_attention.py:175",
                    train_n["mha_bwd_dq"], err["mha_bwd"], t_k, t_p, b, t_l))
    # fixed-order sums, no atomics: two launches give the same bits
    first = fa.attention_grads(q, k, v, bias, do, **kw)
    again = fa.attention_grads(q, k, v, bias, do, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "two launches of #6 on the same inputs differ in their bits")
    print("#6: two launches on the same inputs give the same bits (dq, dk, "
          "dv, dbias)")
    pair_f64_line(q, k, v, bias, do, first[:3],
                  fa.reference_bwd(q, k, v, bias, do, **kw)[:3], 0.125,
                  TRAIN_RATE, MASK_SEED, "#6")
    del q, k, v, qkv, bias, mask, do, qg, kg, vg, out, first, again
    torch.cuda.empty_cache()

    Bp = MHA_BUCKETS[-1]
    q32, k32, v32, _, bias = mha_inputs(Bp, S, H, D, f32, SEED + 1)
    pkw = dict(scale=0.125, dropout_rate=TRAIN_RATE, is_test=True)
    ops = 4 * Bp * H * S * S * D
    # the predictor's fp32 program, and enable_bf16()'s bf16 q, k, v
    for dtype, mode, path in ((f32, "fp32", "mha_predictor"),
                              (torch.bfloat16, "bf16", "mha_predictor_bf16")):
        name = str(dtype)[6:]
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        mask = bias[:, None, None, :].to(dtype)
        got = fa.fused_attention(q, k, v, bias, **pkw)
        e_p = compare(got, fa.reference(q, k, v, bias, **pkw), "attention",
                      dtype, f"mha fwd predictor B={Bp} S={S} test mode "
                      f"{name}")
        t_k = cuda_ms(lambda: fa.fused_attention(q, k, v, bias, **pkw))
        t_p = cuda_ms(lambda: fa.reference(q, k, v, bias, **pkw), iters=5,
                      reps=3)
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=0.125))
        b, c = fwd_bound(4 * Bp * H * S * D * q.element_size()
                         + bias.numel() * 4, ops, dtype)
        print(f"#5 fwd {name}, predictor bucket {Bp}, test mode: kernel "
              f"{t_k:.4f} ms ({ops / t_k / 1e9:.1f} TFLOP/s of products), "
              f"plain {t_p:.4f} ms, sdpa {name} {t_l:.4f} ms "
              f"({t_k / t_l:.2f}x), bound {b[0]:.4f} ms ({b[1]}, tensor "
              f"cores) / {c[0]:.4f} ms (fp32 CUDA cores)")
        rows.append(row("fused_mha_fwd", path, "flash_attention.cu",
                        "paddle_tpu/kernels/flash_attention.py:165",
                        pred_n[mode]["mha_fwd"], e_p, t_k, t_p, b, t_l))
        del q, k, v, mask, got
    return rows


# ---------------------------------------------------------------------------
# sequence parallelism: #12-#14, the ring schedule, routed attention, the
# SP training path
# ---------------------------------------------------------------------------

# the SP path: __graft_entry__.py's sp_ring leg at GPT-small's attention
# width and bench.py's longest GPT context (gpt_s8192, B=1)
SP_B, SP_H, SP_S, SP_D = 1, 12, 8192, 64
SP_SMALL_S = 1024  # reduced depth: card vs CPU
SP_LR = 0.1
# (row0, col0) of the ring-block parity cases: the diagonal shard; key
# shards wholly before and wholly after the query shard (every row
# masked); straddling ones with wholly masked rows; tile-aligned offsets
RING_OFFSETS = ((0, 0), (512, 0), (0, 512), (40, 100), (100, 40), (64, 64),
                (1024, 960))
# the in-process ring schedule: n shards of S_local rows
RING_N, RING_S_LOCAL = 4, 512
# ring schedule against dense attention, fp32, different algorithms: out
# 2e-5 and gradients 2e-4 (the JAX package's own bounds,
# tests/test_longcontext.py)
RING_TOL = (2e-5, 2e-4)


def ring_inputs(B, H, Sq, Sk, D, dtype, seed):
    """q [B, H, Sq, D] and k, v [B, H, Sk, D] as strided head-split views
    of packed projections, and dO."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    kv = torch.randn(B, Sk, 2, H, D, generator=g, device="cuda").to(dtype)
    do = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dtype)
    return (q.transpose(1, 2), kv[:, :, 0].transpose(1, 2),
            kv[:, :, 1].transpose(1, 2), do)


def misaligned_views(layout, B, H, Sq, Sk, D, dtype, seed):
    """q, k, v and dO as ring_inputs gives them, as views whose rows the
    backward cannot copy 16 bytes at a time (its synchronous copy path):
    the base one element off a 16-byte boundary ("base off by one"), or
    rows an odd number of elements apart ("odd row stride")."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def views(S, parts):
        row = parts * H * D + (layout == "odd row stride")
        buf = torch.randn(1 + B * S * row, generator=g,
                          device="cuda").to(dtype)
        base = 1 if layout == "base off by one" else 0
        return [buf.as_strided((B, H, S, D), (S * row, D, row, 1),
                               base + i * H * D) for i in range(parts)]

    (q,), (k, v), (do,) = views(Sq, 1), views(Sk, 2), views(Sq, 1)
    return q, k, v, do


# the kernels on the tensor cores, every attention kernel of the port:
# (library, kernels, the library's occupancy entry: a backward pair's
# takes which = 0 (dq) or 1 (dkv) before the dtype code, a forward's the
# dtype code alone)
MMA_KERNELS = (
    ("flash_attention", ("attn_bwd_dq_kernel", "attn_bwd_dkv_kernel"),
     "flash_attention_bwd_occupancy"),
    ("flash_attention", ("attn_fwd_kernel",),
     "flash_attention_fwd_occupancy"),
    ("flash_tiled", ("tiled_fwd_kernel",), "flash_tiled_fwd_occupancy"),
    ("flash_tiled", ("tiled_dq_kernel", "tiled_dkv_kernel"),
     "flash_tiled_bwd_occupancy"),
    ("ring_block", ("ring_dq_kernel", "ring_dkv_kernel"),
     "ring_block_bwd_occupancy"),
    ("ring_block", ("ring_fwd_kernel",), "ring_block_fwd_occupancy"),
)


def sass_hmma(lib_name, kernels):
    """{"kernel<dtype, D>": HMMA (tensor-core) instructions} of each
    instance of the named kernels in the SASS of a kernel library
    (cuobjdump -sass)."""
    from paddle_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.lib_path(lib_name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    pattern = re.compile(rf"({'|'.join(kernels)})I(\w+?)Li(\d+)E")
    hmma, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = pattern.search(line)
            name = None
            if m:
                dtype = "bf16" if "bfloat16" in m.group(2) else "f32"
                name = f"{m.group(1)}<{dtype}, {m.group(3)}>"
                hmma[name] = 0
        elif name and "HMMA" in line:
            hmma[name] += 1
    return hmma


def tensor_cores():
    """The attention kernels as built, every one on the tensor cores: the
    backward pairs #3/#6 (attn_bwd_dq/dkv_kernel), #9/#8
    (tiled_dq/dkv_kernel) and #13/#14 (ring_dq/dkv_kernel) and the
    forwards #1/#5 (attn_fwd_kernel), #7 (tiled_fwd_kernel) and #12
    (ring_fwd_kernel): each instance's HMMA (tensor-core) instructions in
    its library's SASS (none may lack them, and each kernel has its six
    instances, fp32 and bf16 at D = 32, 64, 128), and from the CUDA
    runtime the blocks of each that fit on one SM with its dynamic shared
    memory. Then the residual backward #4 (ln_bwd_kernel) at N = 768 and
    1024, fp32 and bf16, on its vector path: its blocks an SM and shared
    memory."""
    from paddle_tpu_torch.kernels import _build

    print("== kernels on the tensor cores as built: tensor-core "
          "instructions, blocks an SM")
    for lib_name, kernels, entry in MMA_KERNELS:
        hmma = sass_hmma(lib_name, kernels)
        occupancy = getattr(_build.load(lib_name), entry)
        pair = len(kernels) == 2
        occupancy.argtypes = [ctypes.c_int] * (3 if pair else 2) + [
            ctypes.POINTER(ctypes.c_int)] * 2
        occupancy.restype = ctypes.c_int
        for which, kernel in enumerate(kernels):
            for code, dtype in enumerate(("f32", "bf16")):
                for D in (32, 64, 128):
                    name = f"{kernel}<{dtype}, {D}>"
                    blocks, smem = ctypes.c_int(), ctypes.c_int()
                    head = (which, code) if pair else (code,)
                    err = occupancy(*head, D, ctypes.byref(blocks),
                                    ctypes.byref(smem))
                    check(err == 0, f"{name}: occupancy query failed ({err})")
                    n_hmma = hmma.get(name, 0)
                    print(f"  {name}: {n_hmma} HMMA, {blocks.value} blocks "
                          f"an SM, {smem.value} bytes of shared memory")
                    check(n_hmma > 0 and blocks.value > 0,
                          f"{name}: no tensor-core instruction in its SASS "
                          "or no block fits on an SM")
        check(len(hmma) == 6 * len(kernels),
              f"{lib_name}: {len(hmma)} instances of {kernels}, not "
              f"{6 * len(kernels)}: {sorted(hmma)}")
    lib = _build.load("fused_dropout_add_ln")
    occupancy = lib.fused_dropout_add_ln_bwd_occupancy
    occupancy.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    occupancy.restype = ctypes.c_int
    for code, dtype in enumerate(("f32", "bf16")):
        for N in (768, 1024):
            blocks, smem = ctypes.c_int(), ctypes.c_int()
            err = occupancy(code, N, 1, ctypes.byref(blocks),
                            ctypes.byref(smem))
            check(err == 0 and blocks.value > 0,
                  f"ln_bwd_kernel<{dtype}> N={N}: occupancy query failed "
                  f"({err}) or no block fits on an SM")
            print(f"  ln_bwd_kernel<{dtype}> N={N} (CUDA cores): "
                  f"{blocks.value} blocks an SM, {smem.value} bytes of "
                  "shared memory")


def ring_parity(rb):
    """#12-#14 against their plain versions on the card at runtime causal
    offsets, causal and not, fp32 and bf16 inputs (fp32 outputs on both
    sides: fp32 tolerances), Sq != Sk and neither a multiple of the tile;
    rows that see no key give o = 0 and lse = -1e30 exactly; the backward
    adds into accumulators that already hold values, and takes views
    whose rows are not 16-byte aligned (misaligned_views), one launch of
    each kernel a case."""
    print("== parity, ring blocks: #12-#14 vs plain version on the card, "
          f"offsets {list(RING_OFFSETS)}")
    worst = dict(o=0.0, lse=0.0, dq=0.0, dk=0.0, dv=0.0)
    masked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for D in (32, 64, 128):
            for causal in (False, True):
                q, k, v, do = ring_inputs(2, 3, 200, 130, D, dtype, D)
                g = torch.Generator(device="cuda").manual_seed(1)
                acc = [torch.randn(t.shape, generator=g, device="cuda")
                       for t in (q, k, v)]
                for row0, col0 in RING_OFFSETS:
                    args = (row0, col0, causal, 1 / math.sqrt(D))
                    o, lse = rb.ring_block_fwd(q, k, v, *args)
                    o_p, lse_p = rb.shard_fwd_ref(q, k, v, *args)
                    torch.cuda.synchronize()
                    check(o.dtype == lse.dtype == torch.float32,
                          "ring_block_fwd's outputs are not fp32")
                    dead = lse_p == rb.NEG_INF
                    check(torch.equal(lse[dead], lse_p[dead])
                          and not o[dead].any(),
                          "a row that sees no key is not o=0, lse=-1e30")
                    masked += int(dead.sum())
                    tag = f"{str(dtype)[6:]} D={D} causal={causal} " \
                          f"offsets ({row0}, {col0})"
                    worst["o"] = max(worst["o"], quiet_compare(
                        o, o_p, "attention", tag + " o"))
                    worst["lse"] = max(worst["lse"], quiet_compare(
                        lse, lse_p, "lse", tag + " lse"))
                    glse = torch.where(dead, torch.zeros_like(lse), lse)
                    delta = (do.float() * o).sum(-1)
                    got = rb.ring_block_bwd(q, k, v, do, glse, delta, *args,
                                            *[a.clone() for a in acc])
                    want = rb.add_shard_bwd_ref(q, k, v, do, glse, delta,
                                                *args,
                                                *[a.clone() for a in acc])
                    for n, a, w in zip(("dq", "dk", "dv"), got, want):
                        worst[n] = max(worst[n], quiet_compare(
                            a, w, "attention_bwd", f"{tag} {n}"))
    # the backward's synchronous copy path: views whose rows are not
    # 16-byte aligned; one launch of each kernel a case
    n_mis = 0
    for dtype in (torch.float32, torch.bfloat16):
        for layout in ("base off by one", "odd row stride"):
            q, k, v, do = misaligned_views(layout, 2, 3, 200, 130, 64, dtype,
                                           11)
            g = torch.Generator(device="cuda").manual_seed(2)
            acc = [torch.randn(t.shape, generator=g, device="cuda")
                   for t in (q, k, v)]
            for row0, col0 in ((40, 100), (0, 0)):
                args = (row0, col0, True, 1 / 8)
                o_p, lse_p = rb.shard_fwd_ref(q, k, v, *args)
                glse = torch.where(lse_p == rb.NEG_INF,
                                   torch.zeros_like(lse_p), lse_p)
                delta = (do.float() * o_p).sum(-1)
                before = (rb.ring_block_bwd.launches_dq,
                          rb.ring_block_bwd.launches_dkv)
                got = rb.ring_block_bwd(q, k, v, do, glse, delta, *args,
                                        *[a.clone() for a in acc])
                check((rb.ring_block_bwd.launches_dq,
                       rb.ring_block_bwd.launches_dkv)
                      == (before[0] + 1, before[1] + 1),
                      f"misaligned views ({layout}): not one launch each")
                want = rb.add_shard_bwd_ref(q, k, v, do, glse, delta, *args,
                                            *[a.clone() for a in acc])
                tag = f"{str(dtype)[6:]} {layout} offsets ({row0}, {col0})"
                for n, a, w in zip(("dq", "dk", "dv"), got, want):
                    worst[n] = max(worst[n], quiet_compare(
                        a, w, "attention_bwd", f"{tag} {n}"))
                n_mis += 1
    print(f"ring blocks: {len(RING_OFFSETS) * 12} cases and {n_mis} of the "
          f"backward on misaligned views, {masked} rows that "
          "see no key; max_abs_err " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items())
          + f" (atol {TOL['attention'][torch.float32][0]:g} fwd, "
          f"{TOL['lse'][torch.float32][0]:g} lse, "
          f"{TOL['attention_bwd'][torch.float32][0]:g} bwd)")
    return worst


def quiet_compare(got, want, kernel, what):
    """compare() of fp32 outputs without its line: the max abs error,
    failing beyond the kernel's fp32 tolerance."""
    got, want = got.float(), want.float()
    atol, rtol = TOL[kernel][torch.float32]
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= atol + rtol * want.abs()).all())
    check(ok, f"{what}: the kernel disagrees with its plain version "
          f"(max_abs_err {diff.max().item():.3e})")
    return diff.max().item()


def drive_lockstep(gens):
    """Run the ring generators of n ranks in one process: each ("post",
    tensors) is kept for the left neighbour and answered with its
    sequence number; each ("wait", i) gets copies of the right
    neighbour's post i once it exists, as GroupExchange receives them.
    Returns each rank's result."""
    n = len(gens)
    posts = [[] for _ in range(n)]
    reqs = [next(g) for g in gens]
    results, done = [None] * n, [False] * n
    while not all(done):
        progressed = False
        for r, g in enumerate(gens):
            if done[r]:
                continue
            kind, arg = reqs[r]
            if kind == "post":
                posts[r].append(tuple(arg))
                answer = len(posts[r]) - 1
            else:
                src = posts[(r + 1) % n]
                if arg >= len(src):
                    continue  # the right neighbour has not posted it yet
                answer = [t.clone() for t in src[arg]]
            progressed = True
            try:
                reqs[r] = g.send(answer)
            except StopIteration as stop:
                results[r], done[r] = stop.value, True
        check(progressed, "the ring schedule deadlocked")
    return results


def ring_schedule(rb, kc):
    """The port's ring forward and backward (parallel/ring_attention.py
    ring_fwd_steps / ring_bwd_steps) for RING_N shards of one sequence in
    one process, over drive_lockstep's exchange: the merged output and
    dq, dk, dv against dense causal attention and its autograd gradients
    (fp32), and each kernel launched once per live shard, 1 + 2 + ... + n
    under the causal mask (n(n+1)/2), the global offsets of every pair
    nonzero but the diagonal's."""
    from paddle_tpu_torch.parallel import ring_attention as ra

    n, sl = RING_N, RING_S_LOCAL
    B, H, D = 1, SP_H, SP_D
    print(f"== ring schedule: n={n} shards of {sl} rows in one process "
          f"(B={B}, H={H}, S={n * sl}, D={D}, causal, fp32) vs dense")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn(B, H, n * sl, D, generator=g, device="cuda")
                   for _ in range(4))
    scale = 1 / math.sqrt(D)
    shards = [t.split(sl, dim=2) for t in (q, k, v, do)]
    reset_counts(kc)
    fwd = drive_lockstep([ra.ring_fwd_steps(shards[0][i], shards[1][i],
                                            shards[2][i], i, n, True, scale)
                          for i in range(n)])
    out = torch.cat([o for o, _ in fwd], 2)
    bwd = drive_lockstep([ra.ring_bwd_steps(
        shards[0][i], shards[1][i], shards[2][i], shards[3][i], fwd[i][0],
        fwd[i][1], i, n, True, scale) for i in range(n)])
    counts = read_counts(kc)
    live = n * (n + 1) // 2
    want = dict.fromkeys(kc, 0)
    want.update(ring_fwd=live, ring_bwd_dq=live, ring_bwd_dkv=live)
    check(counts == want, f"ring schedule launched {counts}, want {want}")
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    dense = ra._attention_fallback(qg, kg, vg, True, scale)
    grads = torch.autograd.grad(dense, (qg, kg, vg), do)
    errs = [(out - dense).abs().max().item()]
    errs += [(torch.cat([b[j] for b in bwd], 2) - gr).abs().max().item()
             for j, gr in enumerate(grads)]
    print(f"launches {counts['ring_fwd']} / {counts['ring_bwd_dq']} / "
          f"{counts['ring_bwd_dkv']} (#12 / #13 / #14; {live} live shards); "
          f"max_abs_err vs dense: out {errs[0]:.3e}, dq {errs[1]:.3e}, "
          f"dk {errs[2]:.3e}, dv {errs[3]:.3e} (atol {RING_TOL[0]:g}, "
          f"{RING_TOL[1]:g})")
    check(errs[0] <= RING_TOL[0] and max(errs[1:]) <= RING_TOL[1],
          "the ring schedule disagrees with dense attention")
    return errs


def routed_attention(fa, ft, kc):
    """The shapes the 4-D and packed attention take only routed: past
    S=1024 #7-#9 on the 4-D views (#7 twice: the 4-D backward runs the
    forward again for its lse), D=48 #5/#6 or #7-#9 on heads zero-padded
    to 64, in fp32 and bf16; fp16 the plain version and no kernel of ours.
    Each in test mode and with training dropout (the seed words
    MASK_SEED), causal with the key bias: forward and backward (dbias
    through sum_partials) against the plain versions. The tiled plain
    backward takes the kernel's output, as the kernels' backward does (in
    bf16 a plain output one rounding apart moves rowsum(dO * out), and a
    few gradients by one bf16 step past rtol 2^-7; tiled_parity holds
    #8/#9 the same way). Then the cost of what the routes add: the
    zero-padding copies, and the extra #7 of a 4-D backward past S=1024."""
    print("== routed attention: S=1152 and 2048 (#7-#9 on 4-D views), D=48 "
          "(#5/#6 or #7-#9 on heads zero-padded to 64), fp32 and bf16, "
          "fp16 (plain) on the card; test mode and training dropout")
    f32, bf16 = torch.float32, torch.bfloat16
    tiled = dict(tiled_fwd=2, tiled_bwd_dq=1, tiled_bwd_dkv=1,
                 sum_partials=1)
    whole = dict(mha_fwd=1, mha_bwd_dq=1, mha_bwd_dkv=1, sum_partials=1)
    cases = (
        ("S=1152 D=64 fp32", 1152, 64, f32, tiled),
        ("S=1152 D=64 bf16", 1152, 64, bf16, tiled),
        ("S=200 D=48 fp32", 200, 48, f32, whole),
        ("S=200 D=48 bf16", 200, 48, bf16, whole),
        ("S=2048 D=48 fp32", 2048, 48, f32, tiled),
        ("S=2048 D=48 bf16", 2048, 48, bf16, tiled),
        ("S=256 D=64 fp16", 256, 64, torch.float16, {}),
    )
    errs = {}
    for name, S, D, dtype, launches in cases:
        B, H = 2, 3
        g = torch.Generator(device="cuda").manual_seed(S + D)
        q, k, v, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                       .to(dtype) for _ in range(4))
        bias = torch.zeros(B, S, device="cuda")
        bias[1, S - S // 5:] = -1e4
        for training in (False, True):
            tag = f"{name} {'training' if training else 'test mode'}"
            seed = MASK_SEED if training else None
            kw = dict(scale=1 / math.sqrt(D), causal=True,
                      dropout_rate=TRAIN_RATE, is_test=not training,
                      seed=seed)
            reset_counts(kc)
            out = fa.fused_attention(q, k, v, bias, **kw)
            grads = fa.attention_grads(q, k, v, bias, do, **kw)
            counts = read_counts(kc)
            want = dict.fromkeys(kc, 0)
            want.update(launches)
            check(counts == want, f"{tag}: launched {counts}, want {want}")
            if launches is tiled:  # the tiled plain versions (#7-#9's)
                tkw = dict(scale=kw["scale"], rate=TRAIN_RATE,
                           is_test=not training, causal=True)
                ref, lse = ft.reference_fwd4(q, k, v, bias, seed, **tkw)
                gref = ft.reference_bwd4(q, k, v, bias, seed, do, out, lse,
                                         **tkw)
            else:
                ref = fa.reference(q, k, v, bias, **kw)
                gref = fa.reference_bwd(q, k, v, bias, do, **kw)
            # fp16: the plain version on both sides (bf16's tolerance
            # bounds it, a fortiori)
            tol = dtype if dtype != torch.float16 else bf16
            e = [compare(out, ref, "attention", tol, f"{tag} out")]
            e += [compare(a, w, "attention_bwd", tol, f"{tag} {n}")
                  for n, a, w in zip(("dq", "dk", "dv"), grads, gref)]
            compare(grads[3], gref[3], "attention_bwd", f32, f"{tag} dbias")
            errs[tag] = max(e)
            if launches is tiled and dtype == bf16:
                # what the plain backward gives from the plain output
                # instead: a measurement, not a check
                own = ft.reference_bwd4(q, k, v, bias, seed, do, ref, lse,
                                        **tkw)
                atol, rtol = TOL["attention_bwd"][bf16]
                over = sum(int(((a.float() - w.float()).abs() >
                                atol + rtol * w.float().abs()).sum())
                           for a, w in zip(grads[:3], own[:3]))
                print(f"{tag}: kernel and plain outputs differ in "
                      f"{int((out != ref).sum())} of {out.numel()} elements; "
                      f"the plain backward from the plain output puts "
                      f"{over} of {3 * q.numel()} gradient elements past "
                      f"the tolerance")
    # the cost of zero-padding: D=48 padded to 64 against D=64 at the
    # ERNIE-layout path's B=32, S=512, H=12 (the kernels do the same work)
    t = {}
    for D in (48, 64):
        q, k, v = (torch.randn(32, 12, 512, D, device="cuda")
                   for _ in range(3))
        t[D] = cuda_ms(lambda: fa.fused_attention(q, k, v), iters=10, reps=5)
    print(f"zero-padded heads: #5 at D=48 (padded to 64) {t[48]:.3f} ms "
          f"against D=64 {t[64]:.3f} ms at B=32, S=512, H=12 fp32: the three "
          f"pads cost {t[48] - t[64]:.3f} ms (the output is a view)")
    # the 4-D op saves no lse, so its backward past S=1024 runs #7 again:
    # at GPT's [4, 12, 2048, 64] causal fp32, the backward against #7
    q, k, v, do = (torch.randn(GPT_B, 12, GPT_S, 64, device="cuda")
                   for _ in range(4))
    t_fwd = cuda_ms(lambda: fa.fused_attention(q, k, v, causal=True),
                    iters=5, reps=5)
    t_bwd = cuda_ms(lambda: fa.attention_grads(q, k, v, None, do,
                                               causal=True, want_dbias=False),
                    iters=5, reps=5)
    print(f"4-D backward at [{GPT_B}, 12, {GPT_S}, 64] causal fp32: "
          f"{t_bwd:.3f} ms, of which the extra #7 (the forward again, for "
          f"the lse) {t_fwd:.3f} ms ({100 * t_fwd / t_bwd:.1f}%)")
    return errs


def build_sp_leg(fluid, layers, shape, op):
    """__graft_entry__.py's build_sp_leg through the builder the CPU tests
    share (tests/torch_sp_worker.py, which imports neither jax nor
    paddle_tpu): fc projections of x [B, H, S, D] into q, k and v, causal
    ring or Ulysses attention over "sp", the global loss reduce_sum(square)
    -> mp_allreduce_sum over sp -> scale by the global element count,
    SGD(SP_LR), c_allreduce_sum over sp on every gradient."""
    from paddle_tpu_torch.parallel import insert_grad_allreduce

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_sp_worker import build_sp_leg as build

    return build(fluid, layers, fluid.unique_name, insert_grad_allreduce,
                 shape, op, SP_LR)


def sp_feed(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def sp_small_run(fluid, layers, place, op, state):
    """Two SGD steps of the reduced-depth SP program (S=SP_SMALL_S) on a
    1-rank "sp" mesh of `place` from `state`: per step the loss and every
    gradient, and the state after."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.parallel import make_mesh, shard_program

    shape = (SP_B, SP_H, SP_SMALL_S, SP_D)
    main, _, loss, pg = build_sp_leg(fluid, layers, shape, op)
    scope = fluid.Scope()
    convert.state_from_numpy(state, scope, place, program=main)
    mesh = make_mesh({"sp": 1}, place=place)
    try:
        shard_program(main, mesh, {"x": (None, None, "sp")})
        exe = fluid.Executor(place)
        steps = [exe.run(main, feed={"x": sp_feed(shape, i)},
                         fetch_list=[loss] + [g for _, g in pg], scope=scope)
                 for i in range(2)]
    finally:
        mesh.close()
    return steps, convert.state_to_numpy(scope), [p.name for p, _ in pg]


def sp_small(fluid, layers, op):
    """The reduced-depth SP program, two SGD steps on a 1-rank NCCL mesh
    on the card and a 1-rank gloo mesh on the CPU from one state, under
    phase 5's tolerances: loss, every gradient, each parameter's update."""
    from paddle_tpu_torch import convert

    print(f"== SP training, reduced depth: {op} at S={SP_SMALL_S} (B={SP_B}, "
          f"H={SP_H}, D={SP_D}), card (NCCL) vs CPU (gloo), 2 SGD steps")
    shape = (SP_B, SP_H, SP_SMALL_S, SP_D)
    _, startup, _, _ = build_sp_leg(fluid, layers, shape, op)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    start = convert.state_to_numpy(scope)
    card, gend, names = sp_small_run(fluid, layers, fluid.CUDAPlace(0), op,
                                     start)
    cpu, cend, _ = sp_small_run(fluid, layers, fluid.CPUPlace(), op, start)
    tol = FP32_TOL
    worst = dict(loss=0.0, grad=0.0)
    grads = {n: [] for n in names}
    for step, (g, c) in enumerate(zip(card, cpu)):
        check(np.isfinite(g[0]).all(), f"card loss not finite: {g[0]}")
        rel = float(np.abs(g[0] - c[0]).max() / np.abs(c[0]).max())
        worst["loss"] = max(worst["loss"], rel)
        check(rel <= tol["loss"], f"step {step}: loss {g[0]} vs CPU {c[0]}")
        for n, gv, cv in zip(names, g[1:], c[1:]):
            grads[n].append((gv, cv))
            err, ok = _held(gv, cv, tol["grad"])
            worst["grad"] = max(worst["grad"], err)
            check(ok, f"step {step}: {n}@GRAD differs by {err:.3e}")
    worst_u, exempt, total = check_updates(start, gend, cend, grads, SP_LR,
                                           *tol["update"])
    moved = sum(not np.array_equal(start[n], cend[n]) for n in names)
    check(moved == len(names), f"only {moved} of {len(names)} weights moved")
    print(f"max error vs CPU: loss {worst['loss']:.2e} relative, @GRAD "
          f"{worst['grad']:.2e}, updates {worst_u:.2e} of (|update| + lr) "
          f"({exempt} of {total} exempt); every weight moved")
    return worst


def sp_path(fluid, layers, kc):
    """build_sp_leg's program at x [1, 12, 8192, 64] fp32 (GPT-small's
    attention width at bench.py's gpt_s8192 context) on a 1-rank NCCL "sp"
    mesh, ring and Ulysses: 3 warm-up and 5 timed SGD steps, one profiled,
    one timed by op type; every loss finite, every weight moved by the
    first step; each step launches #12 twice (forward, and the grad op's
    forward again), #13 and #14 once, and no other kernel of ours; the
    mp_allreduce_sum and c_allreduce_sum ops through NCCL. Then the
    reduced-depth program card vs CPU. Returns {op: launch counts}."""
    from paddle_tpu_torch.parallel import make_mesh, shard_program

    shape = (SP_B, SP_H, SP_S, SP_D)
    out = {}
    mesh = make_mesh({"sp": 1})  # the default place: the card, NCCL
    try:
        for op in ("ring_attention", "ulysses_attention"):
            print(f"== SP training path: build_sp_leg with {op} at x "
                  f"{list(shape)} fp32, 1-rank NCCL sp mesh, SGD({SP_LR})")
            main, startup, loss, pg = build_sp_leg(fluid, layers, shape, op)
            shard_program(main, mesh, {"x": (None, None, "sp")})
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            exe.run(startup, scope=scope)
            names = [p.name for p, _ in pg]
            snap = {n: scope.find_var(n).clone() for n in names}
            batches = [{"x": torch.from_numpy(sp_feed(shape, i)).cuda()}
                       for i in range(2)]
            expect = dict.fromkeys(kc, 0)
            expect.update(ring_fwd=2, ring_bwd_dq=1, ring_bwd_dkv=1)

            def after(i, values, scope=scope, snap=snap, names=names):
                if i == 0:
                    moved = [n for n in names
                             if not torch.equal(scope.find_var(n), snap[n])]
                    check(len(moved) == len(names),
                          f"step 0 moved only {moved}")

            _, stats = run_steps(exe, main, scope, batches, [loss],
                                 ("loss",), kc, expect, SP_B * SP_S, after)
            out[op] = read_counts(kc)
            stats["ops"] = len(main.global_block.ops)
            print(f"{op} training: " + json.dumps(stats))
            del exe, scope, batches, snap
            torch.cuda.empty_cache()
    finally:
        mesh.close()
    for op in ("ring_attention", "ulysses_attention"):
        sp_small(fluid, layers, op)
    return out


def ring_kernel_times(rb, sp_n):
    """#12, #13 and #14 at the SP path's shape: B=1, H=12, S=8192, D=64,
    fp32, causal, offsets (0, 0). Bounds: each input read once and each
    output written once (the accumulators read and written) over 3.35
    TB/s, and 4*D operations a live pair for each kernel (the forward's
    q k^T and p v; the backward's 8*D split between the two) over 67
    TFLOP/s fp32 on the CUDA cores; all three run those operations on the
    tensor cores as three TF32 products each (3xTF32), so their rows
    carry the bound of that arithmetic, 3 * 4*D a pair over 495 TFLOP/s
    TF32, and the fp32 one is printed beside it. Achieved TFLOP/s: the
    products each kernel does (#12: S, P V; #13: S, dP, dQ; #14: S, dP,
    dV, dK), 2*D operations a live pair each, over its time. #13 and #14
    timed apart
    by CUDA events around each launch (launch_ms), and two launches of
    the pair on the same inputs must give the same bits; head 0 of both
    sides is measured against fp64. Library:
    scaled_dot_product_attention, causal, on the same tensors (its
    backward through autograd for #13 and #14)."""
    import torch.nn.functional as F

    B, H, S, D = SP_B, SP_H, SP_S, SP_D
    print(f"== kernel times, ring blocks (B={B}, H={H}, S={S}, D={D}, fp32, "
          "causal, offsets (0, 0))")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                   for _ in range(4))
    scale, es = 1 / math.sqrt(D), 4
    pairs = B * H * live_pairs(S, True)
    head = B * H * S * D * es
    stats = B * H * S * 4
    o, lse = rb.ring_block_fwd(q, k, v, 0, 0, True, scale)
    o_p, lse_p = rb.shard_fwd_ref(q, k, v, 0, 0, True, scale)
    err_f = max(compare(o, o_p, "attention", torch.float32, "#12 o"),
                compare(lse, lse_p, "lse", torch.float32, "#12 lse"))
    delta = (do * o).sum(-1)
    zeros = [torch.zeros(B, H, S, D, device="cuda") for _ in range(3)]
    dq, dk, dv = rb.ring_block_bwd(q, k, v, do, lse, delta, 0, 0, True, scale,
                                   *[z.clone() for z in zeros])
    dq_p = rb.shard_dq_ref(q, k, v, do, lse, delta, 0, 0, True, scale)
    dk_p, dv_p = rb.shard_dkv_ref(q, k, v, do, lse, delta, 0, 0, True, scale)
    err_q = compare(dq, dq_p, "attention_bwd", torch.float32, "#13 dq")
    err_kv = max(compare(dk, dk_p, "attention_bwd", torch.float32, "#14 dk"),
                 compare(dv, dv_p, "attention_bwd", torch.float32, "#14 dv"))
    again = rb.ring_block_bwd(q, k, v, do, lse, delta, 0, 0, True, scale,
                              *[z.clone() for z in zeros])
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
          "two launches of #13/#14 on the same inputs differ in their bits")
    print("#13/#14: two launches on the same inputs give the same bits")
    del again
    # head 0 against fp64 (a measurement, not a check): how far the
    # kernels' sums (3xTF32, summed by tiles) and the plain versions'
    # (fp32 GEMMs over up to 8192 rows) each stray
    Q, K, V, DO = (x[0, 0].double() for x in (q, k, v, do))
    vis = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    p = torch.where(vis, torch.exp(Q @ K.T * scale
                                   - lse[0, 0].double()[:, None]), 0.0)
    ds = p * (DO @ V.T - delta[0, 0].double()[:, None])
    ref = (ds @ K * scale, ds.T @ Q * scale, p.T @ DO)
    f64 = {side: ", ".join(f"{n} {(a[0, 0].double() - r).abs().max():.3e}"
                           for n, a, r in zip(("dq", "dk", "dv"), got, ref))
           for side, got in (("kernels", (dq, dk, dv)),
                             ("plain versions", (dq_p, dk_p, dv_p)))}
    print(f"#13/#14 head 0 against fp64: kernels {f64['kernels']}; plain "
          f"versions {f64['plain versions']}")
    del Q, K, V, DO, vis, p, ds, ref

    t12 = cuda_ms(lambda: rb.ring_block_fwd(q, k, v, 0, 0, True, scale),
                  iters=10, reps=5)
    p12 = cuda_ms(lambda: rb.shard_fwd_ref(q, k, v, 0, 0, True, scale),
                  iters=2, reps=3)
    l12 = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), iters=10, reps=5)
    s12, b12 = fwd_bound(4 * head + stats, 4 * D * pairs, torch.float32)
    t = launch_ms(lambda: rb.ring_block_bwd(q, k, v, do, lse, delta, 0, 0,
                                            True, scale, *zeros),
                  (("ring_block", "ring_block_bwd_dq"),
                   ("ring_block", "ring_block_bwd_dkv")), iters=5, reps=3)
    p13 = cuda_ms(lambda: rb.shard_dq_ref(q, k, v, do, lse, delta, 0, 0,
                                          True, scale), iters=2, reps=3)
    p14 = cuda_ms(lambda: rb.shard_dkv_ref(q, k, v, do, lse, delta, 0, 0,
                                           True, scale), iters=2, reps=3)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    sd = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                        scale=scale)
    l_bwd = cuda_ms(lambda: torch.autograd.grad(sd, (qg, kg, vg), do,
                                                retain_graph=True),
                    iters=10, reps=5)
    # dq: q, k, v, dO, lse, delta read, dq read and written; dk, dv: the
    # same inputs, dk and dv read and written
    b13 = bound(6 * head + 2 * stats, 4 * D * pairs, torch.float32)
    b14 = bound(8 * head + 2 * stats, 4 * D * pairs, torch.float32)
    # each kernel's 4*D a pair as 3xTF32: six TF32 products of 2*D a pair
    s13 = bound(6 * head + 2 * stats, 3 * 4 * D * pairs, "tf32")
    s14 = bound(8 * head + 2 * stats, 3 * 4 * D * pairs, "tf32")
    t13, t14 = t["ring_block_bwd_dq"], t["ring_block_bwd_dkv"]
    tf13 = 3 * 2 * D * pairs / t13 / 1e9
    tf14 = 4 * 2 * D * pairs / t14 / 1e9
    print(f"#12 fwd: kernel {t12:.3f} ms ({4 * D * pairs / t12 / 1e9:.1f} "
          f"TFLOP/s of fp32 products), plain {p12:.3f} ms, sdpa causal "
          f"{l12:.3f} ms ({t12 / l12:.2f}x), bound {s12[0]:.3f} ms "
          f"({s12[1]}, 3xTF32 tensor cores) / {b12[0]:.3f} ms (fp32 CUDA "
          "cores)")
    print(f"#13 dq: kernel {t13:.3f} ms ({tf13:.1f} TFLOP/s of fp32 "
          f"products), plain {p13:.3f} ms, bound {b13[0]:.3f} ms "
          f"({b13[1]}, fp32 CUDA cores) / {s13[0]:.3f} ms (3xTF32 tensor "
          f"cores); #14 dkv: kernel {t14:.3f} ms ({tf14:.1f} TFLOP/s), plain "
          f"{p14:.3f} ms, bound {b14[0]:.3f} ms / {s14[0]:.3f} ms; the pair "
          f"{t13 + t14:.3f} ms; sdpa causal backward {l_bwd:.3f} ms")
    rows = []
    for path, op in (("sp_training", "ring_attention"),
                     ("ulysses_training", "ulysses_attention")):
        n = sp_n[op]
        rows.append(row("ring_fwd", path, "ring_block.cu",
                        "paddle_tpu/kernels/ring_block.py:85",
                        n["ring_fwd"], err_f, t12, p12, s12, l12))
        rows.append(row("ring_dq", path, "ring_block.cu",
                        "paddle_tpu/kernels/ring_block.py:199",
                        n["ring_bwd_dq"], err_q, t13, p13, s13, l_bwd))
        rows.append(row("ring_dkv", path, "ring_block.cu",
                        "paddle_tpu/kernels/ring_block.py:234",
                        n["ring_bwd_dkv"], err_kv, t14, p14, s14, l_bwd))
    del q, k, v, do, o, o_p, qg, kg, vg, sd, zeros
    torch.cuda.empty_cache()
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_tiled as ft
    from paddle_tpu_torch.kernels import fused_residual as fr
    from paddle_tpu_torch.kernels import layer_norm as lnk
    from paddle_tpu_torch.kernels import prng_mask as pm
    from paddle_tpu_torch.kernels import ring_block as rb
    from paddle_tpu_torch.kernels import sum_partials as sp

    gpu = gpu_line()
    print(f"== device: {gpu}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== build")
    t0 = time.perf_counter()
    report = _build.build()
    print(f"built {sorted(report)} in {time.perf_counter() - t0:.1f}s")
    for name, (secs, ptxas) in sorted(report.items()):
        for kernel, regs, spill in ptxas_usage(ptxas):
            print(f"  {name}: {kernel} {regs} registers, {spill}")

    kc = counters(fa, fr, sp, ft, lnk, rb)
    main_err = parity(fa, fr)
    train_err = train_parity(fa, fr, pm)
    tiled_err = tiled_parity(ft)
    ln_err = ln_parity(lnk)
    mha_err = mha_parity(fa)
    tensor_cores()
    ring_parity(rb)
    ring_schedule(rb, kc)
    routed_attention(fa, ft, kc)
    frozen, exe, scope, samples, serve_n = main_path(fluid, layers, kc)
    serve_times(frozen, exe, scope, samples)
    del frozen, exe, scope
    torch.cuda.empty_cache()
    train_small(fluid, layers)
    train_n = train_full(fluid, layers, kc)
    gpt_train_small(fluid)
    gpt_train_n, _ = gpt_train_full(fluid, kc)
    gpt_serve_n = gpt_serving(fluid, kc)
    gpt_train_small(fluid, amp=True)
    amp_n = train_full(fluid, layers, kc, amp=True)
    gpt_amp_n, _ = gpt_train_full(fluid, kc, amp=True)
    gpt_ln_n, _ = gpt_train_full(fluid, kc, amp=True, ln_kernels=True)
    mha_train_small(fluid, layers)
    mha_train_n, mha_pred_n, _ = mha_path(fluid, layers, kc)
    sp_n = sp_path(fluid, layers, kc)
    rows = kernel_times(fa, fr, main_err, serve_n)
    rows += train_kernel_times(fa, fr, sp, train_err, train_n, amp_n)
    rows += gpt_kernel_times(fa, ft, tiled_err, gpt_train_n, gpt_serve_n,
                             gpt_amp_n)
    rows += ln_kernel_times(lnk, ln_err, gpt_ln_n)
    rows += mha_kernel_times(fa, mha_err, mha_train_n, mha_pred_n)
    rows += ring_kernel_times(rb, sp_n)

    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
