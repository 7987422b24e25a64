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
   standalone LayerNorm kernels (#10, #11) at [8192, 768] and R = 1001
   up to N = 8192, fp32 and bf16, scale and bias fp32, bf16 or absent,
   #11's bits on unaligned rows equal to the aligned rows', and over two
   runs; the 4-D kernels (#5, #6) at B=32, S=512 and small
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
   spread of several windows of at least 150 requests);
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
   training in phase 12): 3 warm-up and 2 timed steps, one under
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
   then the GPT long-context section, bench.py's accelerator legs
   gpt_s4096 and gpt_s8192: #7-#9 against their plain versions at
   [2, 12, 4096, 64] and [1, 12, 8192, 64] (causal, fp32 and bf16,
   training dropout and test mode, and a probe that a differing mask bit
   would move by 24 times fp32's tolerance); each leg as bench.py's
   bench_gpt_longctx runs it on an accelerator (GPT-small at full width,
   max_position = S, Adam(1e-4) under `_amp`, B=2 and B=1; 3 warm-up
   steps, the best of 2 rounds of 10): tokens/s, TFLOP/s and MFU from
   Program.estimate's step FLOPs against the card's peak, their
   divergence from bench.py's closed form, the executor's live perf.mfu
   gauge (within 0.02 of the offline MFU), the final loss, the peak
   memory beside the static plan's; each step #7-#9 12 times each and
   no other kernel of ours; a profiled step (the card's busy time by
   kind, its idle share, no cudaStreamSynchronize); then the three
   kernels' times at
   both shapes in bf16 beside their bounds, plain versions and
   scaled_dot_product_attention's bf16 causal forward and backward;
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
   library's SASS, its blocks an SM and shared memory, and the row
   backwards #4's and #11's blocks an SM; the port's ring forward and backward
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
17. ResNet training, reduced size: bench.py's bench_resnet program at its
   CPU size (ResNet-18, 3x32x32, B=4, 10 classes), Momentum(0.1, 0.9),
   fp32, two steps on the card and on the CPU, each from one state (the
   CPU takes the card's state after the first): loss, accuracy, every
   @GRAD, velocity, parameter update and batch-norm moving statistic;
18. ResNet training path: bench_resnet on an accelerator, ResNet-50, B=128,
   3x224x224, 1000 classes, Momentum(0.1, 0.9) under `_amp`: 3 warm-up
   and 5 timed steps, one profiled (card time by kind: cuDNN convolution
   forward, its replay in __vjp__(conv2d), backward; batch norm and
   elementwise; casts; momentum; and by program op), one timed by op
   type; every loss finite, parameters, velocities and moving statistics
   moved by each of the first two steps, no kernel of ours launched;
   step time, images/s, peak memory, the AMP program's ops and casts;
19. ResNet serving path: bench_serving.py's resnet classifier (ResNet-18,
   3x32x32, 10 classes, frozen: every batch_norm in test mode) behind
   serving.Server at buckets (1, 2, 4): every answer against a direct run
   on the card and the port's CPU run, no kernel of ours launched; then
   requests/s, p50 and p99 at each bucket, as phase 4 times BERT;
20. YOLOv3 training, reduced size: bench.py's bench_yolov3 program at its
   CPU size (YoloConfig.tiny(class_num=4), 3x64x64, B=2, 10 boxes),
   Momentum(0.01, 0.9), fp32, four steps on the card and on the CPU, each
   from one state, behind a branch guard (every leaky_relu input on one
   side of 0 in both runs, yolov3_loss's masks equal; else the step again
   on a spare feed): loss, every @GRAD, velocity, parameter update and
   batch-norm moving statistic;
21. YOLOv3 training path: bench_yolov3 on an accelerator,
   YoloConfig(class_num=80, scale=0.5), B=64, 3x224x224, 10 boxes an
   image, Momentum(0.01, 0.9) under `_amp`: 3 warm-up and 5 timed steps,
   one profiled (card time by kind and by program op), one timed by op
   type; every loss finite, parameters, velocities and moving statistics
   moved by each of the first two steps, conv2d on bf16, batch_norm on
   fp32, yolov3_loss on a bf16 X giving an fp32 Loss, no kernel of ours
   launched; then the paper's model, YoloConfig(class_num=80) at
   3x416x416, B=16, the same optimizer under `_amp`: 1 warm-up and 3
   timed steps, one profiled, one timed by op type, losses finite,
   weights moved; step times, images/s, peak memory;
22. YOLOv3 predictor: yolov3_infer at the paper's width (80 classes, all
   three heads, 416x416, fp32, test mode, the moving statistics set to
   one training-mode batch's), io.save_inference_model and
   inference.create_paddle_predictor at batch buckets (1, 2, 4): Out [B,
   100, 6] and NmsRoisNum against a direct run on the card and, at bucket
   1, the port's CPU run (labels and counts equal, scores and boxes
   within tolerance, near-tie rows compared as a set), no kernel of ours
   launched; ms a batch at each bucket;
23. CTR training, reduced size: bench.py's deepfm program at its CPU
   config (DeepFMConfig(1000, 6, 8, (16,), 4)), B=64, Adam(1e-3), fp32,
   three steps on the card and on the CPU from one state, plain and in
   deepfm_fused's per-slot layout fused by embedding.fuse_lookups; then
   the cached segment (EmbeddingEngine, hot_rows = max(B * F, V // 2),
   Prefetcher over 8 feeds) on both: losses, residency equal, host
   stores;
24. CTR training path: bench.py's deepfm leg at DeepFMConfig.criteo(),
   B=4096, Adam(1e-3), fp32: 3 warm-up and 20 timed steps, one profiled
   (card time by kind and by program op), one timed by op type; the
   tables, moments and tower moved, no kernel of ours launched, no
   host-device synchronisation in the step;
25. CTR fused-embedding path: bench.py's deepfm_fused leg, the per-slot
   program unfused and fused in one call (the same figures for each),
   the batches' dedup ratio, the cached and prefetched segment (hot_rows
   500000, 16 feeds: hit rate, prefetch overlap, write-backs) and the
   leg's structural gates (one fused gather per width, dedup active,
   overlap recorded);
26. CTR serving path: bench_serving.py's ctr_rank ranker frozen behind
   serving.Server at buckets (1, 2, 4, 8), max_wait_ms 4: answers
   against a direct run on the card and the port's CPU run within 1e-5,
   no kernel of ours launched; a closed loop of 8 clients; requests/s,
   p50 and p99 at each bucket;
27. Mask R-CNN training, reduced size: bench.py's mask_rcnn program at
   its CPU config (MaskRCNNConfig.tiny(), 3x64x64, B=2, 2 boxes),
   Momentum(0.002, 0.9), fp32, one step on the card and on the CPU from
   one state, then the legacy per-image program at 1 image: the six
   losses, rois_num and labels, every @GRAD, velocity, update and moving
   statistic, behind a near-tie guard (every top-k, NMS, collect, IoU,
   FPN-level and mask-grid decision further from its threshold than the
   two runs could move it);
28. Mask R-CNN training path: bench_mask_rcnn on an accelerator
   (MaskRCNNConfig(81, scale=0.5, rpn_pre_nms=512, rpn_post_nms=128,
   batch_size_per_im=64, depth=50), B=8, 3x256x256, 8 boxes,
   Momentum(0.002, 0.9) under AMP with dynamic loss scaling from 2^12):
   padding waste and the detection.* counters of the first run,
   unroll_proxy's op counts, 3 warm-up and 5 timed steps, one profiled
   (card time by kind and by program op), one timed by op type; the
   loss scale and step counters, weights moved, the detection ops'
   runtime dtypes as declared, no kernel of ours, no host-device
   synchronisation in the step;
29. Mask R-CNN predictor: mask_rcnn_infer at that width, 3x256x256,
   batch 1, fp32, io.save_inference_model and
   inference.create_paddle_predictor: detections and mask logits
   against a direct run on the card and the port's CPU run (labels and
   counts equal, near-tie rows as a set), no kernel of ours; ms a batch;
30. dygraph (the eager mode), reduced depth: the eager BERT classifier
   (build_dygraph_bert: Embedding, LayerNorm, per layer Linear,
   layers.fused_qkv_attention, Linear, a traced fused_dropout_add_ln,
   the gelu FFN and fused_dropout_add_ln again; tanh pooler, 2-way head)
   at BERT-base width, 2 layers, B=2, S=128, no dropout, Adam(1e-3):
   two eager steps on the card (its kernels, through torch autograd) and
   on the CPU (their plain versions) from one state, loss and every
   gradient under phase 5's tolerances, the parameters under its update
   rule, the eval logits; then the full width (BertConfig.base()),
   B=32, S=128, dropout 0.1, Adam under bench_bert's schedule as dygraph
   objects: 2 warm-up and 5 timed steps and one profiled, each launching
   #1 12, #3 12 + 12, #2 24 and #4 24 times; a step with
   FLAGS_paddle_tpu_pallas_layer_norm on (#10/#11 once each, the
   embedding LayerNorm); evaluation under no_grad at B=8 (#1 12, #2 24,
   no backward); save_dygraph / load_dygraph into a fresh net (bit-equal
   parameters and next loss); DataParallel on a 1-rank NCCL group (the
   plain step's gradients);
31. kernel times: each kernel beside its plain version, its bound and one
   PyTorch call, at the serving, the BERT training (#1, the backward
   pair #3, #2 and #4 also in bf16 at the BERT AMP path's activations,
   beside SDPA's and F.layer_norm's bf16) and the GPT shapes (#7 also in bf16
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
   of their 3xTF32 arithmetic, with the fp32 CUDA-core bound beside it;
   and the dygraph path's #1, #3, #2, #4 (B=32, S=128, training
   dropout), #1 and #2 in eval (B=8) and #10/#11 at the embedding
   LayerNorm's [4096, 768].

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
WINDOW_S = 1.0
WINDOW_REQUESTS = 150
WINDOW_REPS = 2
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
# bench.py's accelerator legs gpt_s4096 and gpt_s8192 (bench.py:1050-1051):
# bench_gpt_longctx's (B, S) under `_amp`, timed as its _timed_loop times
# them: best of 2 rounds of 10 steps after 3 warm-up steps
GPT_LONG_LEGS = ((2, 4096), (1, 8192))
GPT_LONG_WARM, GPT_LONG_STEPS, GPT_LONG_ROUNDS = 3, 10, 2
# bench.py's contract between the executor's live perf.mfu gauge and the
# leg's offline MFU (bench.py:143-145): within 2 points
MFU_GAUGE_DELTA = 0.02
# the flag that routes layer_norm through #10/#11
LN_FLAG = "FLAGS_paddle_tpu_pallas_layer_norm"
# GPT serving (GPTConfig.small()): a batch of 8 generates 128 tokens after
# a context of 128 (full recompute at S=256); prefill and decode logits on
# the card vs the CPU, and the top two logits of a near-tie, within 1e-4
GEN_BATCH, GEN_CTX, GEN_MAX, GEN_NEW, GEN_ROUNDS = 8, 128, 256, 128, 3
LOGIT_ATOL = 1e-4
# ResNet (phases 18-20): bench_resnet's Momentum(0.1, 0.9); the served
# classifier's buckets, bench_serving's resnet_classify mix. Card vs CPU
# at bench_resnet's CPU size, fp32 both (cuDNN with TF32 off against the
# CPU's convolutions), each step from one state (card_vs_cpu's resync:
# batch norm over 4 samples of a 1x1 map divides by batch deviations near
# sqrt(eps), and at lr 0.1 one step takes the loss from 4.4 to 13.8, so
# the first step's rounding differences grew to 17% of a gradient in the
# second on the H100): loss rtol 1e-4; every @GRAD, velocity and
# parameter update (end - start) by its relative L2, 1e-3 (a step's
# gradients 2.5e-4 apart on the H100); moving statistics atol 1e-5 +
# rtol 1e-4
RESNET_LR = 0.1
RESNET_BUCKETS = (1, 2, 4)
RESNET_TOL = dict(loss=1e-4, grad=("l2", 1e-3), velocity=("l2", 1e-3),
                  stats=("elementwise", 1e-5, 1e-4), update=("l2", 1e-3))
# YOLOv3 (phases 20-22). Card vs CPU at bench_yolov3's CPU size, fp32
# both, each step from one state: the forwards drift ~1e-4 apart through
# 75 convolutions, and where a batch-norm output near 0 falls on the other
# side of 0 its leaky_relu slope is 0.02 on one side and 1 on the other,
# which moves a layer's gradient by percents at B=2 (and up to 15% of
# yolo_det0_tip_w's, a layer of 2x2 maps); yolov3_loss's objectness mask
# (a predicted box's IoU about ignore_thresh) is such a branch too. So a
# branch guard (yolov3_guard) first requires every leaky_relu input to
# lie on the same side of 0 on the card and the CPU, and both masks to be
# equal; the card's cuDNN sums in an order of its own from run to run, so
# a step whose branches differ is taken again from the state before it
# on the next of YOLO_SPARES spare feeds (bench's seeds 4, 5, ...). The
# gradients, velocities and updates are held by relative L2, the loss and
# the moving statistics tightly
YOLO_LR = 0.01
YOLO_TOL = dict(loss=1e-4, grad=("l2", 2 ** -5), velocity=("l2", 2 ** -5),
                stats=("elementwise", 3e-4, 3e-4), update=("l2", 2 ** -5))
YOLO_SPARES = 16  # feeds for the steps the guard refuses
YOLO_BUCKETS = (1, 2, 4)
# the predictor's answers (Out rows): scores within YOLO_SCORE_ATOL, box
# corners within YOLO_BOX_RTOL of their row's largest coordinate + 1, and
# rows whose scores chain within YOLO_TIE_EPS compared as a set
YOLO_SCORE_ATOL = 2e-4
YOLO_BOX_RTOL = 5e-4
YOLO_TIE_EPS = 2e-4
# CTR (phases 23-26): bench.py's deepfm and deepfm_fused legs at
# DeepFMConfig.criteo(), B=4096, Adam(1e-3), fp32, 3 warm-up and 20 timed
# steps as bench.py times them on an accelerator; the cached segment's
# feeds; bench_serving's ctr_rank buckets, its closed loop of 8 clients
# and shorter serving windows than phase 4's (the section's time). Card vs
# CPU at bench.py's CPU config (DeepFMConfig(1000, 6, 8, (16,), 4), B=64)
# under FP32_TOL; the cached run's host stores (end - start) and moments
# by relative L2 1e-3 (RESNET_TOL's bound: an Adam step follows the sign
# of a near-zero gradient), its residency equal; served probabilities
# within 1e-5 of a direct run and of the CPU
CTR_B, CTR_SMALL_B = 4096, 64
CTR_WARM, CTR_TIMED = 3, 20
CTR_FEEDS = 16
CTR_BUCKETS = (1, 2, 4, 8)
CTR_CLIENTS, CTR_LOOP_S = 8, 5.0
CTR_WINDOW = (1.0, 200)
CTR_STORE_L2 = 1e-3
CTR_PROB_ATOL = 1e-5
LOOKUP_OPS = ("distributed_lookup_table", "fused_lookup_table")
# Mask R-CNN (phases 27-29): bench.py's mask_rcnn leg. Card vs CPU at its
# CPU config (MaskRCNNConfig.tiny(), 64x64, B=2, 2 boxes; the legacy
# program at its 1 image), fp32, one Momentum(0.002, 0.9) step from one
# state: the six losses relative to the CPU's, rois_num and labels equal,
# gradients, velocities and updates by relative L2, the moving statistics
# elementwise (readings on the H100: losses 1.9e-6, gradients 1.8e-4,
# updates 1.6e-3, statistics 4.2e-6; the gradient bound leaves room for a
# relu input near 0 that changes sign behind batch norm over 2 images, as
# YOLOv3's leaky_relu). The near-tie guard (mask_rcnn_guard) first
# requires every decision of the step to lie further from its threshold
# than the two runs could move it; the card draws its own startup state,
# so the phase takes the first of MRCNN_SEEDS feeds whose decisions hold.
# The accelerator config: MRCNN_ACCEL, 256x256, B=8, 8 boxes, under
# bench's AMP with dynamic loss scaling from 2^12
MRCNN_LR = 0.002
MRCNN_ACCEL = dict(class_num=81, scale=0.5, rpn_pre_nms=512,
                   rpn_post_nms=128, batch_size_per_im=64, depth=50)
MRCNN_TOL = dict(loss=1e-5, grad=("l2", 2 ** -5), velocity=("l2", 2 ** -5),
                 stats=("elementwise", 3e-5, 3e-5), update=("l2", 2 ** -5))
MRCNN_MARGIN = dict(iou=1e-5, level=1e-5, pixel=1e-4)
MRCNN_SEEDS = 8  # feeds tried for one whose decisions the guard holds
MRCNN_FULL = (8, 256, 8)  # images a step, their side, boxes an image
MRCNN_WARM, MRCNN_TIMED = 3, 5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def on_card(batches):
    """Host feeds (dicts of numpy arrays) as dicts of card tensors."""
    return [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
            for b in batches]


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
    function's name (with its dtype, its integer template arguments in
    order: a head dim, or a chunk or value count and warps a row, and the
    row backwards' copy path where it is a template), its spills and its
    registers."""
    out, kernel, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"entry function '.*?\d+([a-z_]+_kernel)(I\w*)?",
                      line)
        if m:
            kernel, spill = m.group(1), ""
            args = m.group(2) or ""
            if args:
                dtype = "bf16" if "bfloat16" in args else "f32"
                dims = re.findall(r"Li(\d+)E", args.split("EEv")[0])
                # #4's and #11's copy path: 16-byte vectors or elements
                vec = re.search(r"Lb([01])E", args)
                tags = [dtype] + dims + (
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
    [8192, 768] and at R = 1001 (a multiple of no row group) with N in
    {256, 1024, 4096, 8192} (one, four and eight warps a row), fp32 and
    bf16 x, scale and bias fp32, bf16 or absent; #11 on unaligned rows
    (x and dy [R, N] slices of [R, N + 1] fp32 / [R, N + 2] bf16
    buffers, element by element) gives the bits of the same values in
    aligned rows (16-byte vectors), and twice on the same inputs the same
    bits. Returns the errors at the GPT AMP path's case ([8192, 768],
    bf16 x, scale and bias) and in fp32."""
    print("== parity, layer_norm: #10/#11 vs plain version on the card")
    err = {}
    for R, N in ((8192, 768), (1001, 256), (1001, 1024), (1001, 4096),
                 (1001, 8192)):
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
    for R, N in ((8192, 768), (1001, 1024)):
        for dtype, pad in ((torch.float32, 1), (torch.bfloat16, 2)):
            x, dy, s, _ = ln_inputs(R, N, dtype, dtype, SEED)
            xu, dyu = (torch.empty(R, N + pad, dtype=dtype,
                                   device="cuda")[:, :N].copy_(t)
                       for t in (x, dy))
            aligned = lnk.layer_norm_bwd(x, s, dy, 1e-5)
            check(all(torch.equal(a, b) for a, b in
                      zip(lnk.layer_norm_bwd(xu, s, dyu, 1e-5), aligned)),
                  f"#11 on unaligned rows (R={R} N={N} {dtype}) differs "
                  "from the same values in aligned rows")
    print("layer_norm bwd: unaligned rows (element by element) give the "
          "aligned rows' bits (16-byte vectors)")
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


def serve_window(srv, name, b, samples, window=(WINDOW_S, WINDOW_REQUESTS)):
    """One closed-loop window at bucket b: submit a full bucket, wait for
    every answer, repeat until `window`'s seconds and requests (WINDOW_S
    and WINDOW_REQUESTS unless given) have both passed. A request's
    latency is its round's: from the bucket's first submit to its last
    answer. Returns (requests/s, p50 ms, p99 ms, requests)."""
    window_s, window_requests = window
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
        if t1 - t_all >= window_s and n >= window_requests:
            break
    lat.sort()
    return (n / (t1 - t_all), lat[len(lat) // 2],
            lat[min(len(lat) - 1, int(0.99 * len(lat)))], n)


def serve_times(frozen, exe, scope, samples, buckets=BUCKETS, name="bert",
                window=(WINDOW_S, WINDOW_REQUESTS)):
    """Closed loop at each bucket, one endpoint per bucket, in WINDOW_REPS
    windows per bucket of `window` (seconds, requests); the buckets run in
    alternating order (1, 2, 4, 8, 8, 4, 2, 1, ...) so drift in the
    host's speed falls on every bucket alike. Prints each window, then
    each bucket's median and spread, and returns them."""
    from paddle_tpu_torch.serving import EndpointConfig, Server

    print(f"== server times, {name} (closed loop, one full bucket in "
          f"flight; windows of >= {window[0]:g} s and >= {window[1]} "
          f"requests, {WINDOW_REPS} per bucket in alternating order)")
    srv = Server()
    runs = {b: [] for b in buckets}
    try:
        for b in buckets:
            srv.add_endpoint(f"{name}{b}", frozen=frozen, executor=exe,
                             scope=scope, config=EndpointConfig(buckets=(b,)))
        srv.warmup()
        for rep in range(WINDOW_REPS):
            for b in (buckets if rep % 2 == 0 else buckets[::-1]):
                rps, p50, p99, n = serve_window(srv, f"{name}{b}", b,
                                                samples, window)
                runs[b].append((rps, p50, p99))
                print(f"  window {rep} bucket {b}: {n} requests, "
                      f"{rps:.1f} requests/s, p50 {p50:.3f} ms, "
                      f"p99 {p99:.3f} ms")
    finally:
        check(srv.close(timeout=300), "server did not drain")
    summary = {}
    for b in buckets:
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
    tag = "server: " if name == "bert" else f"{name} server: "
    print(tag + json.dumps({str(b): s for b, s in summary.items()}))
    return summary


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


def build_bench_bert(fluid, layers, cfg, B, S, lr, amp=False,
                     optimizer=None):
    """bench.py's bench_bert program: MLM pretraining with the gathered
    head and Adam, or optimizer(fluid, layers, lr) (under bench_amp with
    amp=True); lr a float, or None for bench_bert's schedule (linear
    warmup over polynomial decay). Returns (main, startup, loss, lr (the
    float or the schedule's Variable), params_grads, P, optimizer)."""
    from paddle_tpu_torch.models.bert import bert_pretrain

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
        opt = (optimizer or adam)(fluid, layers, lr)
        opt = bench_amp(opt) if amp else opt
        _, pg = opt.minimize(loss, startup)
    return main, startup, loss, lr, pg, P, opt


def adam(fluid, layers, lr):
    """bench_bert's optimizer."""
    return fluid.optimizer.Adam(lr)


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


def card_vs_cpu(fluid, main, startup, loss, pg, feeds, tol=FP32_TOL,
                extra=(), resync=False, close=(), guard=None, spares=()):
    """One optimizer step per feed on the card and on the CPU from one
    state, under `tol` (FP32_TOL, AMP_TOL or RESNET_TOL): the loss (and
    the fetches `extra`, equal), every @GRAD, every parameter-shaped
    accumulator (tol["moment"], or tol["velocity"] for velocities where
    tol names it), the moving statistics where tol names them, beta
    powers, lr, loss scale and counters, and each parameter's update
    (tol["update"]: Adam's exempting rule, or ("l2", bound) on end -
    start). With resync, the state after each step is held so and the CPU
    then takes the card's, so every step starts from one state on both:
    for a model whose steps amplify rounding differences (ResNet's batch
    norms over 4 samples). `guard` (names, fn): fn(CPU values, card
    values) of a step raises on a near-tie; with resync and `spares`,
    such a step is taken again from the state before it on the next
    spare feed. Returns (exempt update elements, elements)."""
    from paddle_tpu_torch import convert

    gexe, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gexe.run(startup, scope=gscope)
    start = convert.state_to_numpy(gscope)
    cexe, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    convert.state_from_numpy(start, cscope, fluid.CPUPlace(), program=main)
    cpu_main = main.clone()  # the same seed and run counter
    guard_names, guard_fn = guard or ((), None)
    fetch = [loss, *extra, *close] + [g for _, g in pg] + list(guard_names)
    n_head = 1 + len(extra) + len(close)
    worst = {"loss": 0.0, "grad": 0.0, "scalars": 0.0}
    # every parameter-shaped accumulator of the optimizer (Adam's and
    # Lamb's moments, a velocity, RMSProp's mean square...), held as
    # tol["velocity"] where tol names velocities, else as tol["moment"]
    accums = {v.name for v in main.list_vars()
              if getattr(v, "_accum_elementwise", False)}
    per = 1 + len(accums) // max(len(pg), 1)

    def hold_state(before, gend, cend, grads):
        """The state after the steps since `before` (its grads: (card,
        CPU) per step); returns (updates line, exempt, total)."""
        for name, c in cend.items():
            g = gend[name]
            kind = ("velocity" if name.endswith("_velocity_0")
                    and "velocity" in tol
                    else "moment" if name in accums
                    else "stats" if name.startswith(("bn_mean",
                                                     "bn_variance"))
                    or name.endswith(("_bn_m", "_bn_v"))  # YOLOv3's names
                    else None)
            if name in grads:
                continue  # parameters: their updates, below
            if kind is not None:
                err, ok = _held(g, c, tol[kind])
                worst[kind] = max(worst.get(kind, 0.0), err)
                check(ok, f"{kind} {name} differs by {err:.3e}")
            elif c.dtype.kind == "f":  # beta powers, lr, loss scale
                d = np.abs(g.astype(np.float64) - c)
                worst["scalars"] = max(worst["scalars"],
                                       float((d / np.abs(c)).max()))
                check((d <= 1e-6 * np.abs(c)).all(),
                      f"{name} differs by {d.max():.3e}")
            else:
                check(np.array_equal(g, c), f"{name}: {g} vs {c}")
        if tol["update"][0] == "l2":
            err = max(_held(gend[n] - before[n], cend[n] - before[n],
                            tol["update"])[0] for n in grads)
            worst["update"] = max(worst.get("update", 0.0), err)
            check(err <= tol["update"][1],
                  f"parameter updates differ by {err:.3e}")
            return (f"parameter updates {worst['update']:.2e} (relative "
                    f"L2 of end - start, bound {tol['update'][1]:g})"), 0, \
                sum(before[n].size for n in grads)
        worst_u, exempt, total = check_updates(before, gend, cend, grads,
                                               SMALL_LR, *tol["update"])
        return (f"parameter updates {worst_u:.2e} of (|update| + lr) over "
                f"{total - exempt} elements ({exempt} of {total} exempt, "
                f"{exempt / total:.2%}, gradients apart by more than "
                f"{tol['update'][1]:g}; cap {tol['update'][2]:.0%}; bound "
                f"{tol['update'][0]:g})"), exempt, total

    before = start
    grads = {p.name: [] for p, _ in pg}  # (card, CPU) per step
    t0 = time.perf_counter()
    feeds, spares = list(feeds), list(spares)
    step = 0
    while step < len(feeds):
        gpu = gexe.run(main, feed=feeds[step], fetch_list=fetch, scope=gscope)
        cpu = cexe.run(cpu_main, feed=feeds[step], fetch_list=fetch,
                       scope=cscope)
        if guard_fn is not None:
            n = len(fetch) - len(guard_names)
            try:
                guard_fn(dict(zip(guard_names, cpu[n:])),
                         dict(zip(guard_names, gpu[n:])))
            except SmokeFailure as e:
                if not (resync and spares and "near-tie guard" in str(e)):
                    raise
                # both back to the state before the step, and the step
                # again on the next spare feed
                print(f"step {step}: {e}; the step again on a spare feed")
                convert.state_from_numpy(before, gscope, fluid.CUDAPlace(0),
                                         program=main)
                convert.state_from_numpy(before, cscope, fluid.CPUPlace(),
                                         program=main)
                feeds[step] = spares.pop(0)
                continue
        check(np.isfinite(gpu[0]).all(), f"card loss not finite: {gpu[0]}")
        for i in [0] + list(range(1 + len(extra), n_head)):
            rel = float(np.abs(gpu[i] - cpu[i]).max()
                        / max(np.abs(cpu[i]).max(), 1e-30))
            worst["loss"] = max(worst["loss"], rel)
            check(rel <= tol["loss"], f"step {step}: loss {i} {gpu[i]} vs "
                  f"CPU {cpu[i]}")
        for v, g, c in zip(extra, gpu[1:], cpu[1:]):
            check(np.array_equal(g, c), f"step {step}: {v.name} {g} vs {c}")
        for (p, _), g, c in zip(pg, gpu[n_head:], cpu[n_head:]):
            grads[p.name].append((g, c))
            err, ok = _held(g, c, tol["grad"])
            worst["grad"] = max(worst["grad"], err)
            check(ok, f"step {step}: {p.name}@GRAD differs by {err:.3e}")
        if resync and step + 1 < len(feeds):
            gmid = convert.state_to_numpy(gscope)
            hold_state(before, gmid, convert.state_to_numpy(cscope), grads)
            convert.state_from_numpy(gmid, cscope, fluid.CPUPlace(),
                                     program=main)
            before, grads = gmid, {p.name: [] for p, _ in pg}
        step += 1
    gend, cend = convert.state_to_numpy(gscope), convert.state_to_numpy(cscope)
    updates, exempt, total = hold_state(before, gend, cend, grads)
    moved = sum(not np.array_equal(start[n], cend[n]) for n in cend)
    # more than the parameters and their accumulators (Adam: two moments,
    # and two beta powers besides; Momentum: velocities, and the moving
    # statistics besides); of the parameters whose gradient is not all 0
    # (Mask R-CNN's RPN heads of levels no sampled anchor lies on get none)
    live = sum(any(np.any(c != 0) for _, c in grads[n]) for n in grads)
    check(moved > per * live, f"only {moved} state tensors moved")
    errs = ", ".join(f"{k} {worst[k]:.2e} ({tol[k][0]} bound {tol[k][1:]})"
                     for k in ("grad", "moment", "velocity", "stats")
                     if k in worst)
    print(f"{len(feeds)} steps{', each from one state' if resync else ''}, "
          f"{len(pg)} gradients, {len(cend)} state tensors ({moved} moved); "
          f"max error vs CPU: loss {worst['loss']:.2e} relative (bound "
          f"{tol['loss']:g}), {errs}; beta powers, lr and loss scale "
          f"{worst['scalars']:.2e} relative (bound 1e-6); {updates}; "
          f"{time.perf_counter() - t0:.1f}s")
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


def op_ranges(events):
    """(op_of, its state) for profile_step's `op:` record_function
    ranges. An event inside a range on the executor's thread belongs to
    that range's op. A `__vjp__` op's backward runs on the autograd
    engine's thread, whose events carry no range and whose clock reads
    later than the executor's (0.2-0.9 ms on the H100): each belongs
    to the op whose replayed forward created its autograd node, found by
    the node's sequence number (the evaluate_function range's
    sequence_nr, equal to the creating forward op's; of the forward events
    with that number, the latest: the counter moves on once it is
    taken)."""
    def ranged(ev):
        while ev is not None:
            if ev.name.startswith("op:"):
                return ev.name[3:]
            ev = ev.cpu_parent
        return None

    seq = {}
    for ev in events:
        if ev.sequence_nr is not None and ev.sequence_nr >= 0:
            op = ranged(ev)
            if op is not None and op.startswith("__vjp__("):
                t = ev.time_range.start
                if ev.sequence_nr not in seq or seq[ev.sequence_nr][0] < t:
                    seq[ev.sequence_nr] = (t, op)

    def op_of(ev):
        op = ranged(ev)
        while op is None and ev is not None:
            if ev.name.startswith("autograd::engine::evaluate_function"):
                op = seq.get(ev.sequence_nr, (0, None))[1]
                break
            ev = ev.cpu_parent
        return op or "(outside the ops)"

    return op_of


def profile_step(run, kind_of=None):
    """One call of run() under torch.profiler: the card's busy time (the
    sum of its kernels' durations; one stream, so they do not overlap),
    its idle share of the wall time, busy time by kind of kernel, and the
    host-device synchronisations and copies inside the step by the
    outermost op that issued them. Kinds are KINDS' name fragments, or
    kind_of(program op type, aten op, kernel name) of the ops that
    launched each kernel: every run_op then runs inside a record_function
    range `op:<type>` (a `__vjp__` op as `__vjp__(<forward type>)`), and
    the busy time is also summed by program op type and, within each
    kind, by kernel name."""
    from paddle_tpu_torch.framework import executor

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    real = executor.run_op

    def ranged(ctx, op, env):
        key = (f"__vjp__({op.attr('fwd_type')})" if op.type == "__vjp__"
               else op.type)
        with torch.profiler.record_function("op:" + key):
            return real(ctx, op, env)

    if kind_of is not None:
        executor.run_op = ranged
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        executor.run_op = real
    kinds, syncs, by_op, names = {}, {}, {}, {}
    if kind_of is None:
        kinds = {k: 0.0 for k, _ in KINDS}
    op_of = op_ranges(prof.events()) if kind_of is not None else None
    for ev in prof.events():
        if kind_of is not None and ev.kernels \
                and ev.device_type == torch.autograd.DeviceType.CPU:
            op = op_of(ev)
            for k in ev.kernels:
                ms = k.duration / 1e3
                kind = kind_of(op, ev.name, k.name)
                kinds[kind] = kinds.get(kind, 0.0) + ms
                by_op[op] = by_op.get(op, 0.0) + ms
                key = (kind, k.name[:90])
                names[key] = names.get(key, 0.0) + ms
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if kind_of is None:
                kind = next(k for k, frags in KINDS
                            if any(f in ev.name for f in frags))
                kinds[kind] += ev.device_time / 1e3
        elif ev.name in ("cudaStreamSynchronize", "cudaMemcpyAsync"):
            top = ev
            while top.cpu_parent is not None:
                top = top.cpu_parent
            if top is not ev:  # inside an op, not the closing synchronize
                # and the aten op that issued it (through its copy_): a
                # clone's device-to-device copy does not hold the host
                src = ev.cpu_parent
                while src.cpu_parent is not None and src.name == "aten::copy_":
                    src = src.cpu_parent
                key = f"{ev.name} from {src.name} in {top.name}"
                syncs[key] = syncs.get(key, 0) + 1
    busy = sum(kinds.values())
    check(busy > 0, "the profiler saw no kernel on the card")
    print(f"profiled step: wall {wall:.1f} ms, card busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {ms:.1f} ms ({ms / busy:.1%} of busy)")
        top = sorted(((t, n) for (kk, n), t in names.items() if kk == k),
                     reverse=True)[:3]
        for t, n in top:
            print(f"    {t:.1f} ms {n}")
    out = dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
               busy_ms_by_kind=kinds, syncs=syncs)
    if kind_of is not None:
        top = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:12])
        print("  card ms by op type: "
              + ", ".join(f"{k} {v:.1f}" for k, v in top.items()))
        out["busy_ms_by_op"] = top
    print(f"  host-device syncs and copies inside the step: {syncs}")
    return out


def host_by_op(run, name_of=None):
    """One call of run() with the executor's run_op timed on the host: the
    ms the host spends in each op type's emitter (building and enqueueing
    its kernels, or waiting where it synchronises with the card), a
    `__vjp__` op under its forward op's type, largest first. name_of(op),
    where given, names the ops to report apart (host_ms_named), under that
    name instead of their type. No profiler runs, so the times are the
    eager executor's own."""
    from paddle_tpu_torch.framework import executor

    real, by, named = executor.run_op, {}, set()

    def timed(ctx, op, env):
        t0 = time.perf_counter()
        out = real(ctx, op, env)
        key = name_of(op) if name_of is not None else None
        if key is not None:
            named.add(key)
        else:
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
    out = dict(host_emit_ms=total, host_ms_by_op=top)
    if name_of is not None:
        out["host_ms_named"] = {k: by[k] for k in sorted(named)}
        print("  named ops: " + ", ".join(
            f"{k} {v:.1f}" for k, v in out["host_ms_named"].items()))
    return out


def run_steps(exe, main, scope, batches, fetch, labels, kc, expect, tokens,
              after=None, warm=3, timed=5, unit="tokens", kind_of=None,
              name_of=None):
    """warm + timed steps through Executor.run, then one under
    torch.profiler (kinds by kind_of, see profile_step) and one with the
    host's time taken by op type; each step must launch the kernels of
    `expect`. after(i, values) checks step i's fetched scalars. Returns
    (every step's values, stats: step time median [min, max] of the timed
    steps, `unit`/s (`tokens` of them a step), the time until
    Executor.run returned, peak memory, the profile, the host's time by op
    type, with the ops name_of names apart: see host_by_op)."""
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
            prof = profile_step(run, kind_of)
        elif i == steps - 1:
            by_op = host_by_op(run, name_of)
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
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 final_loss=values[-1][0], steps=steps, profile=prof,
                 **by_op)
    stats[f"{unit}_per_s"] = tokens / med
    print(f"step time (median [min, max] of {timed} after {warm} warm-up "
          f"steps): {stats['step_ms']:.1f} ms [{stats['step_ms_min']:.1f}, "
          f"{stats['step_ms_max']:.1f}], {tokens / med:.0f} {unit}/s; "
          f"Executor.run returned after {stats['host_ms']:.1f} ms "
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
    batches = on_card(bench_batches(cfg, B, S, P, 4))
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
    return counts, stats


# ---------------------------------------------------------------------------
# GPT: bench.py's bench_gpt_longctx program, and KV-cache serving
# ---------------------------------------------------------------------------

def gpt_longctx_config(num_layers=12, S=GPT_S):
    """bench_gpt_longctx's GPT-small on an accelerator, max_position = S
    (2048, or a long-context leg's)."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=32000, hidden_size=768,
                     num_layers=num_layers, num_heads=12,
                     intermediate_size=3072, max_position=S)


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
        batches = on_card(gpt_batches(cfg, B, S))
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

        # fp32 is the AMP path's yardstick: 2 timed steps (5 under AMP)
        _, stats = run_steps(exe, main, scope, batches, [loss], ("loss",),
                             kc, expect, B * S, after,
                             timed=5 if amp else 2)
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


# ---------------------------------------------------------------------------
# GPT long context: bench.py's gpt_s4096 and gpt_s8192 legs
# ---------------------------------------------------------------------------

def long_parity(ft):
    """#7-#9 against their plain versions on the card at the legs' shapes,
    [B, 12, S, 64] for (B, S) in GPT_LONG_LEGS: causal, fp32 and bf16,
    training dropout (MASK_SEED) and test mode, forward (out and lse) and
    backward, under TOL as at S = 1152 and 2048. Then the training mask
    through a probe: q = k = 0, so each causal row averages its kept
    values v (uniform in [1, 2)), and one mask bit the kernel drew
    otherwise than the plain mask moves its row's output by at least 1/S
    (1.2e-4 at S = 8192), 24 times fp32's tolerance. Returns {(B, S):
    the bf16 errors of the training case}, the rows' dtype (the legs run
    under _amp)."""
    H, D = 12, 64
    errs = {}
    for B, S in GPT_LONG_LEGS:
        print(f"== parity, long context: #7-#9 vs plain version on the card "
              f"at [{B}, {H}, {S}, {D}], causal")
        for dtype in (torch.float32, torch.bfloat16):
            for training in (True, False):
                qkv, _ = attn_inputs(B, H, D, dtype, SEED + S + B, S=S)
                g = torch.Generator(device="cuda").manual_seed(SEED + 1)
                do = torch.randn(B, S, H * D, generator=g,
                                 device="cuda").to(dtype)
                seed = MASK_SEED if training else None
                kw = dict(scale=0.125, rate=TRAIN_RATE, is_test=not training,
                          causal=True)
                tag = f"B={B} S={S} {str(dtype)[6:]} training={training}"
                out, lse = ft.flash_tiled_fwd(qkv, None, seed, H, D, **kw)
                want_o, want_l = ft.reference_fwd(qkv, None, seed, H, D, **kw)
                e_f = compare(out, want_o, "attention", dtype,
                              f"tiled fwd {tag}")
                compare(lse, want_l, "lse", torch.float32,
                        f"tiled fwd lse {tag}")
                del want_o, want_l
                dqkv, _ = ft.flash_tiled_bwd(qkv, None, seed, do, out, lse,
                                             H, D, **kw)
                want, _ = ft.reference_bwd(qkv, None, seed, do, out, lse, H,
                                           D, **kw)
                e_q = compare(dqkv[..., :H * D], want[..., :H * D],
                              "attention_bwd", dtype, f"tiled dq {tag}")
                e_kv = compare(dqkv[..., H * D:], want[..., H * D:],
                               "attention_bwd", dtype, f"tiled dkv {tag}")
                if dtype == torch.bfloat16 and training:
                    errs[(B, S)] = dict(tiled_fwd=e_f, tiled_bwd_dq=e_q,
                                        tiled_bwd_dkv=e_kv)
                del qkv, do, out, lse, dqkv, want
        g = torch.Generator(device="cuda").manual_seed(SEED + 2)
        qkv = torch.zeros(B, S, 3 * H * D, device="cuda")
        qkv[..., 2 * H * D:] = 1 + torch.rand(B, S, H * D, generator=g,
                                              device="cuda")
        kw = dict(scale=0.125, rate=TRAIN_RATE, is_test=False, causal=True)
        compare(ft.flash_tiled_fwd(qkv, None, MASK_SEED, H, D, **kw)[0],
                ft.reference_fwd(qkv, None, MASK_SEED, H, D, **kw)[0],
                "attention", torch.float32,
                f"tiled fwd mask probe B={B} S={S} (a differing mask bit "
                f"moves its row by >= {1 / S:.2e})")
        del qkv
        torch.cuda.empty_cache()
    return errs


def gpt_long_leg(fluid, kc, B, S):
    """bench.py's leg gpt_s{S}: bench_gpt_longctx(on_accel=True, S, B) on
    the card. GPT-small at full width (V=32000, hidden 768, 12 layers, 12
    heads, intermediate 3072, max_position S, dropout 0.1), Adam(1e-4)
    under bench_amp, the two int32 batches of RandomState(0): 3 warm-up
    steps, then _timed_loop's best of 2 rounds of 10 (each round ends by
    reading its last loss), then one step through
    Executor.memory_analysis and one under torch.profiler (the card's
    busy time by kind of kernel, its idle share, the synchronisations).
    Prints the leg's line with bench.py's field names: tokens/s, TFLOP/s
    and MFU against analysis.cost.peak_flops() from Program.estimate's
    step FLOPs, their divergence from bench.py's closed form, the
    executor's live perf.mfu gauge and its distance from the offline
    MFU, the final loss, the measured peak memory against the static
    plan's peak and resident bytes. Fails unless
    every loss is finite, the watched weights moved at step 0, each step
    launched #7, #9 and #8 12 times and no other kernel of ours, the
    profiled step made no cudaStreamSynchronize and the gauge lies within
    MFU_GAUGE_DELTA of the offline MFU. Returns the leg's launches."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.analysis.cost import peak_flops

    name = f"gpt_s{S}"
    print(f"== GPT long context: bench.py's {name} leg, bench_gpt_longctx "
          f"at GPT-small (V=32000, hidden 768, 12 layers, 12 heads, "
          f"max_position {S}), B={B}, S={S}, dropout 0.1, Adam(1e-4) under "
          "bench.py's _amp")
    cfg = gpt_longctx_config(S=S)
    t0 = time.perf_counter()
    main, startup, loss, pg, _ = build_bench_gpt(fluid, cfg, B, S, 1e-4,
                                                 amp=True)
    ops = main.global_block.ops
    print(f"{len(ops)} ops of {len({op.type for op in ops})} types, "
          f"{len(pg)} parameters; built in {time.perf_counter() - t0:.1f}s")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batches = on_card(gpt_batches(cfg, B, S))
    watch = ("gpt_l0_attn_qkv_w", "gpt_l11_mlp_out_w", "lm_head_w")
    snap = {n: scope.find_var(n).clone() for n in watch}
    per_step = dict.fromkeys(kc, 0)
    per_step.update(tiled_fwd=12, tiled_bwd_dq=12, tiled_bwd_dkv=12)

    def step(i):
        (lv,) = exe.run(main, feed=batches[i % len(batches)],
                        fetch_list=[loss], scope=scope, return_numpy=False)
        return lv

    torch.cuda.synchronize()
    reset_counts(kc)
    warm = []
    for i in range(GPT_LONG_WARM):
        warm.append(step(i).item())
        if i == 0:
            moved = [n for n in watch
                     if not torch.equal(scope.find_var(n), snap[n])]
            check(len(moved) == len(watch), f"step 0 moved only {moved}")
    del snap
    dts, losses = [], []
    for _ in range(GPT_LONG_ROUNDS):  # bench.py's _timed_loop
        fetched = []
        t0 = time.perf_counter()
        for i in range(GPT_LONG_STEPS):
            fetched.append(step(i))
        final_loss = fetched[-1].item()
        dts.append(time.perf_counter() - t0)
        losses += [f.item() for f in fetched]
    check(all(math.isfinite(v) for v in warm + losses),
          f"{name}: losses {warm + losses}")
    gauge = obs.snapshot()["gauges"].get("perf.mfu")
    mem = exe.memory_analysis(main, feed=batches[0], fetch_list=[loss],
                              scope=scope)
    prof = profile_step(lambda: step(1))
    no_host_sync(dict(profile=prof), name)
    for kind in ("tiled attention forward (ours)",
                 "tiled attention backward (ours)"):
        check(prof["busy_ms_by_kind"][kind] > 0, f"{name}: no {kind}")
    steps = GPT_LONG_WARM + GPT_LONG_ROUNDS * GPT_LONG_STEPS + 2
    counts = read_counts(kc)
    want = {k: n * steps for k, n in per_step.items()}
    check(counts == want, f"{name}: {steps} steps launched {counts}, "
          f"want {want}")

    # bench.py's figures (bench_gpt_longctx, _estimated_step_flops,
    # _mfu_fields, _perf_gauge_fields)
    best = min(dts)
    n = GPT_LONG_STEPS
    est = main.estimate(feed_shapes={"ids": (B, S)})
    h, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    legacy = 3 * (L * (24 * h * h + 4 * (S // 2) * h) + 2 * h * V) * B * S
    div = abs(est.total_flops - legacy) / legacy
    if div > 0.20:
        print(f"WARNING: cost-model step FLOPs diverge {div:.0%} from the "
              f"retired causal GPT formula ({est.total_flops / 1e12:.4f} "
              f"vs {legacy / 1e12:.4f} TFLOP/step)", file=sys.stderr)
    achieved = est.total_flops * n / best
    mfu = achieved / peak_flops()
    check(gauge is not None, f"{name}: no perf.mfu gauge")
    delta = gauge - mfu
    line = {
        "metric": f"gpt_small_s{S}_train_tokens_per_sec",
        "value": n * B * S / best, "unit": "tokens/s",
        "config": {"batch": B, "seq": S, "amp": True,
                   "attention": "flash_tiled (S beyond whole-row cap)"},
        "samples": [n * B * S / dt for dt in dts],
        "tflops": achieved / 1e12, "mfu": mfu,
        "mfu_peak_tflops": peak_flops() / 1e12,
        "estimated_step_tflops": est.total_flops / 1e12,
        "legacy_formula_tflops": legacy / 1e12,
        "divergence_vs_legacy": div,
        "perf_mfu_gauge": gauge, "perf_mfu_gauge_delta": delta,
        "final_loss": final_loss,
        "step_ms": best / n * 1e3,
        "peak_memory_gib": mem["peak_bytes"] / 2 ** 30,
        "plan_peak_gib": est.peak_bytes / 2 ** 30,
        "plan_resident_gib": est.resident_bytes / 2 ** 30,
        "peak_over_plan": mem["peak_bytes"] / est.peak_bytes,
        "ops": len(ops), "steps": steps,
        "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
        "busy_ms_by_kind": {k: v for k, v in
                            prof["busy_ms_by_kind"].items() if v},
    }
    print(f"gpt long context {name}: " + json.dumps(line))
    check(abs(delta) <= MFU_GAUGE_DELTA,
          f"{name}: perf.mfu gauge {gauge:.4f} is {delta:+.4f} from the "
          f"offline MFU {mfu:.4f}")
    del exe, scope, batches
    torch.cuda.empty_cache()
    return counts


def long_kernel_times(ft, errs, launches):
    """#7-#9 at each leg's shape, [B, 12, S, 64] bf16 (the legs'
    activations under _amp), causal, dropout 0.1 in training: each kernel
    by CUDA events around its launches (launch_ms), its plain version,
    its bound (the live S(S+1)/2 pairs of each head, two flops a
    multiply-add at bf16's 989 TFLOP/s, against the bytes: #7 reads qkv
    and writes out and lse; the backward reads qkv, dO, out and lse once,
    split in halves between #9, which writes dq, and #8, which writes dk
    and dv, and does 8*B*H*D*pairs flops, dP and dQ in #9, dV and dK in
    #8), and scaled_dot_product_attention's bf16 causal forward, its
    backward and the two together. Returns the rows, with each leg's
    launches."""
    import torch.nn.functional as F

    H, D, bf = 12, 64, torch.bfloat16
    kw = dict(scale=0.125, rate=TRAIN_RATE, is_test=False, causal=True)
    rows = []
    for B, S in GPT_LONG_LEGS:
        path, n = f"gpt_s{S}", launches[f"gpt_s{S}"]
        print(f"== kernel times, {path} (B={B}, S={S}, H={H}, D={D}, "
              f"causal, bf16, dropout {TRAIN_RATE} in training)")
        g = torch.Generator(device="cuda").manual_seed(SEED)
        qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda").to(bf)
        do = torch.randn(B, S, H * D, generator=g, device="cuda").to(bf)
        q, k, v = (t.contiguous() for t in
                   qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4))
        pairs = live_pairs(S, True)
        head, lse_bytes = B * S * H * D * 2, B * H * S * 4
        ops = 4 * B * H * D * pairs
        t_f = launch_ms(lambda: ft.flash_tiled_fwd(qkv, None, MASK_SEED, H,
                                                   D, **kw),
                        (("flash_tiled", "flash_tiled_fwd"),))
        t_f = t_f["flash_tiled_fwd"]
        t_pf = cuda_ms(lambda: ft.reference_fwd(qkv, None, MASK_SEED, H, D,
                                                **kw), iters=2, reps=3)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=True, dropout_p=TRAIN_RATE, scale=0.125)

        do4 = do.view(B, S, H, D).transpose(1, 2)
        t_lf = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=TRAIN_RATE, scale=0.125),
            iters=10, reps=5)
        t_lfb = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg),
                                                    do4), iters=10, reps=5)
        o4 = sdpa()
        t_lb = cuda_ms(lambda: torch.autograd.grad(o4, (qg, kg, vg), do4,
                                                   retain_graph=True),
                       iters=10, reps=5)
        del o4
        b_f, _ = fwd_bound(qkv.numel() * 2 + head + lse_bytes, ops, bf)
        print(f"tiled fwd (#7): kernel {t_f:.3f} ms ({ops / t_f / 1e9:.1f} "
              f"TFLOP/s), plain {t_pf:.3f} ms, sdpa forward {t_lf:.3f} ms "
              f"({t_f / t_lf:.2f}x), bound {b_f[0]:.4f} ms ({b_f[1]})")
        rows.append(row("flash_tiled_fwd", path, "flash_tiled.cu",
                        "paddle_tpu/kernels/flash_tiled.py:127",
                        n["tiled_fwd"], errs[(B, S)]["tiled_fwd"], t_f, t_pf,
                        b_f, t_lf))
        out, lse = ft.flash_tiled_fwd(qkv, None, MASK_SEED, H, D, **kw)
        t = launch_ms(lambda: ft.flash_tiled_bwd(qkv, None, MASK_SEED, do,
                                                 out, lse, H, D, **kw),
                      (("flash_tiled", "flash_tiled_bwd_dq"),
                       ("flash_tiled", "flash_tiled_bwd_dkv")))
        t_pb = cuda_ms(lambda: ft.reference_bwd(qkv, None, MASK_SEED, do, out,
                                                lse, H, D, **kw),
                       iters=2, reps=3)
        flops = 2 * B * H * D * pairs
        reads = qkv.numel() * 2 + 2 * head + lse_bytes  # qkv, dO, out, lse
        b_dq = bound(reads / 2 + head, 2 * flops, bf)
        b_dkv = bound(reads / 2 + 2 * head, 2 * flops, bf)
        t_dq, t_dkv = t["flash_tiled_bwd_dq"], t["flash_tiled_bwd_dkv"]
        print(f"tiled bwd: dq (#9) {t_dq:.3f} ms (bound {b_dq[0]:.4f} "
              f"{b_dq[1]}), dkv (#8) {t_dkv:.3f} ms (bound {b_dkv[0]:.4f} "
              f"{b_dkv[1]}), pair {t_dq + t_dkv:.3f} ms; plain {t_pb:.3f} "
              f"ms; sdpa backward {t_lb:.3f} ms ({(t_dq + t_dkv) / t_lb:.2f}"
              f"x), sdpa forward + backward {t_lfb:.3f} ms against #7 + #9 + "
              f"#8 {t_f + t_dq + t_dkv:.3f} ms")
        for which, src, t_w, b_w in (("dq", 342, t_dq, b_dq),
                                     ("dkv", 269, t_dkv, b_dkv)):
            rows.append(row(f"flash_tiled_bwd_{which}", path,
                            "flash_tiled.cu",
                            f"paddle_tpu/kernels/flash_tiled.py:{src}",
                            n[f"tiled_bwd_{which}"],
                            errs[(B, S)][f"tiled_bwd_{which}"], t_w, t_pb,
                            b_w, t_lb))
        del qkv, do, q, k, v, qg, kg, vg, do4, out, lse
        torch.cuda.empty_cache()
    return rows


def gpt_long_path(fluid, ft, kc):
    """The GPT long-context section: #7-#9 at the legs' shapes against
    their plain versions, the two legs, then the kernels' times at the
    legs' shapes. Returns the kernel rows."""
    errs = long_parity(ft)
    launches = {f"gpt_s{S}": gpt_long_leg(fluid, kc, B, S)
                for B, S in GPT_LONG_LEGS}
    return long_kernel_times(ft, errs, launches)


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
    residual forward (#2) and backward (#4) are timed in fp32 and again at
    the BERT AMP path's bf16 activations (x, y and dO bf16, scale and
    bias fp32; their rows' launches are that path's), each beside
    F.layer_norm(x + y) or its backward (whose scale and bias take x's
    dtype); #4's row groups (fr.bwd_groups) are printed, and sum_partials
    is timed at that count."""
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
    # BERT AMP's activations: x and y bf16, g and c fp32
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    e_fwd = compare(fr.fused_dropout_add_ln_fwd(xb, yb, g, c, **rkw),
                    fr.reference_fwd(xb, yb, g, c, **rkw), "residual",
                    torch.bfloat16, f"residual fwd R={R} bfloat16")
    t_k = cuda_ms(lambda: fr.fused_dropout_add_ln_fwd(xb, yb, g, c, **rkw))
    t_p = cuda_ms(lambda: fr.reference_fwd(xb, yb, g, c, **rkw), iters=10,
                  reps=5)
    gb, cb = g.to(torch.bfloat16), c.to(torch.bfloat16)
    t_l = cuda_ms(lambda: F.layer_norm(xb + yb, (N,), gb, cb, 1e-5))
    b = res_bound(xb, N)
    print(f"residual fwd bfloat16: kernel {t_k:.4f} ms, plain {t_p:.4f} "
          f"ms, F.layer_norm(x + y) bfloat16 {t_l:.4f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]}; {t_k / b[0]:.2f}x)")
    rows.append(row("fused_dropout_add_ln_fwd", "amp_training",
                    "fused_dropout_add_ln.cu",
                    "paddle_tpu/kernels/fused_residual.py:90",
                    amp_launches["residual_fwd"], e_fwd, t_k, t_p, b, t_l))
    del xb, yb, gb, cb
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
    groups, per = lnk.bwd_groups(R)
    print(f"== kernel times, GPT AMP path's layer_norm (R={R}, N={N}; "
          f"#11 in {groups} row groups of {per} rows)")
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
              f"{b_b[0] / t['layer_norm_bwd']:.2f} of its bound; "
              f"sum_partials {t['sum_partials']:.4f} ms), plain "
              f"{t_pb:.4f} ms, F.layer_norm backward {t_lb:.4f} ms "
              f"({t_b / t_lb:.2f}x), bound {b_b[0]:.4f} ms ({b_b[1]})")
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
    batches = on_card(host_feeds[:2])
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


def sass_texts(lib_names):
    """{library: its SASS} from cuobjdump -sass, one process per library,
    all started together (each takes seconds), each writing to a file of
    its own so that none waits on a full pipe."""
    import tempfile

    from paddle_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    files = {name: tempfile.TemporaryFile(mode="w+") for name in lib_names}
    procs = {}
    try:
        for name, f in files.items():
            procs[name] = subprocess.Popen(
                [str(tool), "-sass", str(_build.lib_path(name))], stdout=f,
                stderr=subprocess.STDOUT, text=True)
        out = {}
        for name, proc in procs.items():
            proc.wait(timeout=300)
            files[name].seek(0)
            out[name] = files[name].read()
            check(proc.returncode == 0,
                  f"cuobjdump -sass {name} failed: {out[name][-2000:]}")
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files.values():
            f.close()


def sass_hmma(sass, kernels):
    """{"kernel<dtype, D>": HMMA (tensor-core) instructions} of each
    instance of the named kernels in a kernel library's SASS."""
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
    memory. Then the row backwards #4 (ln_bwd_kernel) and #11
    (ln_row_bwd_kernel) at N = 768 and 1024, fp32 and bf16, on their
    vector paths: their blocks an SM and shared memory."""
    from paddle_tpu_torch.kernels import _build

    print("== kernels on the tensor cores as built: tensor-core "
          "instructions, blocks an SM")
    sass = sass_texts([lib_name for lib_name, _, _ in MMA_KERNELS])
    for lib_name, kernels, entry in MMA_KERNELS:
        hmma = sass_hmma(sass[lib_name], kernels)
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
    for lib_name, entry, kernel in (
            ("fused_dropout_add_ln", "fused_dropout_add_ln_bwd_occupancy",
             "ln_bwd_kernel"),
            ("layer_norm", "layer_norm_bwd_occupancy", "ln_row_bwd_kernel")):
        occupancy = getattr(_build.load(lib_name), entry)
        occupancy.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        occupancy.restype = ctypes.c_int
        for code, dtype in enumerate(("f32", "bf16")):
            for N in (768, 1024):
                blocks, smem = ctypes.c_int(), ctypes.c_int()
                err = occupancy(code, N, 1, ctypes.byref(blocks),
                                ctypes.byref(smem))
                check(err == 0 and blocks.value > 0,
                      f"{kernel}<{dtype}> N={N}: occupancy query failed "
                      f"({err}) or no block fits on an SM")
                print(f"  {kernel}<{dtype}> N={N} (CUDA cores): "
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


# ---------------------------------------------------------------------------
# ResNet: bench.py's bench_resnet and bench_serving.py's resnet_classify
# ---------------------------------------------------------------------------


def build_bench_resnet(fluid, B, hw, depth, class_num, amp=False):
    """bench.py's bench_resnet program: resnet_train_net (softmax-CE loss,
    top-1 accuracy) with Momentum(0.1, 0.9), under bench_amp with
    amp=True. Returns (main, startup, loss, accuracy, params_grads,
    optimizer)."""
    from paddle_tpu_torch.models import resnet_train_net
    from paddle_tpu_torch.optimizer import Momentum

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.data("image", [B, 3, hw, hw])
        label = fluid.data("label", [B, 1], "int64")
        loss, acc = resnet_train_net(image, label, depth=depth,
                                     class_num=class_num)
        opt = Momentum(RESNET_LR, 0.9)
        if amp:
            opt = bench_amp(opt)
        _, pg = opt.minimize(loss, startup)
    return main, startup, loss, acc, pg, opt


def resnet_batches(B, hw, class_num):
    """bench_resnet's two batches: uniform images, int32 labels, from
    RandomState(0)."""
    rng = np.random.RandomState(0)
    return [{"image": rng.rand(B, 3, hw, hw).astype("float32"),
             "label": rng.randint(0, class_num, (B, 1)).astype("int32")}
            for _ in range(2)]


def resnet_train_small(fluid):
    """Two Momentum(0.1, 0.9) steps of bench_resnet's program at its CPU
    size with 10 classes, on the card and on the CPU from one state."""
    print("== ResNet training, reduced size: bench_resnet's program at "
          "ResNet-18, 3x32x32, B=4, 10 classes, Momentum(0.1, 0.9), fp32; "
          "card vs CPUPlace()")
    main, startup, loss, acc, pg, _ = build_bench_resnet(fluid, 4, 32, 18,
                                                         10)
    card_vs_cpu(fluid, main, startup, loss, pg, resnet_batches(4, 32, 10),
                RESNET_TOL, extra=(acc,), resync=True)


def conv_kind(op, aten, kernel):
    """The kind of a kernel of a convolutional network's step (ResNet,
    YOLOv3), by the program op and the aten op that launched it."""
    if op in ("cast", "__vjp__(cast)"):
        return "casts"
    if op == "momentum":
        return "momentum"
    if op in ("conv2d", "__vjp__(conv2d)"):
        if "backward" in aten:
            return "conv backward (cuDNN)"
        if "conv" in aten:
            return ("conv forward (cuDNN)" if op == "conv2d"
                    else "conv forward replayed by __vjp__(conv2d)")
        return "conv other (zeros, copies)"
    fwd = op.removeprefix("__vjp__(").rstrip(")")
    if fwd in ("batch_norm", "relu", "leaky_relu", "elementwise_add", "sum",
               "assign"):
        return "batch norm, relu/leaky_relu, residual adds, grad sums"
    if fwd == "yolov3_loss":
        return "yolov3_loss and its __vjp__"
    if fwd in ("nearest_interp", "concat"):
        return "FPN neck: nearest_interp, concat"
    return "pool, fc, loss, accuracy and other"


def resnet_train_full(fluid, kc):
    """bench_resnet's training step on an accelerator: ResNet-50, B=128,
    3x224x224, 1000 classes, Momentum(0.1, 0.9) under bench_amp. No
    kernel of ours is on this path: every counter stays 0."""
    B, HW, DEPTH, CLASSES = 128, 224, 50, 1000
    print(f"== ResNet training path: bench_resnet at ResNet-50, B={B}, "
          f"3x{HW}x{HW}, {CLASSES} classes, Momentum(0.1, 0.9), AMP (bf16, "
          "bench.py's _amp)")
    t0 = time.perf_counter()
    main, startup, loss, acc, pg, opt = build_bench_resnet(
        fluid, B, HW, DEPTH, CLASSES, amp=True)
    ops = main.global_block.ops
    print(f"{len(ops)} ops of {len({op.type for op in ops})} types, "
          f"{sum(op.type == 'conv2d' for op in ops)} convolutions, "
          f"{len(pg)} parameters; built in {time.perf_counter() - t0:.1f}s")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batches = on_card(resnet_batches(B, HW, CLASSES))
    watch = ("conv2d_w_0", "conv2d_w_0_velocity_0", "batch_norm_w_52",
             "fc_w_0", "fc_w_0_velocity_0", "bn_mean_0", "bn_variance_52")
    snap = {n: scope.find_var(n).clone() for n in watch}

    def after(i, values):
        if i < 2:  # parameters, velocities and moving statistics move
            moved = [n for n in watch
                     if not torch.equal(scope.find_var(n), snap[n])]
            check(len(moved) == len(watch), f"step {i} moved only {moved}")
            snap.update((n, scope.find_var(n).clone()) for n in watch)

    _, stats = run_steps(exe, main, scope, batches, [loss, acc],
                         ("loss", "accuracy"), kc, dict.fromkeys(kc, 0), B,
                         after, unit="images", kind_of=conv_kind)
    counts = read_counts(kc)
    check(not any(counts.values()), f"a kernel of ours ran: {counts}")
    amp_checks(main, opt, scope, stats["steps"],
               {"conv2d": ("Input", "Filter"), "mul": ("X", "Y")})
    bn_in = {main.global_block.var(op.inputs["X"][0]).dtype
             for op in ops if op.type == "batch_norm"}
    check(bn_in == {"float32"}, f"batch_norm reads {bn_in}")
    stats["ops"] = len(ops)
    print("resnet amp training: " + json.dumps(stats))
    del exe, scope, batches, snap
    torch.cuda.empty_cache()


def build_resnet_classifier(fluid, layers):
    """bench_serving.py's resnet classifier (_build_classifier_endpoint):
    ResNet-18 on [-1, 3, 32, 32], softmax, Adam(1e-3).minimize appended,
    frozen to the probabilities. Returns (startup, frozen)."""
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.serving import freeze_program

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("image", [-1, 3, 32, 32], "float32")
        logits = resnet(img, class_num=10, depth=18, is_test=False)
        prob = layers.softmax(logits)
        lab = fluid.data("lab", [-1, 1], "int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, lab))
        Adam(1e-3).minimize(loss, startup)
    return startup, freeze_program(main, [prob], feed_names=("image",))


def resnet_serving(fluid, layers, kc):
    """The frozen ResNet-18 classifier behind serving.Server at buckets
    (1, 2, 4): answers against a direct run on the card and the port's CPU
    run, no kernel of ours launched; then the server's times."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.serving import EndpointConfig, Server

    print("== ResNet serving path: bench_serving's resnet classifier "
          f"(ResNet-18, 3x32x32, 10 classes) frozen, serving.Server at "
          f"buckets {RESNET_BUCKETS}")
    startup, frozen = build_resnet_classifier(fluid, layers)
    ops = frozen.program.global_block.ops
    bns = [op for op in ops if op.type == "batch_norm"]
    check(len(bns) == 20 and all(op.attr("is_test") for op in bns),
          "a frozen batch_norm is not in test mode")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    groups = (4, 3, 1, 2, 4, 1)
    samples = [{"image": rng.randn(3, 32, 32).astype(np.float32)}
               for _ in range(sum(groups))]
    srv = Server()
    try:
        ep = srv.add_endpoint(
            "resnet", frozen=frozen, executor=exe, scope=scope,
            config=EndpointConfig(buckets=RESNET_BUCKETS, max_wait_ms=20.0))
        srv.warmup()
        torch.cuda.synchronize()
        reset_counts(kc)
        served, i = [], 0
        for g in groups:
            futs = [srv.submit("resnet", samples[j]) for j in range(i, i + g)]
            served += [f.result(timeout=300)[0] for f in futs]
            i += g
        counts = read_counts(kc)
        batches = list(ep.batches)
    finally:
        check(srv.close(timeout=300), "server did not drain")
    served = np.stack(served)
    print(f"{len(ops)} frozen ops; served {len(served)} requests in "
          f"{len(batches)} batches (bucket, rows): {batches}; launches of "
          f"our kernels: {sum(counts.values())}")
    check(not any(counts.values()), f"a kernel of ours ran: {counts}")
    check(served.shape == (len(samples), 10) and np.isfinite(served).all(),
          f"served probabilities: shape {served.shape} or not finite")
    direct = np.concatenate([
        exe.run(frozen.program, feed={"image": s["image"][None]},
                fetch_list=list(frozen.fetch_names), scope=scope)[0]
        for s in samples])
    d_err = np.abs(served - direct).max()
    cpu_scope = fluid.Scope()
    convert.state_from_numpy(convert.state_to_numpy(scope), cpu_scope,
                             fluid.CPUPlace())
    cpu, = fluid.Executor(fluid.CPUPlace()).run(
        frozen.program, feed={"image": np.stack([s["image"]
                                                 for s in samples])},
        fetch_list=list(frozen.fetch_names), scope=cpu_scope)
    c_err = np.abs(served - cpu).max()
    print(f"served vs direct run on the card, one sample each: "
          f"max_abs_err={d_err:.3e}; vs the port on CPUPlace(): "
          f"max_abs_err={c_err:.3e} (tol {PROB_ATOL:g})")
    check(d_err <= PROB_ATOL, f"served and direct answers differ: {d_err}")
    check(c_err <= PROB_ATOL, f"card and CPU answers differ: {c_err}")
    check(np.abs(served - served.mean(0)).max() > 1e-6,
          "every request got the same answer")
    serve_times(frozen, exe, scope, samples, RESNET_BUCKETS, "resnet")
    del exe, scope
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# YOLOv3: bench.py's bench_yolov3 and the paper's detector behind the
# predictor
# ---------------------------------------------------------------------------


def build_bench_yolov3(fluid, B, hw, cfg, n_gt=10, amp=False):
    """bench.py's bench_yolov3 program: yolov3_train over [B, 3, hw, hw]
    with n_gt boxes an image, Momentum(0.01, 0.9), under bench_amp with
    amp=True. Returns (main, startup, loss, params_grads, optimizer)."""
    from paddle_tpu_torch.models import yolov3_train
    from paddle_tpu_torch.optimizer import Momentum

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.data("image", [B, 3, hw, hw])
        gt_box = fluid.data("gt_box", [B, n_gt, 4])
        gt_label = fluid.data("gt_label", [B, n_gt], "int32")
        loss = yolov3_train(image, gt_box, gt_label, cfg)
        opt = Momentum(YOLO_LR, 0.9)
        if amp:
            opt = bench_amp(opt)
        _, pg = opt.minimize(loss, startup)
    return main, startup, loss, pg, opt


def yolov3_batch(B, hw, class_num, n_gt=10, seed=0):
    """bench_yolov3's batch: boxes rand * 0.5 with 0.2 added to w and h,
    uniform images, int32 labels, drawn in bench's order."""
    rng = np.random.RandomState(seed)
    boxes = rng.rand(B, n_gt, 4).astype("float32") * 0.5
    boxes[..., 2:] += 0.2
    return {"image": rng.rand(B, 3, hw, hw).astype("float32"),
            "gt_box": boxes,
            "gt_label": rng.randint(0, class_num, (B, n_gt)).astype("int32")}


def yolov3_train_small(fluid):
    """Four Momentum(0.01, 0.9) steps of bench_yolov3's program at its CPU
    size, on the card and on the CPU, each from one state, behind the
    branch guard."""
    from paddle_tpu_torch.models import YoloConfig

    print("== YOLOv3 training, reduced size: bench_yolov3's program at "
          "YoloConfig.tiny(class_num=4), 3x64x64, B=2, 10 boxes, "
          f"Momentum({YOLO_LR:g}, 0.9), fp32; card vs CPUPlace()")
    main, startup, loss, pg, _ = build_bench_yolov3(
        fluid, 2, 64, YoloConfig.tiny(4))
    card_vs_cpu(fluid, main, startup, loss, pg,
                [yolov3_batch(2, 64, 4, seed=s) for s in range(4)],
                YOLO_TOL, resync=True, guard=yolov3_guard(main),
                spares=[yolov3_batch(2, 64, 4, seed=s)
                        for s in range(4, 4 + YOLO_SPARES)])


def yolov3_guard(main):
    """(names, fn) of the branch guard of a YOLOv3 training program, for
    card_vs_cpu: fn(want, got) requires every leaky_relu input to lie on
    the same side of 0 in both runs (the slope taken, 1 or 0.02) and each
    yolov3_loss's ObjectnessMask and GTMatchMask to be equal; where one
    branch differs the two steps compute different functions, and their
    gradients differ by up to 15% (a layer of 2x2 maps at B=2). Returns
    the count of leaky_relu inputs nearest 0 and the nearest |x|."""
    ops = main.global_block.ops
    kinks = [op.inputs["X"][0] for op in ops if op.type == "leaky_relu"]
    masks = [op.outputs[s][0] for op in ops if op.type == "yolov3_loss"
             for s in ("ObjectnessMask", "GTMatchMask")]

    def fn(want, got):
        flips = {n: int(((want[n] > 0) != (got[n] > 0)).sum())
                 for n in kinks}
        flips = {n: c for n, c in flips.items() if c}
        differ = [n for n in masks if not np.array_equal(want[n], got[n])]
        nearest = min(float(np.abs(want[n]).min()) for n in kinks)
        check(not flips and not differ,
              f"near-tie guard: leaky_relu inputs on the other side of 0 "
              f"{flips}, yolov3_loss masks that differ {differ}")
        print(f"branch guard: {len(kinks)} leaky_relu inputs each on one "
              f"side of 0 in both runs (the nearest {nearest:.2e} from "
              f"it), {len(masks)} yolov3_loss masks equal")
        return nearest

    return kinks + masks, fn


def yolov3_step_dtypes(exe, main, scope, feed):
    """One more step fetching each yolov3_loss's X and Loss as tensors:
    under _amp X is bf16 and Loss fp32."""
    ops = [op for op in main.global_block.ops if op.type == "yolov3_loss"]
    fetch = [n for op in ops for n in (op.inputs["X"][0],
                                       op.outputs["Loss"][0])]
    outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False)
    got = {(str(outs[i].dtype), str(outs[i + 1].dtype))
           for i in range(0, len(outs), 2)}
    check(got == {("torch.bfloat16", "torch.float32")},
          f"yolov3_loss (X, Loss) dtypes {got}")
    return len(ops)


def yolov3_train_full(fluid, kc):
    """bench_yolov3's training step on an accelerator: YoloConfig(80,
    scale=0.5), B=64, 3x224x224, 10 boxes, Momentum(0.01, 0.9) under
    bench_amp; then the paper's width, 416x416, B=16. No kernel of ours
    is on this path: every counter stays 0."""
    from paddle_tpu_torch.models import YoloConfig

    B, HW = 64, 224
    print(f"== YOLOv3 training path: bench_yolov3 at YoloConfig(class_num="
          f"80, scale=0.5), B={B}, 3x{HW}x{HW}, 10 boxes, Momentum("
          f"{YOLO_LR:g}, 0.9), AMP (bf16, bench.py's _amp)")
    t0 = time.perf_counter()
    cfg = YoloConfig(class_num=80, scale=0.5)
    main, startup, loss, pg, opt = build_bench_yolov3(fluid, B, HW, cfg,
                                                      amp=True)
    ops = main.global_block.ops
    print(f"{len(ops)} ops of {len({op.type for op in ops})} types, "
          f"{sum(op.type == 'conv2d' for op in ops)} convolutions, "
          f"{sum(op.type == 'cast' for op in ops)} casts, {len(pg)} "
          f"parameters; built in {time.perf_counter() - t0:.1f}s")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batches = on_card([yolov3_batch(B, HW, 80)])
    watch = ("yolo_dark_stem_w", "yolo_dark_stem_w_velocity_0",
             "yolo_dark_stem_bn_m", "yolo_det2_tip_bn_v", "yolo_head0_w",
             "yolo_head0_w_velocity_0", "yolo_head2_b")
    snap = {n: scope.find_var(n).clone() for n in watch}

    def after(i, values):
        if i < 2:  # parameters, velocities and moving statistics move
            moved = [n for n in watch
                     if not torch.equal(scope.find_var(n), snap[n])]
            check(len(moved) == len(watch), f"step {i} moved only {moved}")
            snap.update((n, scope.find_var(n).clone()) for n in watch)

    _, stats = run_steps(exe, main, scope, batches, [loss], ("loss",), kc,
                         dict.fromkeys(kc, 0), B, after, unit="images",
                         kind_of=conv_kind)
    amp_checks(main, opt, scope, stats["steps"],
               {"conv2d": ("Input", "Filter")})
    bn_in = {main.global_block.var(op.inputs["X"][0]).dtype
             for op in ops if op.type == "batch_norm"}
    check(bn_in == {"float32"}, f"batch_norm reads {bn_in}")
    heads = yolov3_step_dtypes(exe, main, scope, batches[0])
    counts = read_counts(kc)
    check(not any(counts.values()), f"a kernel of ours ran: {counts}")
    stats["ops"] = len(ops)
    print(f"{heads} yolov3_loss heads on bf16 X give fp32 Loss; "
          "yolov3 amp training: " + json.dumps(stats))
    del exe, scope, batches, snap
    torch.cuda.empty_cache()
    yolov3_paper_steps(fluid, kc)


def yolov3_paper_steps(fluid, kc):
    """The paper's YOLOv3 (YoloConfig(class_num=80): DarkNet-53, three
    heads) at 416x416, B=16, Momentum(0.01, 0.9) under bench_amp: 1
    warm-up and 3 timed steps, then run_steps' profiled and host-timed
    steps."""
    from paddle_tpu_torch.models import YoloConfig

    B, HW = 16, 416
    print(f"== YOLOv3 training at the paper's width: YoloConfig(class_num="
          f"80), B={B}, 3x{HW}x{HW}, 10 boxes, AMP; 1 warm-up and 3 timed "
          "steps")
    main, startup, loss, pg, _ = build_bench_yolov3(
        fluid, B, HW, YoloConfig(class_num=80), amp=True)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batches = on_card([yolov3_batch(B, HW, 80)])
    watch = [p.name for p, _ in pg[:2] + pg[-2:]]
    snap = {n: scope.find_var(n).clone() for n in watch}

    def after(i, values):
        if i < 2:  # the first and the last layers' weights move
            moved = [n for n in watch
                     if not torch.equal(scope.find_var(n), snap[n])]
            check(len(moved) == len(watch), f"step {i} moved only {moved}")
            snap.update((n, scope.find_var(n).clone()) for n in watch)

    _, stats = run_steps(exe, main, scope, batches, [loss], ("loss",), kc,
                         dict.fromkeys(kc, 0), B, after, warm=1, timed=3,
                         unit="images", kind_of=conv_kind)
    counts = read_counts(kc)
    check(not any(counts.values()), f"a kernel of ours ran: {counts}")
    stats["ops"] = len(main.global_block.ops)
    print("yolov3 paper-width amp training: " + json.dumps(stats))
    del exe, scope, batches, snap
    torch.cuda.empty_cache()


def box_error(got, want):
    """|got - want| of each box corner over 1 + the largest coordinate of
    its row (a corner is the centre less half the box: its error follows
    the box's extent)."""
    scale = 1.0 + np.abs(want[..., 2:]).max(axis=-1, keepdims=True)
    return np.abs(got[..., 2:] - want[..., 2:]) / scale


def paired_rows(got, want):
    """want's rows reordered to pair with got's: each row of got, in turn,
    takes the unpaired row of want with its label whose box is nearest
    (box_error); a row with no such partner keeps a row of another label,
    which the caller's label check refuses."""
    left, order = list(range(len(want))), []
    for r in got:
        same = [j for j in left if want[j, 0] == r[0]] or left
        j = min(same, key=lambda j: box_error(r[None], want[j][None]).max())
        left.remove(j)
        order.append(j)
    return want[order]


def hold_detections(got, want, counts, what):
    """multiclass_nms rows [B, K, 6] of one run against another's: labels
    and counts equal; scores within YOLO_SCORE_ATOL; box corners within
    YOLO_BOX_RTOL (box_error); rows whose scores chain within YOLO_TIE_EPS
    (sums in other orders may swap two near-equal scores; the invalid
    rows all score 0) compared as a set (paired_rows). Returns
    (valid rows in near-tie groups, score error, box error)."""
    check(got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}")
    tied, s_err, b_err = 0, 0.0, 0.0
    for b in range(want.shape[0]):
        g = got[b].astype(np.float64)
        w = want[b].astype(np.float64)
        n = int(counts[b])
        check(np.array_equal(g[:, 0] >= 0, np.arange(len(w)) < n),
              f"{what}: image {b} has other valid rows")
        s_err = max(s_err, float(np.abs(g[:, 1] - w[:, 1]).max()))
        start = 0
        for i in range(1, len(w) + 1):
            if i < len(w) and abs(w[i, 1] - w[i - 1, 1]) <= YOLO_TIE_EPS:
                continue
            gg, ww = g[start:i], w[start:i]
            if i - start > 1:
                ww = paired_rows(gg, ww)
                tied += sum(r < n for r in range(start, i))
            check(np.array_equal(gg[:, 0], ww[:, 0]),
                  f"{what}: image {b} rows {start}-{i - 1} labels differ")
            b_err = max(b_err, float(box_error(gg, ww).max()))
            start = i
    check(s_err <= YOLO_SCORE_ATOL, f"{what}: scores differ by {s_err}")
    check(b_err <= YOLO_BOX_RTOL, f"{what}: boxes differ by {b_err}")
    return tied, s_err, b_err


def yolov3_predictor(fluid, kc):
    """The paper's detector, yolov3_infer(img, size, YoloConfig(80)) at
    416x416, fp32: its moving statistics set to one training-mode batch's
    (as trained ones would be: at mean 0 and variance 1 the residual adds
    grow the activations until exp(tw) overflows), io.save_inference_model,
    inference.create_paddle_predictor with batch buckets (1, 2, 4); each
    answer against a direct run on the card, bucket 1 against the port's
    CPU run; ms a batch at each bucket."""
    import shutil
    import tempfile

    from paddle_tpu_torch import convert, inference, io
    from paddle_tpu_torch.models import YoloConfig, yolov3_infer

    HW = 416
    print(f"== YOLOv3 predictor: yolov3_infer at YoloConfig(class_num=80), "
          f"3x{HW}x{HW}, fp32, io.save_inference_model, "
          f"create_paddle_predictor, batch buckets {YOLO_BUCKETS}")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("img", [-1, 3, HW, HW])
        size = fluid.data("size", [-1, 2], "int32")
        out, num = yolov3_infer(img, size, YoloConfig(class_num=80))
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)

    def images(n):
        return {"img": rng.randn(n, 3, HW, HW).astype(np.float32),
                "size": np.full((n, 2), HW, np.int32)}

    bns = [op for op in main.global_block.ops if op.type == "batch_norm"]
    stats = exe.run(main, feed=images(4), fetch_list=[
        op.outputs[s][0] for op in bns for s in ("SavedMean",
                                                 "SavedVariance")],
        scope=scope, return_numpy=False)
    for i, op in enumerate(bns):
        scope.set_var(op.inputs["Mean"][0], stats[2 * i])
        scope.set_var(op.inputs["Variance"][0], stats[2 * i + 1])
    tmp = tempfile.mkdtemp(prefix="yolov3_model_")
    figures = {}
    try:
        with fluid.scope_guard(scope):
            io.save_inference_model(tmp, ["img", "size"], [out, num], exe,
                                    main)
        config = inference.AnalysisConfig(tmp)
        config.set_batch_buckets(YOLO_BUCKETS)
        pred = inference.create_paddle_predictor(config)
        ops = pred.program.global_block.ops
        check(all(op.attr("is_test") for op in ops
                  if op.type == "batch_norm"), "a batch_norm in train mode")
        pool = images(4)
        answers = {}
        reset_counts(kc)
        for n in (1, 2, 3, 4):
            feed = {k: v[:n] for k, v in pool.items()}
            got, cnt = (t.as_ndarray() for t in pred.run(
                [feed["img"], feed["size"]]))
            check(got.shape == (n, 100, 6) and cnt.shape == (n,)
                  and np.isfinite(got).all() and (cnt > 0).all(),
                  f"batch {n}: shapes {got.shape}, {cnt.shape}, counts "
                  f"{cnt}")
            d_out, d_cnt = pred.executor.run(
                pred.program, feed=feed,
                fetch_list=pred.get_output_names(), scope=pred.scope)
            check(np.array_equal(cnt, d_cnt), f"batch {n}: counts {cnt} "
                  f"vs a direct run's {d_cnt}")
            tied, s_err, b_err = hold_detections(got, d_out, cnt,
                                                 f"batch {n} vs direct")
            print(f"  batch {n}: counts {cnt.tolist()}; vs a direct run: "
                  f"scores {s_err:.2e}, boxes {b_err:.2e}, {tied} valid "
                  "rows in near-tie groups")
            answers[n] = (got, cnt)
        counts = read_counts(kc)
        check(not any(counts.values()), f"a kernel of ours ran: {counts}")
        cpu_scope = fluid.Scope()
        convert.state_from_numpy(convert.state_to_numpy(pred.scope),
                                 cpu_scope, fluid.CPUPlace())
        t0 = time.perf_counter()
        c_out, c_cnt = fluid.Executor(fluid.CPUPlace()).run(
            pred.program, feed={k: v[:1] for k, v in pool.items()},
            fetch_list=pred.get_output_names(), scope=cpu_scope)
        cpu_s = time.perf_counter() - t0
        got, cnt = answers[1]
        check(np.array_equal(cnt, c_cnt), f"counts {cnt} vs CPU {c_cnt}")
        tied, s_err, b_err = hold_detections(got, c_out, cnt,
                                             "bucket 1 vs CPU")
        print(f"bucket 1 vs the port on CPUPlace() ({cpu_s:.1f}s): counts "
              f"{cnt.tolist()}; scores {s_err:.2e} (tol "
              f"{YOLO_SCORE_ATOL:g}), boxes {b_err:.2e} of their extent "
              f"(tol {YOLO_BOX_RTOL:g}); {tied} of {int(cnt.sum())} valid "
              f"rows in near-tie groups (scores within {YOLO_TIE_EPS:g})")
        figures.update(cpu_near_tie_rows=tied, cpu_score_err=s_err,
                       cpu_box_err=b_err, ops=len(ops))
        lat = {}
        for n in YOLO_BUCKETS:
            inp = [pool["img"][:n], pool["size"][:n]]
            times = []
            for _ in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred.run(inp)
                times.append((time.perf_counter() - t0) * 1e3)
            lat[n] = statistics.median(times)
        figures["batch_ms"] = lat
        del pred
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{len(ops)} predictor ops; ms a batch by bucket {lat}; yolov3 "
          "predictor: " + json.dumps(figures))
    del exe, scope
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# CTR: bench.py's deepfm and deepfm_fused legs and bench_serving.py's
# ctr_rank ranker, with the embedding engine
# ---------------------------------------------------------------------------


def deepfm_config(small=False):
    """DeepFMConfig.criteo() (bench.py on an accelerator), or bench.py's
    CPU config."""
    from paddle_tpu_torch.models import DeepFMConfig

    if small:
        return DeepFMConfig(vocab_size=1000, num_fields=6, embed_dim=8,
                            mlp_sizes=(16,), dense_dim=4)
    return DeepFMConfig.criteo()


def build_bench_deepfm(fluid, cfg, B, per_slot=False, fused=False,
                       hot_rows=None):
    """bench.py's deepfm program (feat, dense, label; deepfm with the
    dense input; Adam(1e-3)), in deepfm_fused's per-slot layout with
    per_slot, fused by embedding.fuse_lookups with fused, its tables
    cached by an EmbeddingEngine of `hot_rows` with hot_rows. Returns
    (main, startup, loss, params_grads, engine or None)."""
    from paddle_tpu_torch.embedding import EmbeddingEngine, fuse_lookups
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.optimizer import Adam

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    engine = None
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feat = fluid.data("feat", [B, cfg.num_fields], "int64")
        dense = fluid.data("dense", [B, cfg.dense_dim], "float32")
        label = fluid.data("label", [B, 1], "float32")
        loss, _ = deepfm(feat, label, cfg, dense_input=dense,
                         per_slot=per_slot)
        if fused:
            check(fuse_lookups(main) == 2, "fuse_lookups did not make 2 "
                  "fused sites")
        if hot_rows:
            engine = EmbeddingEngine(main, startup, hot_rows=hot_rows)
        _, pg = Adam(1e-3).minimize(loss, startup)
    return main, startup, loss, pg, engine


def deepfm_batches(cfg, B, n, rng, power=False):
    """bench.py's batches, drawn in its order: uniform ids (deepfm) or
    power-law ids, V * rng.power(0.35) (deepfm_fused), uniform dense
    features, labels 1 with probability 0.3."""
    out = []
    for _ in range(n):
        shape = (B, cfg.num_fields)
        ids = (cfg.vocab_size * rng.power(0.35, shape) if power
               else rng.randint(0, cfg.vocab_size, shape))
        out.append({"feat": ids.astype("int64"),
                    "dense": rng.rand(B, cfg.dense_dim).astype("float32"),
                    "label": (rng.rand(B, 1) < 0.3).astype("float32")})
    return out


def ctr_kind(op, aten, kernel):
    """The kind of a kernel of a DeepFM step, by the program op that
    launched it."""
    fwd = op.removeprefix("__vjp__(").rstrip(")")
    if fwd in LOOKUP_OPS:
        return ("lookups: unique (sort, cumsum, scatter), gathers"
                if op == fwd else
                "lookup replays and table gradients (index_add)")
    if op == "sum":
        return "gradient sums (the per-slot tables' [V, D] gradients)"
    if op == "adam":
        return "adam"
    if fwd == "mul":
        return "tower matmuls (cuBLAS) and their replays"
    return "elementwise, reductions, loss and other"


def lookup_ops(main):
    """(single lookups, fused lookups) of a program."""
    ops = main.global_block.ops
    return (sum(op.type == "distributed_lookup_table" for op in ops),
            sum(op.type == "fused_lookup_table" for op in ops))


def no_host_sync(stats, what):
    """No cudaStreamSynchronize inside the profiled step (the lookups'
    static unique and their replays read nothing back; a D2D copy is not
    a synchronisation)."""
    syncs = [k for k in stats["profile"]["syncs"]
             if k.startswith("cudaStreamSynchronize")]
    check(not syncs, f"{what}: host-device synchronisations {syncs}")


def ctr_train_small(fluid):
    """bench.py's deepfm program at its CPU config on the card and on the
    CPU from one state, plain and per-slot fused; then the cached and
    prefetched segment."""
    print("== CTR training, reduced size: bench.py's deepfm program at its "
          f"CPU config (DeepFMConfig(1000, 6, 8, (16,), 4)), B={CTR_SMALL_B},"
          " Adam(1e-3), fp32; card vs CPUPlace()")
    cfg, B = deepfm_config(small=True), CTR_SMALL_B
    rng = np.random.RandomState(0)
    main, startup, loss, pg, _ = build_bench_deepfm(fluid, cfg, B)
    card_vs_cpu(fluid, main, startup, loss, pg,
                deepfm_batches(cfg, B, 3, rng))
    print("-- deepfm_fused's per-slot layout, fused, power-law ids")
    main, startup, loss, pg, _ = build_bench_deepfm(fluid, cfg, B,
                                                    per_slot=True,
                                                    fused=True)
    check(lookup_ops(main) == (0, 2), f"lookups {lookup_ops(main)}")
    card_vs_cpu(fluid, main, startup, loss, pg,
                deepfm_batches(cfg, B, 3, rng, power=True))
    ctr_cached_small(fluid, cfg, B)


def ctr_cached_small(fluid, cfg, B, n=8):
    """deepfm_fused's cached segment at the CPU config, with a hot tier
    just above the largest batch's unique ids, so that rows are evicted
    and written back: Prefetcher over n feeds (bench's 4 power-law
    batches in turn), on the card and on the CPU from the card's startup
    state; the cold stores start from one numpy stream. Evictions on
    both, losses under FP32_TOL, residency (slot map, access counts)
    equal, every flushed host store's change and moment within
    CTR_STORE_L2."""
    from paddle_tpu_torch import convert, observability
    from paddle_tpu_torch.embedding import Prefetcher

    feeds = deepfm_batches(cfg, B, 4, np.random.RandomState(0), power=True)
    hot = max(np.unique(f["feat"]).size for f in feeds) + 8
    print(f"-- the cached segment: EmbeddingEngine(hot_rows={hot}) over "
          f"the [{cfg.vocab_size}, .] tables, Prefetcher over {n} feeds")
    runs, state, init, evicted = [], None, None, []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        main, startup, loss, _, engine = build_bench_deepfm(
            fluid, cfg, B, per_slot=True, fused=True, hot_rows=hot)
        exe, scope = fluid.Executor(place), fluid.Scope()
        if state is None:
            exe.run(startup, scope=scope)
            state = convert.state_to_numpy(scope)
        else:
            convert.state_from_numpy(state, scope, place, program=main)
        engine.attach(scope)
        if init is None:
            init = {k: v.copy() for g in engine.groups
                    for k, v in g.host.items()}
        observability.reset()
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0].reshape(-1)[0])
                  for f in Prefetcher(engine, [feeds[i % 4]
                                               for i in range(n)], scope)]
        counters = observability.get_counters()
        evicted.append((counters.get("embedding.cache_evictions", 0),
                        counters.get("embedding.cache_writebacks", 0)))
        runs.append((losses, engine.state_dict(scope)))
    check(all(e > 0 for e, _ in evicted) and evicted[0] == evicted[1],
          f"(evictions, write-backs) card, CPU: {evicted}")
    (gl, gs), (cl, cs) = runs
    rel = max(abs(g - c) / abs(c) for g, c in zip(gl, cl))
    check(rel <= FP32_TOL["loss"], f"cached losses {gl} vs CPU {cl}")
    worst = 0.0
    for key, c in cs.items():
        g = gs[key]
        if key.endswith(("::counts", "::row_of")):
            check(np.array_equal(g, c), f"{key} differs")
            continue
        start = init[key.split("::host::")[1]]
        err, ok = _held(g - start, c - start, ("l2", CTR_STORE_L2))
        worst = max(worst, err)
        check(ok, f"{key}: change differs by {err:.3e}")
    print(f"{n} cached steps: {evicted[0][0]} evictions and "
          f"{evicted[0][1]} rows written back on each; "
          f"losses {rel:.2e} relative (bound "
          f"{FP32_TOL['loss']:g}); {len(cs)} state entries, residency "
          f"equal, host stores' changes {worst:.2e} (relative L2, bound "
          f"{CTR_STORE_L2:g})")


def ctr_deepfm(fluid, kc):
    """bench.py's deepfm leg on an accelerator: DeepFMConfig.criteo(),
    B=4096, Adam(1e-3), fp32, uniform ids; run_steps with 3 warm-up and
    20 timed steps, one profiled (by ctr_kind), one timed by op type; no
    kernel of ours, no host-device synchronisation."""
    cfg, B = deepfm_config(), CTR_B
    print(f"== CTR training path: bench.py's deepfm leg at "
          f"DeepFMConfig.criteo() (V={cfg.vocab_size}, {cfg.num_fields} "
          f"sparse fields, D={cfg.embed_dim}, tower {cfg.mlp_sizes}, "
          f"{cfg.dense_dim} dense), B={B}, Adam(1e-3), fp32")
    t0 = time.perf_counter()
    main, startup, loss, pg, _ = build_bench_deepfm(fluid, cfg, B)
    ops = main.global_block.ops
    print(f"{len(ops)} ops: {lookup_ops(main)[0]} lookups, "
          f"{sum(op.type == '__vjp__' for op in ops)} __vjp__, "
          f"{sum(op.type == 'adam' for op in ops)} adam; {len(pg)} "
          f"parameters, {sum(math.prod(p.shape) for p, _ in pg) / 1e6:.2f}"
          f"M values; built in {time.perf_counter() - t0:.1f}s")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batches = on_card(deepfm_batches(cfg, B, 2, np.random.RandomState(0)))
    watch = ("deepfm_emb", "deepfm_emb_moment1_0", "deepfm_w1",
             "deepfm_mlp0_w", "deepfm_out_b")
    snap = {n: scope.find_var(n).clone() for n in watch}

    def after(i, values):
        if i < 2:  # the tables, their moments and the tower move
            moved = [n for n in watch
                     if not torch.equal(scope.find_var(n), snap[n])]
            check(len(moved) == len(watch), f"step {i} moved only {moved}")
            snap.update((n, scope.find_var(n).clone()) for n in watch)

    _, stats = run_steps(exe, main, scope, batches, [loss], ("loss",), kc,
                         dict.fromkeys(kc, 0), B, after, warm=CTR_WARM,
                         timed=CTR_TIMED, unit="examples", kind_of=ctr_kind)
    no_host_sync(stats, "deepfm")
    stats["ops"] = len(ops)
    print("deepfm training: " + json.dumps(stats))
    del exe, scope, batches, snap
    torch.cuda.empty_cache()
    return stats


def ctr_deepfm_fused(fluid, kc):
    """bench.py's deepfm_fused leg on an accelerator: the per-slot program
    unfused and fused in one call (examples/s each, power-law ids); the
    batches' dedup ratio; the cached and prefetched segment (hot_rows =
    max(B * F, V // 2), Prefetcher over 16 feeds): hot hit rate, prefetch
    overlap, write-backs; the leg's structural gates."""
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.embedding import Prefetcher

    cfg, B = deepfm_config(), CTR_B
    print(f"== CTR fused-embedding path: bench.py's deepfm_fused leg at "
          f"DeepFMConfig.criteo(), B={B}, per-slot layout, power-law ids "
          "(V * rng.power(0.35)), unfused and fused; the cached segment")
    host_batches = deepfm_batches(cfg, B, 4, np.random.RandomState(0),
                                  power=True)
    batches = on_card(host_batches)
    figures, sites = {}, {}
    for fused in (False, True):
        name = "fused" if fused else "unfused"
        main, startup, loss, pg, _ = build_bench_deepfm(
            fluid, cfg, B, per_slot=True, fused=fused)
        sites[name] = lookup_ops(main)
        ops = main.global_block.ops
        print(f"-- per-slot, {name}: {len(ops)} ops, lookups (single, "
              f"fused) {sites[name]}, {sum(op.type == '__vjp__' for op in ops)}"
              " __vjp__")
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        _, stats = run_steps(exe, main, scope, batches, [loss], ("loss",),
                             kc, dict.fromkeys(kc, 0), B, warm=CTR_WARM,
                             timed=CTR_TIMED, unit="examples",
                             kind_of=ctr_kind)
        no_host_sync(stats, f"deepfm_fused {name}")
        stats["ops"] = len(ops)
        figures[name] = stats
        del exe, scope
        torch.cuda.empty_cache()
    ratios = [np.unique(b["feat"]).size / b["feat"].size
              for b in host_batches]

    observability.reset()
    hot = max(B * cfg.num_fields, cfg.vocab_size // 2)
    main, startup, loss, _, engine = build_bench_deepfm(
        fluid, cfg, B, per_slot=True, fused=True, hot_rows=hot)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    t0 = time.perf_counter()
    engine.attach(scope)
    attach_s = time.perf_counter() - t0
    stream = [host_batches[i % 4] for i in range(CTR_FEEDS)]
    reset_counts(kc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                      return_numpy=False)[0]
              for f in Prefetcher(engine, stream, scope)]
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    counts = read_counts(kc)
    check(not any(counts.values()), f"a kernel of ours ran: {counts}")
    losses = [v.item() for v in losses]
    check(len(losses) == CTR_FEEDS and all(map(math.isfinite, losses)),
          f"cached losses {losses}")
    gauges = observability.get_gauges()
    hists = observability.get_histograms()
    counters = observability.get_counters()
    overlap = hists.get("embedding.prefetch_overlap", {})
    g = engine.groups[0]
    cached = dict(
        hot_rows=hot, vocab_rows=g.vocab, attach_s=attach_s,
        examples_per_s=CTR_FEEDS * B / cached_s, steps=CTR_FEEDS,
        hot_hit_rate=gauges.get(f"embedding.hot_hit_rate.{g.name}"),
        prefetch_overlap_mean=(overlap["sum"] / overlap["count"]
                               if overlap.get("count") else None),
        host_bytes=g.host_bytes(), device_bytes=g.device_bytes(),
        final_loss=losses[-1], **{k.removeprefix("embedding."): v
                                  for k, v in counters.items()
                                  if k.startswith("embedding.")})
    gates = {
        "one_fused_gather_per_width": sites["fused"][1] == 2
        and sites["fused"][0] <= 1,
        "lookup_sites_before": sum(sites["unfused"]),
        "lookup_sites_after": sum(sites["fused"]),
        "dedup_active": all(r < 1.0 for r in ratios),
        "dedup_unique_ratio": float(np.mean(ratios)),
        "prefetch_overlap_recorded": bool(overlap.get("count")),
    }
    ex = {k: figures[k]["examples_per_s"] for k in figures}
    print(f"examples/s: per-slot unfused {ex['unfused']:.0f}, fused "
          f"{ex['fused']:.0f} ({ex['fused'] / ex['unfused']:.2f}x); dedup "
          f"unique ratio {gates['dedup_unique_ratio']:.4f}; cached: "
          f"{cached['examples_per_s']:.0f} examples/s over {CTR_FEEDS} "
          f"steps, hot hit rate {cached['hot_hit_rate']}, prefetch overlap "
          f"{cached['prefetch_overlap_mean']}, write-backs "
          f"{cached.get('cache_writebacks', 0)}, attach {attach_s:.1f}s")
    check(gates["one_fused_gather_per_width"] and gates["dedup_active"]
          and gates["prefetch_overlap_recorded"],
          f"deepfm_fused structural gates failed: {gates}")
    print("deepfm_fused: " + json.dumps(dict(gates=gates, cached=cached,
                                             **figures)))
    del exe, scope, batches, engine
    torch.cuda.empty_cache()


def build_ctr_ranker(fluid):
    """bench_serving.py's ctr_rank ranker: DeepFMConfig(4096, 13, 16, (64,
    32)) over [-1, 13] ids, per_slot, fused (2 sites), Adam(1e-3)
    minimize appended, frozen to the probabilities. Returns (cfg,
    startup, frozen)."""
    from paddle_tpu_torch.embedding import fuse_lookups
    from paddle_tpu_torch.models import DeepFMConfig, deepfm
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.serving import freeze_program

    cfg = DeepFMConfig(vocab_size=4096, num_fields=13, embed_dim=16,
                       mlp_sizes=(64, 32))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 13
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("feat_ids", [-1, cfg.num_fields], "int64")
        label = fluid.data("label", [-1, 1], "float32")
        loss, prob = deepfm(ids, label, cfg, per_slot=True)
        fused = fuse_lookups(main)
        Adam(1e-3).minimize(loss, startup)
    check(fused == 2, f"expected 2 fused lookup sites, got {fused}")
    return cfg, startup, freeze_program(main, [prob],
                                        feed_names=("feat_ids",))


def closed_loop(srv, name, samples, clients, seconds):
    """bench_serving's _closed_loop: `clients` threads each submit one
    request and wait for it, until `seconds` pass. Returns (requests/s,
    p50 ms, p99 ms, requests)."""
    import threading

    lats, lock = [], threading.Lock()
    stop = time.perf_counter() + seconds

    def client(k):
        i = k
        while time.perf_counter() < stop:
            t0 = time.perf_counter()
            srv.submit(name, samples[i % len(samples)]).result(timeout=60)
            with lock:
                lats.append((time.perf_counter() - t0) * 1e3)
            i += clients

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lats.sort()
    return (len(lats) / wall, lats[len(lats) // 2],
            lats[min(len(lats) - 1, int(0.99 * len(lats)))], len(lats))


def ctr_rank_serving(fluid, kc):
    """bench_serving's ctr_rank: the frozen ranker behind serving.Server
    at buckets (1, 2, 4, 8), max_wait_ms 4: answers against a direct run
    on the card and the port's CPU run, no kernel of ours launched; the
    closed loop of 8 clients (requests/s, p50, p99, the buckets run);
    then requests/s, p50 and p99 at each bucket."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.serving import EndpointConfig, Server

    print("== CTR serving path: bench_serving's ctr_rank ranker "
          "(DeepFMConfig(4096, 13, 16, (64, 32)), per-slot, fused) frozen, "
          f"serving.Server at buckets {CTR_BUCKETS}, max_wait_ms 4")
    cfg, startup, frozen = build_ctr_ranker(fluid)
    ops = frozen.program.global_block.ops
    check(lookup_ops(frozen.program) == (0, 2),
          f"frozen lookups {lookup_ops(frozen.program)}")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    groups = (1, 3, 8, 2, 5, 4, 8, 1)
    samples = [{"feat_ids": (cfg.vocab_size * rng.power(
        0.35, cfg.num_fields)).astype(np.int64)} for _ in range(sum(groups))]
    srv = Server()
    try:
        ep = srv.add_endpoint(
            "ctr_rank", frozen=frozen, executor=exe, scope=scope,
            config=EndpointConfig(buckets=CTR_BUCKETS, max_wait_ms=4.0,
                                  max_queue=4096))
        srv.warmup()
        torch.cuda.synchronize()
        reset_counts(kc)
        served, i = [], 0
        for g in groups:
            futs = [srv.submit("ctr_rank", samples[j])
                    for j in range(i, i + g)]
            served += [f.result(timeout=300)[0] for f in futs]
            i += g
        counts = read_counts(kc)
        first = len(ep.batches)
        rps, p50, p99, n = closed_loop(srv, "ctr_rank", samples,
                                       CTR_CLIENTS, CTR_LOOP_S)
        buckets = {}
        for bucket, _ in list(ep.batches)[first:]:
            buckets[bucket] = buckets.get(bucket, 0) + 1
    finally:
        check(srv.close(timeout=300), "server did not drain")
    served = np.stack(served)
    check(not any(counts.values()), f"a kernel of ours ran: {counts}")
    check(served.shape == (len(samples), 1) and np.isfinite(served).all(),
          f"served probabilities: shape {served.shape} or not finite")
    direct = np.concatenate([
        exe.run(frozen.program, feed={"feat_ids": s["feat_ids"][None]},
                fetch_list=list(frozen.fetch_names), scope=scope)[0]
        for s in samples])
    d_err = float(np.abs(served - direct).max())
    cpu_scope = fluid.Scope()
    convert.state_from_numpy(convert.state_to_numpy(scope), cpu_scope,
                             fluid.CPUPlace())
    cpu, = fluid.Executor(fluid.CPUPlace()).run(
        frozen.program, feed={"feat_ids": np.stack(
            [s["feat_ids"] for s in samples])},
        fetch_list=list(frozen.fetch_names), scope=cpu_scope)
    c_err = float(np.abs(served - cpu).max())
    print(f"{len(ops)} frozen ops; served {len(served)} requests; vs a "
          f"direct run on the card, one request each: max_abs_err="
          f"{d_err:.3e}; vs the port on CPUPlace(): max_abs_err={c_err:.3e}"
          f" (tol {CTR_PROB_ATOL:g})")
    check(d_err <= CTR_PROB_ATOL, f"served and direct answers differ: "
          f"{d_err}")
    check(c_err <= CTR_PROB_ATOL, f"card and CPU answers differ: {c_err}")
    check(np.ptp(served) > 1e-4, "every request got the same answer")
    loop = dict(clients=CTR_CLIENTS, seconds=CTR_LOOP_S, requests=n,
                rps=rps, p50_ms=p50, p99_ms=p99,
                batches_by_bucket=buckets)
    print(f"closed loop of {CTR_CLIENTS} clients, {CTR_LOOP_S:g} s: {n} "
          f"requests, {rps:.1f} requests/s, p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; batches by bucket {buckets}")
    per_bucket = serve_times(frozen, exe, scope, samples, CTR_BUCKETS,
                             "ctr_rank", window=CTR_WINDOW)
    print("ctr_rank: " + json.dumps(dict(
        ops=len(ops), direct_err=d_err, cpu_err=c_err, closed_loop=loop,
        buckets={str(b): v for b, v in per_bucket.items()})))
    del exe, scope
    torch.cuda.empty_cache()


def ctr_path(fluid, kc):
    """The CTR phases in order; prints the section's time."""
    t0 = time.perf_counter()
    ctr_train_small(fluid)
    ctr_deepfm(fluid, kc)
    ctr_deepfm_fused(fluid, kc)
    ctr_rank_serving(fluid, kc)
    print(f"CTR section: {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Mask R-CNN: bench.py's mask_rcnn leg (the batched program, and its
# legacy per-image program) and mask_rcnn_infer behind the predictor
# ---------------------------------------------------------------------------


def mask_rcnn_config(small=False):
    """bench.py's MaskRCNNConfig on an accelerator (MRCNN_ACCEL), or its
    CPU config, MaskRCNNConfig.tiny()."""
    from paddle_tpu_torch.models import MaskRCNNConfig

    return MaskRCNNConfig.tiny() if small else MaskRCNNConfig(**MRCNN_ACCEL)


def build_bench_mask_rcnn(fluid, cfg, B, size, n_gt, amp=False):
    """bench.py's bench_mask_rcnn program: mask_rcnn_train_batched over
    [B, 3, size, size] with n_gt boxes an image, Momentum(0.002, 0.9),
    under AMP with dynamic loss scaling as bench.py on an accelerator.
    Returns (main, startup, losses, rois_num, params_grads, optimizer,
    forward ops)."""
    from paddle_tpu_torch.models import mask_rcnn_train_batched
    from paddle_tpu_torch.optimizer import Momentum

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        images = fluid.data("images", [B, 3, size, size])
        gt_boxes = fluid.data("gt_boxes", [B, n_gt, 4])
        gt_classes = fluid.data("gt_classes", [B, n_gt], dtype="int32")
        is_crowd = fluid.data("is_crowd", [B, n_gt], dtype="int32")
        gt_segms = fluid.data("gt_segms", [B, n_gt, size, size])
        im_info = fluid.data("im_info", [B, 3])
        losses, aux = mask_rcnn_train_batched(
            images, gt_boxes, gt_classes, is_crowd, gt_segms, im_info, cfg)
        fwd_ops = len(main.global_block.ops)
        opt = mask_rcnn_opt(fluid, amp)
        _, pg = opt.minimize(losses[0], startup)
    return main, startup, losses, aux["rois_num"], pg, opt, fwd_ops


def mask_rcnn_opt(fluid, amp):
    """Momentum(0.002, 0.9), under bench.py's AMP for its mask_rcnn leg
    (bf16, softmax and layer_norm white-listed, dynamic loss scaling from
    2^12)."""
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(MRCNN_LR, 0.9)
    if amp:
        opt = mp.decorate(
            opt, amp_lists=mp.AutoMixedPrecisionLists(
                custom_white_list={"softmax", "layer_norm"}),
            use_dynamic_loss_scaling=True, init_loss_scaling=2.0 ** 12,
            dest_dtype="bfloat16")
    return opt


def build_legacy_mask_rcnn(fluid, cfg, n_img, size, n_gt, amp=False,
                           train=True):
    """bench.py's bench_mask_rcnn_legacy program: n_img one-image
    mask_rcnn_train graphs unrolled into one program, their total losses
    averaged; train=False builds the forward alone. Returns (main,
    startup, loss, every image's six losses, params_grads, optimizer)."""
    from paddle_tpu_torch.models import mask_rcnn_train

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        per = []
        for i in range(n_img):
            per.append(mask_rcnn_train(
                fluid.data(f"image{i}", [1, 3, size, size]),
                fluid.data(f"gt_boxes{i}", [n_gt, 4]),
                fluid.data(f"gt_classes{i}", [n_gt], dtype="int32"),
                fluid.data(f"is_crowd{i}", [n_gt], dtype="int32"),
                fluid.data(f"gt_segms{i}", [n_gt, size, size]),
                fluid.data(f"im_info{i}", [1, 3]), cfg))
        loss = per[0][0]
        for losses in per[1:]:
            loss = fluid.layers.elementwise_add(loss, losses[0])
        if n_img > 1:
            loss = fluid.layers.scale(loss, scale=1.0 / n_img)
        opt, pg = mask_rcnn_opt(fluid, amp), []
        if train:
            _, pg = opt.minimize(loss, startup)
    return main, startup, loss, [v for losses in per for v in losses], pg, \
        opt


def mask_rcnn_batch(B, size, n_gt, class_num, seed=0):
    """bench_mask_rcnn's feed: boxes rand * size / 2 with 8 + half their
    w, h added, uniform images, int32 classes, no crowd, random bitmaps,
    drawn in bench's order."""
    rng = np.random.RandomState(seed)
    boxes = rng.rand(B, n_gt, 4).astype("float32") * (size / 2)
    boxes[..., 2:] = boxes[..., :2] + 8 + boxes[..., 2:] / 2
    return {
        "images": rng.rand(B, 3, size, size).astype("float32"),
        "gt_boxes": boxes,
        "gt_classes": rng.randint(1, class_num, (B, n_gt)).astype("int32"),
        "is_crowd": np.zeros((B, n_gt), "int32"),
        "gt_segms": (rng.rand(B, n_gt, size, size) > 0.5).astype("float32"),
        "im_info": np.tile([[size, size, 1.0]], (B, 1)).astype("float32"),
    }


def legacy_batch(n_img, size, n_gt, class_num, seed=0):
    """bench_mask_rcnn_legacy's feed, image by image in bench's order."""
    rng = np.random.RandomState(seed)
    feed = {}
    for i in range(n_img):
        boxes = rng.rand(n_gt, 4).astype("float32") * (size / 2)
        boxes[:, 2:] = boxes[:, :2] + 8 + boxes[:, 2:] / 2
        feed.update({
            f"image{i}": rng.rand(1, 3, size, size).astype("float32"),
            f"gt_boxes{i}": boxes,
            f"gt_classes{i}": rng.randint(1, class_num, n_gt).astype(
                "int32"),
            f"is_crowd{i}": np.zeros(n_gt, "int32"),
            f"gt_segms{i}": (rng.rand(n_gt, size, size) > 0.5).astype(
                "float32"),
            f"im_info{i}": np.array([[size, size, 1.0]], "float32"),
        })
    return feed


def _decode_np(scores, deltas, im_info, anchors, variances):
    """generate_proposals' decode, clip and size filter in float64: (the
    scores with the filtered at -inf [N, M], the boxes [N, M, 4])."""
    N, A, H, W = scores.shape
    sc = scores.transpose(0, 2, 3, 1).reshape(N, -1).astype(np.float64)
    dl = deltas.reshape(N, A, 4, H, W).transpose(0, 3, 4, 1, 2).reshape(
        N, -1, 4)
    an = anchors.reshape(-1, 4).astype(np.float64)
    va = variances.reshape(-1, 4)
    aw, ah = an[:, 2] - an[:, 0] + 1, an[:, 3] - an[:, 1] + 1
    cx = va[:, 0] * dl[..., 0] * aw + an[:, 0] + aw / 2
    cy = va[:, 1] * dl[..., 1] * ah + an[:, 1] + ah / 2
    w = np.exp(np.minimum(va[:, 2] * dl[..., 2], 10)) * aw
    h = np.exp(np.minimum(va[:, 3] * dl[..., 3], 10)) * ah
    imh, imw = im_info[:, 0:1], im_info[:, 1:2]
    box = np.stack([np.clip(cx - w / 2, 0, imw - 1),
                    np.clip(cy - h / 2, 0, imh - 1),
                    np.clip(cx + w / 2 - 1, 0, imw - 1),
                    np.clip(cy + h / 2 - 1, 0, imh - 1)], -1)
    keep = (box[..., 2] >= box[..., 0]) & (box[..., 3] >= box[..., 1])
    return np.where(keep, sc, -np.inf), box


def _iou_np(a, b):
    area = (lambda x: np.maximum(x[..., 2] - x[..., 0], 0)
            * np.maximum(x[..., 3] - x[..., 1], 0))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.maximum(rb - lt, 0), -1)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def mask_rcnn_guard(main):
    """(names, fn) of the near-tie guard of a Mask R-CNN training program
    (batched or legacy): fn(want, got), the values of `names` by name in
    the reference run and in the run held to it, finds the reference
    step's decisions nearest to their thresholds and requires each to lie
    further from it than the other run could move it: a score order by
    more than twice the largest difference of the two runs' RPN scores
    (if the scores differ at all), an IoU, level or pixel decision by
    MRCNN_MARGIN. The decisions: each level's top pre_nms_topN scores
    (the gap at the cut), its greedy NMS (IoUs about nms_thresh, the
    score order of each suppressing pair, the gap at the post_nms_topN-th
    survivor), collect's order of the survivors, the proposals' best IoU
    about fg_thresh, the sampled rois' FPN levels and the fg rois' mask
    grid about a pixel's half. Returns the nearest of each kind."""
    ops = main.global_block.ops
    gps = [op for op in ops if op.type == "generate_proposals"]
    gpls = [op for op in ops if op.type == "generate_proposal_labels"]
    cols = {op.outputs["FpnRois"][0]: op for op in ops
            if op.type == "collect_fpn_proposals"}
    gmls = [op for op in ops if op.type == "generate_mask_labels"]
    names = []
    for op in gps:
        names += [op.inputs[s][0] for s in ("Scores", "BboxDeltas",
                                            "ImInfo", "Anchors",
                                            "Variances")]
    for op, mop in zip(gpls, gmls):
        col = cols[op.inputs["RpnRois"][0]]
        names += [op.inputs["RpnRois"][0], op.inputs["GtBoxes"][0],
                  op.outputs["Rois"][0], mop.outputs["MaskRois"][0]]
        names += col.inputs["MultiLevelScores"]
        names += col.inputs["MultiLevelRoIsNum"]
    names = list(dict.fromkeys(names))

    def fn(v, other):
        near = dict(score=np.inf, iou=np.inf, level=np.inf, pixel=np.inf)
        drift = max(float(np.abs(v[n].astype(np.float64) - other[n]).max())
                    for op in gps for n in op.inputs["Scores"])
        margin = dict(MRCNN_MARGIN, score=2 * drift)

        def low(kind, x):
            near[kind] = min(near[kind], float(x))

        for op in gps:
            sc, box = _decode_np(*(v[op.inputs[s][0]] for s in (
                "Scores", "BboxDeltas", "ImInfo", "Anchors", "Variances")))
            pre, post = op.attr("pre_nms_topN"), op.attr("post_nms_topN")
            thresh = op.attr("nms_thresh")
            for s, b in zip(sc, box):
                order = np.argsort(-s, kind="stable")
                k = min(pre, len(s))
                s, b = s[order], b[order]
                if k < len(s) and np.isfinite(s[k]):
                    low("score", s[k - 1] - s[k])
                s, b = s[:k], b[:k]
                live = np.isfinite(s)
                iou = _iou_np(b, b)
                pair = np.triu(live[:, None] & live[None, :], 1)
                low("iou", np.abs(iou - thresh)[pair].min(initial=np.inf))
                sup = pair & (iou > thresh)
                gap = (s[:, None] - s[None, :])[sup]
                low("score", gap.min(initial=np.inf))
                alive = np.zeros(k, bool)
                for i in range(k):
                    alive[i] = live[i] and not (alive & sup[:, i]).any()
                kept = s[alive]
                if len(kept) > post:
                    low("score", kept[post - 1] - kept[post])
        for op, mop in zip(gpls, gmls):
            col = cols[op.inputs["RpnRois"][0]]
            topn = col.attr("post_nms_topN")
            lv = [v[n] for n in col.inputs["MultiLevelScores"]]
            nums = [v[n] for n in col.inputs["MultiLevelRoIsNum"]]
            rois, gt = v[op.inputs["RpnRois"][0]], v[op.inputs["GtBoxes"][0]]
            n_img = gt.shape[0] if gt.ndim == 3 else 1
            rois, gt = rois.reshape(n_img, -1, 4), gt.reshape(n_img, -1, 4)
            out = v[op.outputs["Rois"][0]].reshape(n_img, -1, 4)
            mrois = v[mop.outputs["MaskRois"][0]].reshape(n_img, -1, 4)
            M = mop.attr("resolution")
            for i in range(n_img):
                s = np.concatenate([
                    l.reshape(n_img, -1)[i][:int(c.reshape(-1)[i])]
                    for l, c in zip(lv, nums)]).astype(np.float64)
                s = np.sort(s)[::-1][:topn + 1]
                if len(s) > 1:
                    low("score", np.diff(-s).min())
                g = gt[i][gt[i][:, 2] > gt[i][:, 0]]
                cand = np.concatenate([rois[i][rois[i][:, 2] > rois[i][:, 0]],
                                       g])
                if len(g):
                    best = _iou_np(cand, g).max(1)
                    low("iou", np.abs(best - op.attr("fg_thresh")).min())
                r = out[i][(out[i][:, 2] > out[i][:, 0])
                           & (out[i][:, 3] > out[i][:, 1])]
                lvl = 4 + np.log2(np.sqrt((r[:, 2] - r[:, 0])
                                          * (r[:, 3] - r[:, 1])) / 224
                                  + 1e-6)
                if len(r):
                    low("level", np.abs(lvl[:, None] - [3, 4, 5]).min())
                m = mrois[i][mrois[i][:, 2] > mrois[i][:, 0]]
                grid = (np.arange(M) + 0.5) / M
                for a, c in ((0, 2), (1, 3)):
                    p = m[:, a:a + 1] + (m[:, c:c + 1] - m[:, a:a + 1]) * grid
                    if p.size:
                        low("pixel", np.abs(p - np.floor(p) - 0.5).min())
        for kind, gap in near.items():
            check(gap > margin[kind] or kind == "score" and drift == 0,
                  f"near-tie guard: a {kind} decision {gap:.3g} from its "
                  f"threshold (margin {margin[kind]:.3g})")
        print("near-tie guard, the decisions nearest their thresholds: "
              + ", ".join(f"{k} {g:.3g} (margin {margin[k]:.3g})"
                          for k, g in near.items()))
        return near

    return names, fn


def mask_rcnn_train_small(fluid, kc):
    """bench.py's mask_rcnn leg at its CPU config on the card and on the
    CPU from one state, one Momentum step, the batched program and the
    legacy one: the six losses, rois_num and labels, gradients and the
    state after, behind the near-tie guard; no kernel of ours."""
    reset_counts(kc)
    print("== Mask R-CNN training, reduced size: bench.py's mask_rcnn "
          "program at MaskRCNNConfig.tiny(), 3x64x64, B=2, 2 boxes, "
          f"Momentum({MRCNN_LR:g}, 0.9), fp32; card vs CPUPlace()")
    cfg = mask_rcnn_config(small=True)
    main, startup, losses, rois_num, pg, _, _ = build_bench_mask_rcnn(
        fluid, cfg, 2, 64, 2)
    labels = next(op.outputs["LabelsInt32"][0] for op in
                  main.global_block.ops
                  if op.type == "generate_proposal_labels")
    guarded(lambda seed: card_vs_cpu(
        fluid, main, startup, losses[0], pg,
        [mask_rcnn_batch(2, 64, 2, cfg.class_num, seed)], MRCNN_TOL,
        extra=(rois_num, main.global_block.var(labels)), close=losses[1:],
        guard=mask_rcnn_guard(main)))
    print("-- the legacy per-image program (PADDLE_TPU_BATCHED_DETECTION=0)"
          " at bench's CPU config: 1 image")
    main, startup, loss, per, pg, _ = build_legacy_mask_rcnn(
        fluid, cfg, 1, 64, 2)
    guarded(lambda seed: card_vs_cpu(
        fluid, main, startup, loss, pg,
        [legacy_batch(1, 64, 2, cfg.class_num, seed)], MRCNN_TOL,
        close=per[1:], guard=mask_rcnn_guard(main)))
    counts = read_counts(kc)
    check(not any(counts.values()), f"a kernel of ours ran: {counts}")


def guarded(run):
    """run(seed) with bench's feed seed 0, and while the near-tie guard
    refuses a seed's decisions, with the next, up to MRCNN_SEEDS (the
    card draws the startup state from its own generator, so which feeds
    give well-separated decisions is known only there)."""
    for seed in range(MRCNN_SEEDS):
        try:
            run(seed)
            print(f"feed seed {seed} ({seed} refused by the guard)")
            return
        except SmokeFailure as e:
            if "near-tie guard" not in str(e) or seed + 1 == MRCNN_SEEDS:
                raise
            print(f"feed seed {seed}: {e}")


def mask_rcnn_kind(op, aten, kernel):
    """The kind of a kernel of a Mask R-CNN step, by the program op that
    launched it."""
    fwd = op.removeprefix("__vjp__(").rstrip(")")
    if fwd == "roi_align":
        return ("roi_align: corner gathers" if op == fwd else
                "roi_align backward: index_add into the maps")
    if fwd in ("conv2d", "conv2d_transpose"):
        return "convolutions (cuDNN) and their replays"
    if fwd == "batch_norm":
        return "batch_norm and its replay"
    if fwd == "generate_proposals":
        return "generate_proposals (decode, sort, greedy NMS)"
    if fwd in ("rpn_target_assign", "generate_proposal_labels",
               "generate_mask_labels", "distribute_fpn_proposals",
               "collect_fpn_proposals", "anchor_generator"):
        return "target assignment, labels, FPN routing"
    if fwd == "cast":
        return "casts"
    if fwd in ("momentum", "check_finite_and_unscale",
               "update_loss_scaling"):
        return "momentum and loss scaling"
    return "elementwise, reductions, losses and other"


def mask_rcnn_step_dtypes(exe, main, scope, feed):
    """One more step fetching the detection ops' outputs as tensors: each
    runtime dtype is the program's declared one, roi_align reads and gives
    bf16 under AMP, the proposals' boxes are fp32 and their counts and
    the labels int32."""
    slots = {"roi_align": ("X", "Out"),
             "generate_proposals": ("RpnRois", "RpnRoiProbs", "RpnRoisNum"),
             "generate_proposal_labels": ("Rois", "LabelsInt32", "RoisNum"),
             "rpn_target_assign": ("ScoreIndex", "TargetBBox")}
    blk = main.global_block
    where = {}
    for op in blk.ops:
        for slot in slots.get(op.type, ()):
            n = (op.inputs.get(slot) or op.outputs[slot])[0]
            where.setdefault(n, f"{op.type}.{slot}")
    names = list(where)
    outs = exe.run(main, feed=feed, fetch_list=names, scope=scope,
                   return_numpy=False)
    got = {}
    for n, t in zip(names, outs):
        want = blk.var(n).dtype
        have = str(t.dtype).removeprefix("torch.")
        check(have == want or ("int" in want and have == "int32"),
              f"{n}: runs as {have}, declared {want}")
        got.setdefault(where[n], set()).add(have)
    check(got["roi_align.X"] == {"bfloat16"},
          f"roi_align reads {got['roi_align.X']}")
    print(f"runtime dtypes as declared ({len(names)} tensors): "
          + ", ".join(f"{k} {'/'.join(sorted(v))}"
                      for k, v in sorted(got.items())))
    return len(names)


def mask_rcnn_train_full(fluid, kc):
    """bench_mask_rcnn on an accelerator: MRCNN_ACCEL, B=8, 256x256, 8
    boxes an image, Momentum(0.002, 0.9) under AMP with dynamic loss
    scaling; bench's padding waste from record_roi_stats, the detection.*
    counters of the first run and unroll_proxy's op counts; run_steps (3
    warm-up and 5 timed steps, one profiled, one timed by op type); the
    loss scale and step counters, weights moved, no kernel of ours, no
    host-device synchronisation in the step."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops.detection_stats import record_roi_stats

    B, size, n_gt = MRCNN_FULL
    cfg = mask_rcnn_config()
    print(f"== Mask R-CNN training path: bench_mask_rcnn at MaskRCNNConfig("
          f"{', '.join(f'{k}={v}' for k, v in MRCNN_ACCEL.items())}), B={B},"
          f" 3x{size}x{size}, {n_gt} boxes, Momentum({MRCNN_LR:g}, 0.9), AMP"
          " (bf16, dynamic loss scaling from 2^12)")
    t0 = time.perf_counter()
    main, startup, losses, rois_num, pg, opt, fwd_ops = \
        build_bench_mask_rcnn(fluid, cfg, B, size, n_gt, amp=True)
    legacy = build_legacy_mask_rcnn(fluid, cfg, 1, size, n_gt,
                                    train=False)[0]
    ops = main.global_block.ops
    proxy = dict(programs_per_step=1, images_per_program=B,
                 batched_op_count=len(ops), batched_fwd_ops=fwd_ops,
                 legacy_fwd_ops_per_image=len(legacy.global_block.ops),
                 legacy_fwd_ops_if_unrolled=len(legacy.global_block.ops) * B)
    print(f"{len(ops)} ops of {len({op.type for op in ops})} types, "
          f"{sum(op.type == 'cast' for op in ops)} casts, {len(pg)} "
          f"parameters; unroll_proxy {proxy}; built in "
          f"{time.perf_counter() - t0:.1f}s")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batches = on_card([mask_rcnn_batch(B, size, n_gt, cfg.class_num)])
    before = {k: v for k, v in metrics.get_counters().items()
              if k.startswith("detection.")}
    first, live = exe.run(main, feed=batches[0],
                          fetch_list=[losses[0], rois_num], scope=scope)
    waste = record_roi_stats(live, cfg.batch_size_per_im)
    tally = {k: v - before.get(k, 0) for k, v in
             metrics.get_counters().items()
             if k.startswith("detection.") and v != before.get(k, 0)}
    print(f"first step: loss {first}, rois_num {live.tolist()}, padding "
          f"waste {waste:.3f}; detection counters {tally}")
    check(tally.get("detection.roi_align.batched_instantiations") == 8
          and tally.get("detection.generate_proposals"
                        ".batched_instantiations") == 4,
          f"detection counters {tally}")
    watch = [p.name for p, _ in pg[:2] + pg[-2:]]
    snap = {n: scope.find_var(n).clone() for n in watch}

    def after(i, values):
        if i < 2:  # the first and the last layers' weights move
            moved = [n for n in watch
                     if not torch.equal(scope.find_var(n), snap[n])]
            check(len(moved) == len(watch), f"step {i} moved only {moved}")
            snap.update((n, scope.find_var(n).clone()) for n in watch)

    _, stats = run_steps(exe, main, scope, batches, [losses[0]], ("loss",),
                         kc, dict.fromkeys(kc, 0), B, after,
                         warm=MRCNN_WARM, timed=MRCNN_TIMED, unit="images",
                         kind_of=mask_rcnn_kind)
    no_host_sync(stats, "mask_rcnn")
    state = opt.state_dict(scope)
    steps = 1 + stats["steps"]
    check(state == {"loss_scaling": 2.0 ** 12, "good_steps": steps,
                    "bad_steps": 0}, f"loss-scale state {state}")
    n_dt = mask_rcnn_step_dtypes(exe, main, scope, batches[0])
    counts = read_counts(kc)
    check(not any(counts.values()), f"a kernel of ours ran: {counts}")
    stats.update(ops=len(ops), casts=sum(op.type == "cast" for op in ops),
                 padding_waste=waste, detection_counters=tally,
                 unroll_proxy=proxy, loss_scale=state, dtypes_checked=n_dt)
    print("mask_rcnn amp training: " + json.dumps(stats))
    del exe, scope, batches, snap
    torch.cuda.empty_cache()
    return stats


def mask_rcnn_legacy_full(fluid, kc):
    """bench_mask_rcnn_legacy on an accelerator: four one-image graphs
    unrolled into one program at MRCNN_ACCEL, 256x256, 8 boxes, under AMP
    with dynamic loss scaling; 1 warm-up and 3 timed steps, one profiled,
    one timed by op type. tools/torch_phases.py runs it; chip_smoke.py
    does not (its time)."""
    n_img, (_, size, n_gt) = 4, MRCNN_FULL
    cfg = mask_rcnn_config()
    print(f"== Mask R-CNN legacy leg: {n_img} one-image graphs unrolled, "
          f"3x{size}x{size}, {n_gt} boxes, AMP")
    t0 = time.perf_counter()
    main, startup, loss, _, pg, opt = build_legacy_mask_rcnn(
        fluid, cfg, n_img, size, n_gt, amp=True)
    ops = main.global_block.ops
    print(f"{len(ops)} ops, {sum(op.type == 'cast' for op in ops)} casts; "
          f"built in {time.perf_counter() - t0:.1f}s")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batches = on_card([legacy_batch(n_img, size, n_gt, cfg.class_num)])
    _, stats = run_steps(exe, main, scope, batches, [loss], ("loss",), kc,
                         dict.fromkeys(kc, 0), n_img, warm=1, timed=3,
                         unit="images", kind_of=mask_rcnn_kind)
    no_host_sync(stats, "mask_rcnn legacy")
    counts = read_counts(kc)
    check(not any(counts.values()), f"a kernel of ours ran: {counts}")
    stats.update(ops=len(ops), loss_scale=opt.state_dict(scope))
    print("mask_rcnn legacy amp training: " + json.dumps(stats))
    del exe, scope, batches
    torch.cuda.empty_cache()
    return stats


def mask_rcnn_predictor(fluid, kc):
    """mask_rcnn_infer at MRCNN_ACCEL's width, 3x256x256, batch 1 (its
    graph flattens the rois over the batch), fp32, test mode, random
    weights from the seed: io.save_inference_model and
    inference.create_paddle_predictor; the detections and mask logits
    against a direct run on the card and the port's CPU run (labels and
    counts equal, near-tie rows as a set: hold_detections); ms a batch."""
    import shutil
    import tempfile

    from paddle_tpu_torch import convert, inference, io
    from paddle_tpu_torch.models import mask_rcnn_infer

    size = MRCNN_FULL[1]
    print(f"== Mask R-CNN predictor: mask_rcnn_infer at MaskRCNNConfig("
          f"class_num=81, scale=0.5, depth=50), 3x{size}x{size}, batch 1, "
          "fp32, io.save_inference_model, create_paddle_predictor")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.data("image", [1, 3, size, size])
        im_info = fluid.data("im_info", [1, 3])
        out, mlogits = mask_rcnn_infer(image, im_info, mask_rcnn_config())
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    feed = {"image": rng.rand(1, 3, size, size).astype(np.float32),
            "im_info": np.array([[size, size, 1.0]], np.float32)}
    tmp = tempfile.mkdtemp(prefix="mask_rcnn_model_")
    try:
        with fluid.scope_guard(scope):
            io.save_inference_model(tmp, ["image", "im_info"],
                                    [out, mlogits], exe, main)
        pred = inference.create_paddle_predictor(
            inference.AnalysisConfig(tmp))
        ops = pred.program.global_block.ops
        reset_counts(kc)
        got, masks = (t.as_ndarray() for t in pred.run(
            [feed["image"], feed["im_info"]]))
        n = int((got[0, :, 0] >= 0).sum())
        check(np.isfinite(got).all() and np.isfinite(masks).all() and n > 0,
              f"detections {n}, finite {np.isfinite(got).all()}")
        d_out, d_masks = pred.executor.run(
            pred.program, feed=feed, fetch_list=pred.get_output_names(),
            scope=pred.scope)
        tied, s_err, b_err = hold_detections(got, d_out, [n],
                                             "predictor vs direct")
        check(np.array_equal(masks, d_masks), "mask logits differ from a "
              "direct run's")
        counts = read_counts(kc)
        check(not any(counts.values()), f"a kernel of ours ran: {counts}")
        cpu_scope = fluid.Scope()
        convert.state_from_numpy(convert.state_to_numpy(pred.scope),
                                 cpu_scope, fluid.CPUPlace())
        t0 = time.perf_counter()
        c_out, c_masks = fluid.Executor(fluid.CPUPlace()).run(
            pred.program, feed=feed, fetch_list=pred.get_output_names(),
            scope=cpu_scope)
        cpu_s = time.perf_counter() - t0
        c_n = int((c_out[0, :, 0] >= 0).sum())
        check(c_n == n, f"{n} detections vs CPU {c_n}")
        tied, s_err, b_err = hold_detections(got, c_out, [n], "vs CPU")
        print(f"{len(ops)} predictor ops; {n} detections of {got.shape[1]}; "
              f"vs the port on CPUPlace() ({cpu_s:.1f}s): scores "
              f"{s_err:.2e}, boxes {b_err:.2e}, {tied} valid rows in "
              "near-tie groups")
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.run([feed["image"], feed["im_info"]])
            times.append((time.perf_counter() - t0) * 1e3)
        figures = dict(ops=len(ops), detections=n, batch_ms=statistics.median(
            times), batch_ms_min=min(times), batch_ms_max=max(times),
            cpu_score_err=s_err, cpu_box_err=b_err, cpu_near_tie_rows=tied)
        del pred
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"ms a batch (median [min, max] of 7): {figures['batch_ms']:.1f} "
          f"[{figures['batch_ms_min']:.1f}, {figures['batch_ms_max']:.1f}]; "
          "mask_rcnn predictor: " + json.dumps(figures))
    del exe, scope
    torch.cuda.empty_cache()
    return figures


def mask_rcnn_path(fluid, kc):
    """The Mask R-CNN phases in order; prints the section's time."""
    t0 = time.perf_counter()
    mask_rcnn_train_small(fluid, kc)
    mask_rcnn_train_full(fluid, kc)
    mask_rcnn_predictor(fluid, kc)
    print(f"Mask R-CNN section: {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# dygraph: the eager mode (paddle_tpu_torch.dygraph), a BERT-base-width
# encoder classifier trained and evaluated through torch autograd
# ---------------------------------------------------------------------------

# bench_bert's schedule as dygraph objects: linear warmup from 0 to 1e-4
# over 1000 steps, over polynomial decay from 1e-4 to 1e-5 in 100000
DG_B, DG_S, DG_EVAL_B = 32, 128, 8
DG_WARM, DG_TIMED, DG_EVAL_BATCHES = 2, 5, 3
DG_SMALL = (2, 2, 128)  # layers, B, S of the card-vs-CPU network


def build_dygraph_bert(dg, layers, cfg):
    """The eager BERT classifier at cfg's widths, written in the dygraph
    API of the package whose `dygraph` module is `dg` (and whose layers
    are `layers`), so either package builds it. It follows
    models/bert.py's encoder op for op: word, position and type
    Embedding, LayerNorm and dropout; per layer Linear(H, 3H),
    layers.fused_qkv_attention with the mask's key bias, Linear(H, H), a
    traced fused_dropout_add_ln on the layer's own scale and bias,
    Linear(H, F, act="gelu"), Linear(F, H) and the second
    fused_dropout_add_ln; then the first token through a tanh pooler,
    Linear(H, 2), and with labels softmax_with_cross_entropy and
    reduce_mean. forward(ids, types, mask[, label]) returns (loss,
    logits) with a label, else the logits [B, 2]."""
    import importlib

    from_pkg = importlib.import_module(dg.__name__.rpartition(".")[0])
    init = from_pkg.initializer
    trace_op_multi = importlib.import_module(
        dg.__name__ + ".tracer").trace_op_multi
    h, nh = cfg.hidden_size, cfg.num_heads

    def weight():
        return from_pkg.ParamAttr(
            initializer=init.Normal(0.0, cfg.initializer_range))

    class ResidualLN(dg.Layer):
        """LN(x + dropout(y)) as one traced fused_dropout_add_ln."""

        def __init__(self):
            super().__init__()
            self.scale = self.create_parameter([h],
                                               initializer=init.Constant(1.0))
            self.bias = self.create_parameter([h], is_bias=True)

        def forward(self, x, y):
            return trace_op_multi(
                "fused_dropout_add_ln",
                {"X": [x], "Y": [y], "Scale": [self.scale],
                 "LnBias": [self.bias]},
                {"dropout_prob": cfg.hidden_dropout,
                 "is_test": not self.training,
                 "dropout_implementation": "downgrade_in_infer",
                 "epsilon": 1e-5})["Out"][0]

    class EncoderLayer(dg.Layer):
        def __init__(self):
            super().__init__()
            self.qkv = dg.Linear(h, 3 * h, param_attr=weight())
            self.out = dg.Linear(h, h, param_attr=weight())
            self.ln1 = ResidualLN()
            self.ffn_in = dg.Linear(h, cfg.intermediate_size,
                                    param_attr=weight(), act="gelu")
            self.ffn_out = dg.Linear(cfg.intermediate_size, h,
                                     param_attr=weight())
            self.ln2 = ResidualLN()

        def forward(self, x, key_bias):
            ctx = layers.fused_qkv_attention(
                self.qkv(x), nh, key_bias=key_bias,
                scale=1.0 / math.sqrt(h // nh),
                dropout_prob=cfg.attention_dropout,
                is_test=not self.training)
            x = self.ln1(x, self.out(ctx))
            return self.ln2(x, self.ffn_out(self.ffn_in(x)))

    class BertClassifier(dg.Layer):
        def __init__(self):
            super().__init__()
            self.word = dg.Embedding([cfg.vocab_size, h], param_attr=weight())
            self.pos = dg.Embedding([cfg.max_position, h],
                                    param_attr=weight())
            self.type = dg.Embedding([cfg.type_vocab_size, h],
                                     param_attr=weight())
            self.emb_ln = dg.LayerNorm(h)
            self.encoder = dg.LayerList(
                [EncoderLayer() for _ in range(cfg.num_layers)])
            self.pooler = dg.Linear(h, h, param_attr=weight(), act="tanh")
            self.cls = dg.Linear(h, 2, param_attr=weight())

        def forward(self, ids, types, mask, label=None):
            s = ids.shape[1]
            pos = layers.reshape(layers.range(0, s, 1, "int64"), [1, s])
            emb = self.word(ids) + self.pos(pos) + self.type(types)
            x = layers.dropout(self.emb_ln(emb), cfg.hidden_dropout,
                               is_test=not self.training)
            key_bias = layers.scale(mask, scale=1e4, bias=-1e4)
            for layer in self.encoder:
                x = layer(x, key_bias)
            first = layers.reshape(layers.slice(x, [1], [0], [1]), [-1, h])
            logits = self.cls(self.pooler(first))
            if label is None:
                return logits
            loss = layers.reduce_mean(
                layers.softmax_with_cross_entropy(logits, label))
            return loss, logits

    return BertClassifier()


def dygraph_batches(cfg, B, S, n, seed=0):
    """n eager batches from RandomState(seed) as numpy: ids, types, a
    padded tail of keys in every other sample, labels [B, 1]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.ones((B, S), "float32")
        mask[1::2, S - S // 4:] = 0.0
        out.append({
            "ids": rng.randint(0, cfg.vocab_size, (B, S)).astype("int64"),
            "types": rng.randint(0, cfg.type_vocab_size,
                                 (B, S)).astype("int64"),
            "mask": mask,
            "label": rng.randint(0, 2, (B, 1)).astype("int64"),
        })
    return out


def dygraph_vars(dg, batch):
    """A batch as VarBases on the guard's device, in forward()'s order."""
    return [dg.to_variable(batch[k]) for k in ("ids", "types", "mask",
                                               "label")]


def dygraph_grads(net):
    return {n: p.gradient() for n, p in net.named_parameters()}


def dygraph_small(fluid):
    """The small eager network (BERT-base width, DG_SMALL's depth, batch
    and sequence, no dropout, Adam at SMALL_LR) on the card, through the
    kernels, and on the CPU, through their plain versions, from one
    state: two eager steps, the loss and every gradient of each under
    FP32_TOL, the parameters after them under its update rule, then the
    eval-mode logits of the updated nets under no_grad."""
    from paddle_tpu_torch import convert, dygraph as dg, layers
    from paddle_tpu_torch.models.bert import BertConfig

    n_layers, B, S = DG_SMALL
    print(f"== dygraph, reduced depth: BERT-base width, {n_layers} layers, "
          f"B={B}, S={S}, no dropout, Adam({SMALL_LR:g}); eager on the card "
          "vs CPUPlace()")
    cfg = BertConfig.base()
    cfg.num_layers = n_layers
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    batches = dygraph_batches(cfg, B, S, 2, seed=1)
    runs, start = [], None
    t0 = time.perf_counter()
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        with dg.guard(place):
            net = build_dygraph_bert(dg, layers, cfg)
            if start is None:
                start = net.state_dict()
            else:
                convert.layer_state_from_numpy(net, start)
            opt = fluid.optimizer.Adam(SMALL_LR,
                                       parameter_list=net.parameters())
            losses, grads = [], []
            for b in batches:
                loss, _ = net(*dygraph_vars(dg, b))
                loss.backward()
                grads.append(dygraph_grads(net))
                opt.minimize(loss)
                net.clear_gradients()
                losses.append(loss.numpy())
            net.eval()
            with dg.no_grad():
                logits = net(*dygraph_vars(dg, batches[0])[:3]).numpy()
            runs.append((losses, grads, net.state_dict(), logits))
    (gl, gg, gend, glog), (cl, cg, cend, clog) = runs
    worst = 0.0
    for step in range(len(batches)):
        rel = float(np.abs(gl[step] - cl[step]).max() / np.abs(cl[step]).max())
        check(np.isfinite(gl[step]).all() and rel <= FP32_TOL["loss"],
              f"dygraph step {step}: loss {gl[step]} vs CPU {cl[step]}")
        for n, c in cg[step].items():
            check(gg[step][n] is not None and c is not None,
                  f"dygraph step {step}: no gradient reached {n}")
            err, ok = _held(gg[step][n], c, FP32_TOL["grad"])
            worst = max(worst, err)
            check(ok, f"dygraph step {step}: {n} gradient differs by "
                  f"{err:.3e}")
    pairs = {n: [(gg[i][n], cg[i][n]) for i in range(len(batches))]
             for n in cg[0]}
    worst_u, exempt, total = check_updates(start, gend, cend, pairs,
                                           SMALL_LR, *FP32_TOL["update"])
    moved = sum(not np.array_equal(start[n], cend[n]) for n in pairs)
    check(moved == len(pairs), f"{moved} of {len(pairs)} parameters moved")
    e_log = float(np.abs(glog - clog).max())
    check(np.isfinite(glog).all() and e_log <= PROB_ATOL,
          f"dygraph eval logits differ by {e_log:.3e}")
    print(f"{len(batches)} eager steps, {len(pairs)} parameters: loss "
          f"{[float(v[0]) for v in gl]} (card) vs {[float(v[0]) for v in cl]}"
          f" (CPU); every gradient within {FP32_TOL['grad']} (worst "
          f"{worst:.2e}); updates {worst_u:.2e} of (|update| + lr), "
          f"{exempt} of {total} exempt; eval logits max_abs_err "
          f"{e_log:.2e} (atol {PROB_ATOL:g}); {time.perf_counter() - t0:.1f}s")


def dygraph_lr(dg):
    """bench_bert's schedule as dygraph objects (its static form is
    layers.linear_lr_warmup over layers.polynomial_decay)."""
    return dg.LinearLrWarmup(dg.PolynomialDecay(1e-4, 100000, 1e-5), 1000,
                             0.0, 1e-4)


def dygraph_train_step(net, opt, vars_):
    """One eager training step; returns the loss VarBase (not read)."""
    loss, _ = net(*vars_)
    loss.backward()
    opt.minimize(loss)
    net.clear_gradients()
    return loss


def dygraph_expect(n_layers, ln=False):
    """The kernel launches of one eager training step: per layer one
    attention forward (#1), its dq and dkv (#3), two residual forwards
    (#2) and backwards (#4, each with its sum_partials); with the flag,
    the embedding LayerNorm's #10 and #11 (and #11's sum_partials)."""
    n = {k: 0 for k in DG_COUNTERS}
    n.update(attention_fwd=n_layers, attention_bwd_dq=n_layers,
             attention_bwd_dkv=n_layers, residual_fwd=2 * n_layers,
             residual_bwd=2 * n_layers, sum_partials=2 * n_layers)
    if ln:
        n.update(layer_norm_fwd=1, layer_norm_bwd=1,
                 sum_partials=2 * n_layers + 1)
    return n


DG_COUNTERS = ("ring_fwd", "ring_bwd_dq", "ring_bwd_dkv", "layer_norm_fwd",
               "layer_norm_bwd", "attention_fwd", "attention_bwd_dq",
               "attention_bwd_dkv", "residual_fwd", "residual_bwd",
               "sum_partials", "tiled_fwd", "tiled_bwd_dq", "tiled_bwd_dkv",
               "mha_fwd", "mha_bwd_dq", "mha_bwd_dkv")


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def timed_eager(fn, n):
    """n calls of fn: (wall ms, host ms until fn returned) of each."""
    wall, host = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wall.append((t2 - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
    return wall, host


def dygraph_train_full(fluid, kc):
    """bench_bert's widths (BertConfig.base(): vocab 30522, 12 layers,
    hidden 768, 12 heads, FFN 3072) as the eager classifier, B=32, S=128,
    dropout 0.1, Adam under dygraph_lr, fp32: DG_WARM warm-up and
    DG_TIMED timed steps, each launching dygraph_expect's kernels, and one
    under torch.profiler (card busy and idle share, host-device
    synchronisations); one step with FLAGS_paddle_tpu_pallas_layer_norm
    on (#10/#11 once each); evaluation (net.eval() under no_grad, B=8)
    with #1 and #2 only; then
    save_dygraph -> load_dygraph into a fresh net (set_dict): every
    parameter bit-equal and the next step's loss bit-equal to the
    original net's from the same tracer state; and DataParallel on a
    1-rank NCCL group, whose gradients are the plain step's. Returns the
    launches of the training run's steps, of the flag-on step and of the
    eval batches."""
    import tempfile

    from paddle_tpu_torch import dygraph as dg, layers
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.parallel import make_mesh, mesh_guard

    cfg = BertConfig.base()
    print(f"== dygraph training path: the eager BERT classifier at "
          f"BertConfig.base(), B={DG_B}, S={DG_S}, dropout "
          f"{cfg.hidden_dropout}, Adam under linear warmup over polynomial "
          "decay, fp32")
    expect = dygraph_expect(cfg.num_layers)
    batches = dygraph_batches(cfg, DG_B, DG_S, 2)
    t_sec = time.perf_counter()
    fluid.default_startup_program().random_seed = SEED
    with dg.guard():
        t0 = time.perf_counter()
        net = build_dygraph_bert(dg, layers, cfg)
        torch.cuda.synchronize()
        n_params = sum(p.value.numel() for p in net.parameters())
        print(f"built on the card in {time.perf_counter() - t0:.2f}s: "
              f"{n_params / 1e6:.1f}M parameters in "
              f"{len(net.parameters())} tensors")
        check(all(p.value.is_cuda for p in net.parameters()),
              "a parameter is off the card")
        opt = fluid.optimizer.Adam(dygraph_lr(dg),
                                   parameter_list=net.parameters())
        staged = [dygraph_vars(dg, b) for b in batches]
        torch.cuda.reset_peak_memory_stats()
        first = {n: p.numpy() for n, p in net.named_parameters()}
        losses, steps = [], DG_WARM + DG_TIMED
        step_i = [0]

        def step():
            before = read_counts(kc)
            losses.append(dygraph_train_step(net, opt,
                                             staged[step_i[0] % 2]))
            now = read_counts(kc)
            got = {k: now[k] - before[k] for k in DG_COUNTERS}
            check(got == expect, f"eager step {step_i[0]} launched {got}, "
                  f"want {expect}")
            step_i[0] += 1

        reset_counts(kc)
        step()  # lr 0 at warmup's step 0: Adam moves nothing
        check(all(np.array_equal(first[n], p.numpy())
                  for n, p in net.named_parameters()),
              "a weight moved at lr 0")
        wall, host = timed_eager(step, steps - 1)
        print("  one eager step under torch.profiler:")
        prof = profile_step(step)
        # the training run's launches, every step's checked above
        train_n = {k: read_counts(kc)[k] for k in DG_COUNTERS}
        moved = sum(not np.array_equal(first[n], p.numpy())
                    for n, p in net.named_parameters())
        check(moved == len(first), f"{moved} of {len(first)} weights moved")
        vals = [float(v.numpy()[0]) for v in losses]
        check(all(math.isfinite(v) for v in vals), f"losses {vals}")
        t_wall = statistics.median(wall[DG_WARM - 1:])
        t_host = statistics.median(host[DG_WARM - 1:])
        print(f"  losses {vals}")
        print(f"eager step (median [min, max] of {DG_TIMED} after {DG_WARM} "
              f"warm-up): {t_wall:.1f} ms [{min(wall[DG_WARM - 1:]):.1f}, "
              f"{max(wall[DG_WARM - 1:]):.1f}], "
              f"{DG_B * DG_S / t_wall * 1e3:.0f} tokens/s; the step's "
              f"Python returned after {t_host:.1f} ms (host share "
              f"{t_host / t_wall:.2f}; card idle share of the profiled "
              f"step {prof['idle_share']:.3f}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"launches a step {nonzero(expect)}")

        fluid.set_flags({LN_FLAG: True})
        try:
            reset_counts(kc)
            w_ln, h_ln = timed_eager(
                lambda: dygraph_train_step(net, opt, staged[0]), 1)
            ln_n = {k: read_counts(kc)[k] for k in DG_COUNTERS}
        finally:
            fluid.set_flags({LN_FLAG: False})
        want_ln = dygraph_expect(cfg.num_layers, ln=True)
        check(ln_n == want_ln,
              f"flag-on eager step launched {ln_n}, want {want_ln}")
        print(f"flag-on step (embedding LayerNorm on #10/#11): "
              f"{w_ln[0]:.1f} ms, host {h_ln[0]:.1f} ms; launches "
              f"{nonzero(ln_n)}")

        net.eval()
        evals = [dygraph_vars(dg, b)[:3] for b in
                 dygraph_batches(cfg, DG_EVAL_B, DG_S, DG_EVAL_BATCHES, 7)]
        out = []

        def eval_batch(i=[0]):
            with dg.no_grad():
                out.append(net(*evals[i[0] % len(evals)]))
            i[0] += 1

        reset_counts(kc)
        w_ev, h_ev = timed_eager(eval_batch, DG_EVAL_BATCHES)
        per_batch = {k: 0 for k in DG_COUNTERS}
        per_batch.update(attention_fwd=cfg.num_layers,
                         residual_fwd=2 * cfg.num_layers)
        eval_n = {k: read_counts(kc)[k] for k in DG_COUNTERS}
        check(eval_n == {k: v * DG_EVAL_BATCHES
                         for k, v in per_batch.items()},
              f"eval launched {eval_n} in {DG_EVAL_BATCHES} batches, want "
              f"{per_batch} a batch")
        logits = np.stack([o.numpy() for o in out])
        check(logits.shape == (DG_EVAL_BATCHES, DG_EVAL_B, 2)
              and np.isfinite(logits).all(),
              f"eval logits {logits.shape} or not finite")
        check(all(o.value.grad_fn is None for o in out),
              "an eval output records a graph under no_grad")
        print(f"eval (net.eval() under no_grad, B={DG_EVAL_B}): "
              f"{statistics.median(w_ev):.1f} ms a batch (host "
              f"{statistics.median(h_ev):.1f} ms); launches a batch "
              f"{nonzero(per_batch)}")
        net.train()

    # checkpoint: the reloaded net's next step against the original's,
    # each from a fresh tracer (one op sequence, so one dropout stream)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/bert"
        t0 = time.perf_counter()
        dg.save_dygraph(net.state_dict(), path)
        params, opt_state = dg.load_dygraph(path)
        t_io = time.perf_counter() - t0
    with dg.guard():
        fresh = build_dygraph_bert(dg, layers, cfg)
        fresh.set_dict(params)
    check(opt_state is None, "load_dygraph found a .pdopt")
    check(all(np.array_equal(p.numpy(), params[n])
              for n, p in fresh.named_state()),
          "a reloaded parameter differs from the saved one")
    run_loss = {}
    for name, model in (("saved", net), ("loaded", fresh)):
        with dg.guard():
            loss, _ = model(*dygraph_vars(dg, batches[0]))
            loss.backward()
            run_loss[name] = (loss.numpy(), dygraph_grads(model))
            model.clear_gradients()
    check(np.array_equal(run_loss["saved"][0], run_loss["loaded"][0]),
          f"loss after reload {run_loss['loaded'][0]} vs "
          f"{run_loss['saved'][0]}")
    print(f"save_dygraph + load_dygraph of {len(params)} arrays: "
          f"{t_io:.2f}s; every parameter bit-equal; the next step's loss "
          f"{float(run_loss['saved'][0][0]):.9g} bit-equal")

    # DataParallel over a 1-rank NCCL group: its gradients are the plain
    # step's (run_loss["saved"]'s, from the same tracer state)
    mesh = make_mesh({"dp": 1}, place=fluid.CUDAPlace(0))
    try:
        with dg.guard(), mesh_guard(mesh):
            dp = dg.DataParallel(net)
            check(dp.nranks == 1, f"DataParallel nranks {dp.nranks}")
            loss, _ = dp(*dygraph_vars(dg, batches[0]))
            dp.scale_loss(loss).backward()
            dp.apply_collective_grads()
            dp_grads = dygraph_grads(net)
            net.clear_gradients()
    finally:
        mesh.close()
    worst = 0.0
    for n, want in run_loss["saved"][1].items():
        err, ok = _held(dp_grads[n], want, FP32_TOL["grad"])
        worst = max(worst, err)
        check(ok, f"DataParallel gradient {n} differs by {err:.3e}")
    check(np.array_equal(loss.numpy(), run_loss["saved"][0]),
          "DataParallel's loss differs from the plain step's")
    print(f"DataParallel on a 1-rank NCCL group: loss bit-equal, "
          f"{len(dp_grads)} gradients within {FP32_TOL['grad']} of the "
          f"plain step's (worst {worst:.2e})")
    del net, fresh, opt, staged, params, dp
    torch.cuda.empty_cache()
    print(f"dygraph training path: {time.perf_counter() - t_sec:.1f}s")
    return train_n, ln_n, eval_n


def dygraph_kernel_times(fa, fr, lnk, train_n, ln_n, eval_n):
    """The dygraph path's kernels at its shapes, fp32, each against its
    plain version (max_abs_err under TOL), beside the plain version's time,
    its bound and one PyTorch call: training (B=32, S=128, H=12, D=64,
    dropout 0.1) #1, #3's dq and dkv (timed apart by launch_ms), #2 and
    #4 (R = 4096 rows of N = 768); #10/#11 at the embedding LayerNorm's
    [4096, 768] (the flag-on step); eval (B=8, test mode) #1 and #2. The
    bounds are train_kernel_times' and ln_kernel_times'. Each time is the
    median of 3 repetitions of 10 calls (cuda_ms's 7 of 40 spend most of
    their time in the sleep that holds the stream)."""
    import torch.nn.functional as F

    def dg_ms(fn):
        return cuda_ms(fn, iters=10, reps=3)

    B, S, H, D, N = DG_B, DG_S, 12, 64, 768
    R = B * S
    f32 = torch.float32
    print(f"== kernel times, dygraph path (B={B}, S={S}, H={H}, D={D}; "
          f"R={R}, N={N}; fp32, dropout {TRAIN_RATE} in training; eval "
          f"B={DG_EVAL_B} in test mode)")
    rows = []
    for path, b_, test, n in (("dygraph", B, False, train_n),
                              ("dygraph_eval", DG_EVAL_B, True, eval_n)):
        kw = dict(scale=0.125, dropout_rate=TRAIN_RATE, is_test=test,
                  seed=None if test else MASK_SEED)
        qkv, bias = attn_inputs(b_, H, D, f32, SEED, S=S)
        q, k, v = qkv.view(b_, S, 3, H, D).permute(2, 0, 3, 1, 4)
        mask = bias[:, None, None, :]
        e = compare(fa.fused_attention_qkv(qkv, H, bias, **kw),
                    fa.reference_qkv(qkv, H, bias, **kw), "attention", f32,
                    f"attention fwd B={b_} S={S} ({path})")
        t_k = dg_ms(lambda: fa.fused_attention_qkv(qkv, H, bias, **kw))
        t_p = dg_ms(lambda: fa.reference_qkv(qkv, H, bias, **kw))
        drop = 0.0 if test else TRAIN_RATE
        t_l = dg_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=drop, scale=0.125))
        b, _, _ = attn_bound(qkv, bias, H)
        print(f"attention fwd ({path}): kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, sdpa {t_l:.4f} ms, bound {b[0]:.4f} ms "
              f"({b[1]})")
        rows.append(row("flash_attention_qkv_fwd", path, "flash_attention.cu",
                        "paddle_tpu/kernels/flash_attention.py:329",
                        n["attention_fwd"], e, t_k, t_p, b, t_l))
        if not test:
            do = torch.randn(b_, S, H * D, device="cuda")
            dqkv, _ = fa.fused_attention_qkv_bwd(qkv, H, bias, do, **kw)
            want, _ = fa.reference_qkv_bwd(qkv, H, bias, do, **kw)
            e = compare(dqkv, want, "attention_bwd", f32,
                        f"attention bwd dqkv B={b_} S={S} ({path})")
            t = launch_ms(lambda: fa.fused_attention_qkv_bwd(qkv, H, bias,
                                                             do, **kw),
                          (("flash_attention", "flash_attention_bwd_dq"),
                           ("flash_attention", "flash_attention_bwd_dkv")))
            t_p = dg_ms(lambda: fa.reference_qkv_bwd(qkv, H, bias, do,
                                                     **kw))
            qg, kg, vg = (x.detach().contiguous().requires_grad_()
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, dropout_p=TRAIN_RATE,
                scale=0.125)
            do4 = do.view(b_, S, H, D).transpose(1, 2)
            t_l = dg_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do4, retain_graph=True))
            esz, pairs = 4, b_ * H * S * S
            head = b_ * S * H * D * esz
            reads = qkv.numel() * esz + head + bias.numel() * 4
            ops = 3 * 4 * pairs * D  # 3xTF32, as train_kernel_times
            for which, nb in (("dq", head), ("dkv", 2 * head)):
                b = bound(reads / 2 + nb, ops, "tf32")
                t_k = t[f"flash_attention_bwd_{which}"]
                print(f"attention bwd {which} ({path}): kernel {t_k:.4f} ms"
                      f", plain (the pair) {t_p:.4f} ms, sdpa backward "
                      f"{t_l:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
                rows.append(row(f"flash_attention_qkv_bwd_{which}", path,
                                "flash_attention.cu",
                                "paddle_tpu/kernels/flash_attention.py:342",
                                n[f"attention_bwd_{which}"], e, t_k, t_p, b,
                                t_l))
            del do, dqkv, want, qg, kg, vg, out, do4
        del qkv, bias, q, k, v, mask

        rows_ = b_ * S
        x, y, g, c = res_inputs(rows_, N, f32, SEED)
        rkw = dict(rate=TRAIN_RATE, is_test=test, eps=1e-5,
                   seed=None if test else MASK_SEED)
        e = compare(fr.fused_dropout_add_ln_fwd(x, y, g, c, **rkw),
                    fr.reference_fwd(x, y, g, c, **rkw), "residual", f32,
                    f"residual fwd R={rows_} ({path})")
        t_k = dg_ms(lambda: fr.fused_dropout_add_ln_fwd(x, y, g, c, **rkw))
        t_p = dg_ms(lambda: fr.reference_fwd(x, y, g, c, **rkw))
        t_l = dg_ms(lambda: F.layer_norm(x + y, (N,), g, c, 1e-5))
        b = res_bound(x, N)
        print(f"residual fwd ({path}): kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, F.layer_norm {t_l:.4f} ms, bound {b[0]:.4f} "
              f"ms ({b[1]})")
        rows.append(row("fused_dropout_add_ln_fwd", path,
                        "fused_dropout_add_ln.cu",
                        "paddle_tpu/kernels/fused_residual.py:90",
                        n["residual_fwd"], e, t_k, t_p, b, t_l))
        if not test:
            do = torch.randn(rows_, N, device="cuda")
            got = fr.fused_dropout_add_ln_bwd(x, y, g, do, **rkw)
            want = fr.reference_bwd(x, y, g, do, **rkw)
            e = max(compare(a, w, "residual_bwd", f32,
                            f"residual bwd {nm} R={rows_} ({path})")
                    for a, w, nm in zip(got[:2], want[:2], ("dx", "dy")))
            for a, w, nm in zip(got[2:], want[2:], ("dg", "dc")):
                compare(a, w, "residual_sums", f32,
                        f"residual bwd {nm} R={rows_} ({path})")
            t = launch_ms(lambda: fr.fused_dropout_add_ln_bwd(x, y, g, do,
                                                              **rkw),
                          (("fused_dropout_add_ln",
                            "fused_dropout_add_ln_bwd"),
                           ("sum_partials", "sum_partials")), iters=20)
            t_p = dg_ms(lambda: fr.reference_bwd(x, y, g, do, **rkw))
            xg, yg, gg, cg = (v.detach().requires_grad_()
                              for v in (x, y, g, c))
            ln = F.layer_norm(xg + yg, (N,), gg, cg, 1e-5)
            t_l = dg_ms(lambda: torch.autograd.grad(
                ln, (xg, yg, gg, cg), do, retain_graph=True))
            b = bound(5 * rows_ * N * 4 + 3 * N * 4, 20 * rows_ * N, f32)
            t_k = t["fused_dropout_add_ln_bwd"]
            print(f"residual bwd ({path}): row kernel {t_k:.4f} ms "
                  f"(sum_partials {t['sum_partials']:.4f} ms), plain "
                  f"{t_p:.4f} ms, F.layer_norm backward {t_l:.4f} ms, "
                  f"bound {b[0]:.4f} ms ({b[1]})")
            rows.append(row("fused_dropout_add_ln_bwd", path,
                            "fused_dropout_add_ln.cu",
                            "paddle_tpu/kernels/fused_residual.py:104",
                            n["residual_bwd"], e, t_k, t_p, b, t_l))
            del do, got, want, xg, yg, gg, cg, ln
        del x, y, g, c

    # the flag-on step's embedding LayerNorm: [R, N] fp32, fp32 affine
    x, dy, sc, bi = ln_inputs(R, N, f32, f32, SEED)
    got, want = lnk.layer_norm_fwd(x, sc, bi, 1e-5), lnk.reference_fwd(
        x, sc, bi, 1e-5)
    e_f = compare(got[0], want[0], "layer_norm", f32,
                  f"layer_norm fwd R={R} (dygraph_ln)")
    got, want = lnk.layer_norm_bwd(x, sc, dy, 1e-5), lnk.reference_bwd(
        x, sc, dy, 1e-5)
    e_b = compare(got[0], want[0], "layer_norm_bwd", f32,
                  f"layer_norm bwd dx R={R} (dygraph_ln)")
    t_k = dg_ms(lambda: lnk.layer_norm_fwd(x, sc, bi, 1e-5))
    t_p = dg_ms(lambda: lnk.reference_fwd(x, sc, bi, 1e-5))
    t_l = dg_ms(lambda: F.layer_norm(x, (N,), sc, bi, 1e-5))
    b = bound(2 * R * N * 4 + 2 * N * 4 + 2 * R * 4, 8 * R * N, f32)
    print(f"layer_norm fwd (dygraph_ln): kernel {t_k:.4f} ms, plain "
          f"{t_p:.4f} ms, F.layer_norm {t_l:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]})")
    rows.append(row("layer_norm_fwd", "dygraph_ln", "layer_norm.cu",
                    "paddle_tpu/kernels/layer_norm.py:50",
                    ln_n["layer_norm_fwd"], e_f, t_k, t_p, b, t_l))
    t = launch_ms(lambda: lnk.layer_norm_bwd(x, sc, dy, 1e-5),
                  (("layer_norm", "layer_norm_bwd"),
                   ("sum_partials", "sum_partials")), iters=20)
    t_p = dg_ms(lambda: lnk.reference_bwd(x, sc, dy, 1e-5))
    xg, sg, bg = (v.detach().requires_grad_() for v in (x, sc, bi))
    out = F.layer_norm(xg, (N,), sg, bg, 1e-5)
    t_l = dg_ms(lambda: torch.autograd.grad(out, (xg, sg, bg), dy,
                                              retain_graph=True))
    b = bound(3 * R * N * 4 + 3 * N * 4, 16 * R * N, f32)
    print(f"layer_norm bwd (dygraph_ln): row kernel "
          f"{t['layer_norm_bwd']:.4f} ms (sum_partials "
          f"{t['sum_partials']:.4f} ms), plain {t_p:.4f} ms, F.layer_norm "
          f"backward {t_l:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    rows.append(row("layer_norm_bwd", "dygraph_ln", "layer_norm.cu",
                    "paddle_tpu/kernels/layer_norm.py:65",
                    ln_n["layer_norm_bwd"], e_b, t["layer_norm_bwd"], t_p, b,
                    t_l))
    return rows


def dygraph_path(fluid, kc):
    """The dygraph phases in order; returns its kernel rows' launches
    (training, flag-on, eval)."""
    dygraph_small(fluid)
    return dygraph_train_full(fluid, kc)


def dygraph_static(fluid):
    """The port's static program of the eager classifier (models/bert.py's
    encoder, the tanh pooler and the 2-way head, Adam under bench_bert's
    schedule) at BertConfig.base(), B=DG_B, S=DG_S, dropout 0.1: 3
    warm-up and DG_TIMED timed steps through Executor.run, then one under
    torch.profiler; prints the median step, the median time until
    Executor.run returned and the profile, to set beside
    dygraph_train_full's eager step. chip_smoke.py does not run it;
    tools/torch_phases.py dygraph does."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models.bert import BertConfig, bert_encoder
    from paddle_tpu_torch.optimizer import Adam

    cfg = BertConfig.base()
    print(f"== dygraph's static twin: the same classifier as a static "
          f"program at BertConfig.base(), B={DG_B}, S={DG_S}, dropout "
          f"{cfg.hidden_dropout}, Adam under bench_bert's schedule, fp32")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    h = cfg.hidden_size
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [DG_B, DG_S], "int64")
        types = fluid.data("types", [DG_B, DG_S], "int64")
        mask = fluid.data("mask", [DG_B, DG_S], "float32")
        label = fluid.data("label", [DG_B, 1], "int64")
        seq = bert_encoder(ids, types, mask, cfg)
        first = layers.reshape(layers.slice(seq, [1], [0], [1]), [-1, h])
        logits = layers.fc(layers.fc(first, h, act="tanh"), 2)
        loss = layers.reduce_mean(
            layers.softmax_with_cross_entropy(logits, label))
        lr = layers.linear_lr_warmup(
            layers.polynomial_decay(1e-4, 100000, 1e-5), 1000, 0.0, 1e-4)
        Adam(lr).minimize(loss, startup)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = on_card(dygraph_batches(cfg, DG_B, DG_S, 2))
    i = [0]

    def step():
        exe.run(main, feed=feeds[i[0] % 2], fetch_list=[loss], scope=scope,
                return_numpy=False)
        i[0] += 1

    wall, host = timed_eager(step, 3 + DG_TIMED)
    print("  one static step under torch.profiler:")
    profile_step(step)
    t_wall, t_host = statistics.median(wall[3:]), statistics.median(host[3:])
    print(f"static step (median [min, max] of {DG_TIMED} after 3 warm-up): "
          f"{t_wall:.1f} ms [{min(wall[3:]):.1f}, {max(wall[3:]):.1f}], "
          f"{DG_B * DG_S / t_wall * 1e3:.0f} tokens/s; Executor.run "
          f"returned after {t_host:.1f} ms (host share "
          f"{t_host / t_wall:.2f})")
    del exe, scope
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training breadth: gradient clipping, regularizers, the optimizer zoo, the
# averagers and the static LR schedules, on bench_bert's program and on
# fit-a-line
# ---------------------------------------------------------------------------


def lamb_clip(fluid, layers, lr):
    """The breadth path's optimizer: LAMB (lamb_weight_decay 0.01) with
    the global gradient norm clipped at 1.0."""
    return fluid.optimizer.Lamb(
        lr, lamb_weight_decay=0.01,
        grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0))


# bench_bert's program under each, card vs CPU at reduced depth
OPTIM_CONFIGS = {
    "lamb_global_norm": lamb_clip,
    "adamw_norm": lambda fluid, layers, lr: fluid.optimizer.AdamW(
        lr, weight_decay=0.01, grad_clip=fluid.clip.GradientClipByNorm(1.0)),
    "momentum_l2_piecewise": lambda fluid, layers, lr:
        fluid.optimizer.Momentum(
            layers.piecewise_decay([1], [lr, lr / 2]), momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4)),
}
# the global-norm clip's variables (clip.py's names)
CLIP_VARS = ("@SQ", "@CLIP", "global_norm", "max_norm", "clip_scale")


def optim_op_name(op):
    """host_by_op's name for the Lamb update and the clip's ops."""
    if op.type == "lamb":
        return "lamb"
    if any(frag in n for ns in op.outputs.values() for n in ns
           for frag in CLIP_VARS):
        return f"clip:{op.type}"
    return None


def optim_train_small(fluid, layers):
    """Two steps of bench_bert at BERT-base width, 2 layers, B=2, S=128,
    fp32, on the card and on the CPU from one state, under each of
    OPTIM_CONFIGS (card_vs_cpu: every accumulator held; the clip scale
    as the loss)."""
    from paddle_tpu_torch.models.bert import BertConfig

    cfg = BertConfig.base()
    cfg.num_layers = 2
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    for name, make in OPTIM_CONFIGS.items():
        print(f"== training breadth, reduced depth: BERT-base width, 2 "
              f"layers, B=2, S=128, no dropout, {name}, lr {SMALL_LR:g}; "
              "card vs CPUPlace()")
        main, startup, loss, _, pg, P, _ = build_bench_bert(
            fluid, layers, cfg, 2, 128, SMALL_LR, optimizer=make)
        blk = main.global_block
        close = ([blk.var("clip_scale_0")] if blk.has_var("clip_scale_0")
                 else [])
        feeds = bench_batches(cfg, 2, 128, P, 2)
        for f in feeds:
            f["mask"][1, 100:] = 0.0
        card_vs_cpu(fluid, main, startup, loss, pg, feeds, close=close)


def optim_train_full(fluid, layers, kc, adam_stats=None):
    """bench_bert's step at BertConfig.base(), B=32, S=512, dropout 0.1,
    under bench_amp, with Lamb and the global-norm clip in place of Adam
    (bench_bert's schedule): step time, tokens/s, peak memory, the
    profile, the host's ms of lamb and of the clip's ops, no host-device
    synchronisation, the kernels' launches; the ratio to adam_stats'
    step (train_full(amp=True) of the same run); the clip scale read once
    after the timed steps. Returns the launches."""
    from paddle_tpu_torch.models.bert import BertConfig

    B, S = 32, 512
    print(f"== training breadth path: bench_bert at BertConfig.base(), "
          f"B={B}, S={S}, dropout 0.1, Lamb (lamb_weight_decay 0.01) with "
          "GradientClipByGlobalNorm(1.0) under linear warmup over "
          "polynomial decay, AMP (bf16, bench.py's _amp)")
    cfg = BertConfig.base()
    t0 = time.perf_counter()
    main, startup, loss, lr, pg, P, opt = build_bench_bert(
        fluid, layers, cfg, B, S, None, amp=True, optimizer=lamb_clip)
    blk = main.global_block
    ops = blk.ops
    n_lamb = sum(op.type == "lamb" for op in ops)
    n_clip = sum(optim_op_name(op) not in (None, "lamb") for op in ops)
    check(n_lamb == len(pg), f"{n_lamb} lamb ops for {len(pg)} parameters")
    print(f"P={P}; {len(ops)} ops of {len({op.type for op in ops})} types "
          f"({n_lamb} lamb, {n_clip} of the clip), {len(pg)} parameters; "
          f"built in {time.perf_counter() - t0:.1f}s")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batches = on_card(bench_batches(cfg, B, S, P, 4))
    watch = ("bert_l0_attn_qkv_w", "bert_l11_ffn_out_w", "mlm_out_w")
    snap = {n: scope.find_var(n).clone() for n in watch}
    expect = dict.fromkeys(kc, 0)
    expect.update(attention_fwd=12, attention_bwd_dq=12,
                  attention_bwd_dkv=12, residual_fwd=24, residual_bwd=24,
                  sum_partials=24)

    def after(i, values):
        changed = [n for n in watch
                   if not torch.equal(scope.find_var(n), snap[n])]
        if i == 0:
            check(values[1] == 0.0 and not changed,
                  f"step 0 (lr {values[1]}) moved {changed}")
        elif i == 1:
            check(values[1] > 0.0 and len(changed) == len(watch),
                  f"step 1 (lr {values[1]}) moved only {changed}")

    values, stats = run_steps(exe, main, scope, batches, [loss, lr],
                              ("loss", "lr"), kc, expect, B * S, after,
                              name_of=optim_op_name)
    no_host_sync(stats, "the Lamb step")
    counts = read_counts(kc)
    amp_checks(main, opt, scope, stats["steps"], {
        "fused_qkv_attention": ("QKV",),
        "fused_qkv_attention_grad": ("QKV", "OutGrad"),
        "fused_dropout_add_ln": ("X", "Y"),
        "fused_dropout_add_ln_grad": ("X", "Y", "OutGrad")})
    final, scale = exe.run(main, feed=batches[0],
                           fetch_list=[loss, blk.var("clip_scale_0")],
                           scope=scope)
    check(np.isfinite(final).all() and 0.0 < float(scale[0]) <= 1.0,
          f"after the timed steps: loss {final}, clip scale {scale}")
    named = stats.pop("host_ms_named")
    stats.update(ops=len(ops), lamb_ops=n_lamb, clip_ops=n_clip,
                 lamb_host_ms=named.get("lamb", 0.0),
                 clip_host_ms=sum(v for k, v in named.items()
                                  if k.startswith("clip:")),
                 clip_host_ms_by_op={k: v for k, v in named.items()
                                     if k.startswith("clip:")},
                 clip_scale=float(scale[0]), loss_after=float(final[0]),
                 launches=counts)
    if adam_stats is not None:
        stats["step_ratio_to_adam"] = stats["step_ms"] / adam_stats["step_ms"]
        print(f"Lamb + clip step {stats['step_ms']:.1f} ms against the Adam "
              f"step's {adam_stats['step_ms']:.1f} ms of this run: "
              f"{stats['step_ratio_to_adam']:.3f}x")
    print(f"host ms: lamb {stats['lamb_host_ms']:.1f}, the clip "
          f"{stats['clip_host_ms']:.1f}; clip scale after the timed steps "
          f"{stats['clip_scale']:.4g}, loss {stats['loss_after']:.4f}")
    print("bert lamb amp training: " + json.dumps(stats))
    del exe, scope, batches, snap
    torch.cuda.empty_cache()
    return counts


# every optimizer of the zoo on fit-a-line, card vs CPU (Dpsgd with its
# noise on: a Philox draw, the same on both)
ZOO = {
    "AdamW": lambda f: f.optimizer.AdamW(0.05, weight_decay=0.1),
    "Lamb": lambda f: f.optimizer.Lamb(0.05, lamb_weight_decay=0.01),
    "LarsMomentum": lambda f: f.optimizer.LarsMomentum(0.05, momentum=0.9),
    "Adagrad": lambda f: f.optimizer.Adagrad(0.2,
                                             initial_accumulator_value=0.1),
    "DecayedAdagrad": lambda f: f.optimizer.DecayedAdagrad(0.2),
    "RMSProp": lambda f: f.optimizer.RMSProp(0.02, momentum=0.5),
    "RMSPropCentered": lambda f: f.optimizer.RMSProp(0.02, momentum=0.5,
                                                     centered=True),
    "Adadelta": lambda f: f.optimizer.Adadelta(8.0),
    "Adamax": lambda f: f.optimizer.Adamax(0.05),
    "Ftrl": lambda f: f.optimizer.Ftrl(0.2, l1=0.01, l2=0.01),
    "FtrlPower": lambda f: f.optimizer.Ftrl(0.2, lr_power=-0.3),
    "Dpsgd": lambda f: f.optimizer.Dpsgd(0.1, clip=1.0, sigma=1.0),
    "ProximalGD": lambda f: f.optimizer.ProximalGD(
        0.05, l1_regularization_strength=0.01,
        l2_regularization_strength=0.01),
    "ProximalAdagrad": lambda f: f.optimizer.ProximalAdagrad(
        0.2, l1_regularization_strength=0.01,
        l2_regularization_strength=0.01),
    "Lookahead": lambda f: f.optimizer.LookaheadOptimizer(
        f.optimizer.Adam(0.05), alpha=0.5, k=2),
}
AVERAGERS = {
    "ExponentialMovingAverage": lambda f: f.optimizer.ExponentialMovingAverage(
        0.99, thres_steps=3),
    "ModelAverage": lambda f: f.optimizer.ModelAverage(
        0.15, min_average_window=2, max_average_window=3),
}
SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 4, learning_rate=2.0),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5,
                                                 staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 5, 0.7),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 5, 0.5),
    "polynomial_cycle": lambda L: L.polynomial_decay(1.0, 4, 0.1, power=2.0,
                                                     cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 5], [1.0, 0.5, 0.1]),
    "cosine": lambda L: L.cosine_decay(0.5, 2, 4),
    "warmup": lambda L: L.linear_lr_warmup(L.exponential_decay(0.1, 10, 0.5),
                                           3, 0.0, 0.1),
}
ZOO_TOL = (1e-5, 1e-6)  # rtol, atol: fit-a-line's [16, 4] x [4, 1] in fp32


def zoo_program(fluid, body):
    """body(fluid) in a new seeded (main, startup) under a fresh
    unique_name state."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = body(fluid)
    return main, startup, out


def fit_a_line(fluid, make_opt):
    """tests/test_optimizers_sweep.py's program, minimized by make_opt."""
    x = fluid.data("x", [16, 4])
    y = fluid.data("y", [16, 1])
    loss = fluid.layers.mean(fluid.layers.square_error_cost(
        fluid.layers.fc(x, 1), y))
    make_opt(fluid).minimize(loss)
    return loss


def line_feeds(n):
    rng = np.random.RandomState(0)
    xs = [rng.randn(16, 4).astype("float32") for _ in range(n)]
    return [{"x": x, "y": x @ np.arange(4, dtype="float32").reshape(4, 1)}
            for x in xs]


def zoo_run(fluid, main, startup, fetch, feeds):
    """main on the card and on the CPU from the card's startup state:
    (fetches a step on each, card scope, CPU scope)."""
    from paddle_tpu_torch import convert

    gexe, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gexe.run(startup, scope=gscope)
    cexe, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    convert.state_from_numpy(convert.state_to_numpy(gscope), cscope,
                             fluid.CPUPlace(), program=main)
    cpu_main = main.clone()
    got = [gexe.run(main, feed=f, fetch_list=fetch, scope=gscope)
           for f in feeds]
    want = [cexe.run(cpu_main, feed=f, fetch_list=fetch, scope=cscope)
            for f in feeds]
    return got, want, gscope, cscope


def zoo_held(got, want, what, rtol=ZOO_TOL[0], atol=ZOO_TOL[1]):
    """Worst |got - want| / (atol + rtol |want|) over the arrays, which
    must stay at most 1; integers equal."""
    worst = 0.0
    for name, (g, w) in zip(what, zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if w.dtype.kind in "iub":
            check(np.array_equal(g, w), f"{name}: {g} vs {w}")
            continue
        r = float((np.abs(g.astype(np.float64) - w)
                   / (atol + rtol * np.abs(w))).max())
        check(r <= 1.0, f"{name} differs: {r:.3g} of the tolerance")
        worst = max(worst, r)
    return worst


def optim_zoo(fluid):
    """Every optimizer of the zoo (and Lookahead), each averager through
    apply(), for three steps of fit-a-line, and every static schedule for
    20 steps, on the card against the CPU: the state, the averaged
    parameters and the learning rates within ZOO_TOL."""
    from paddle_tpu_torch import convert

    feeds = line_feeds(3)
    worst = {}
    for name, make in ZOO.items():
        main, startup, loss = zoo_program(
            fluid, lambda f, make=make: fit_a_line(f, make))
        got, want, gscope, cscope = zoo_run(fluid, main, startup, [loss],
                                            feeds)
        gs, cs_ = convert.state_to_numpy(gscope), convert.state_to_numpy(
            cscope)
        names = sorted(cs_)
        worst[name] = zoo_held([g[0] for g in got] + [gs[n] for n in names],
                               [w[0] for w in want] + [cs_[n] for n in names],
                               ["loss"] * len(got) + names)
    for name, make in AVERAGERS.items():
        def body(f, make=make):
            loss = fit_a_line(f, lambda f: f.optimizer.SGD(0.05))
            avg = make(f)
            if name == "ExponentialMovingAverage":
                avg.update()
            return loss, avg

        main, startup, (loss, avg) = zoo_program(fluid, body)
        _, _, gscope, cscope = zoo_run(fluid, main, startup, [loss], feeds)
        applied = []
        for scope in (gscope, cscope):
            with fluid.scope_guard(scope), avg.apply():
                applied.append([scope.find_var(p).cpu().numpy()
                                for p in ("fc_w_0", "fc_b_0")])
        worst[name] = zoo_held(applied[0], applied[1], ["fc_w_0", "fc_b_0"])
    for name, make in SCHEDULES.items():
        main, startup, lr = zoo_program(fluid, lambda f, make=make: make(
            f.layers))
        got, want, _, _ = zoo_run(fluid, main, startup, [lr], [{}] * 20)
        worst[name] = zoo_held([g[0] for g in got], [w[0] for w in want],
                               [f"{name} lr"] * 20, rtol=1e-6, atol=1e-12)
    print(f"optimizer zoo, averagers and schedules on the card vs the CPU "
          f"(worst error as a share of the tolerance, state rtol "
          f"{ZOO_TOL[0]:g} atol {ZOO_TOL[1]:g}, lr rtol 1e-6): "
          + json.dumps({k: round(v, 4) for k, v in worst.items()}))


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
    start = time.perf_counter()

    def phase(fn, *args, **kwargs):
        """fn(*args, **kwargs), then its seconds and the script's so far,
        so that a slice sees what its section adds to the time limit
        (the script aims to finish in half of it)."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        now = time.perf_counter()
        name = " ".join([fn.__name__] + [f"{k}={v}" for k, v in
                                          kwargs.items()])
        print(f"[lap] {name}: {now - t0:.1f}s (at {now - start:.1f}s)")
        return out

    main_err = phase(parity, fa, fr)
    train_err = phase(train_parity, fa, fr, pm)
    tiled_err = phase(tiled_parity, ft)
    ln_err = phase(ln_parity, lnk)
    mha_err = phase(mha_parity, fa)
    phase(tensor_cores)
    phase(ring_parity, rb)
    phase(ring_schedule, rb, kc)
    phase(routed_attention, fa, ft, kc)
    frozen, exe, scope, samples, serve_n = phase(main_path, fluid, layers,
                                                 kc)
    phase(serve_times, frozen, exe, scope, samples)
    del frozen, exe, scope
    torch.cuda.empty_cache()
    phase(train_small, fluid, layers)
    train_n, _ = phase(train_full, fluid, layers, kc)
    phase(gpt_train_small, fluid)
    gpt_train_n, _ = phase(gpt_train_full, fluid, kc)
    gpt_serve_n = phase(gpt_serving, fluid, kc)
    phase(gpt_train_small, fluid, amp=True)
    amp_n, amp_stats = phase(train_full, fluid, layers, kc, amp=True)
    # the Lamb step right after the Adam step it is set beside
    phase(optim_train_full, fluid, layers, kc, amp_stats)
    phase(optim_train_small, fluid, layers)
    phase(optim_zoo, fluid)
    gpt_amp_n, _ = phase(gpt_train_full, fluid, kc, amp=True)
    gpt_ln_n, _ = phase(gpt_train_full, fluid, kc, amp=True,
                        ln_kernels=True)
    long_rows = phase(gpt_long_path, fluid, ft, kc)
    phase(mha_train_small, fluid, layers)
    mha_train_n, mha_pred_n, _ = phase(mha_path, fluid, layers, kc)
    sp_n = phase(sp_path, fluid, layers, kc)
    phase(resnet_train_small, fluid)
    phase(resnet_train_full, fluid, kc)
    phase(resnet_serving, fluid, layers, kc)
    phase(yolov3_train_small, fluid)
    phase(yolov3_train_full, fluid, kc)
    phase(yolov3_predictor, fluid, kc)
    phase(ctr_path, fluid, kc)
    phase(mask_rcnn_path, fluid, kc)
    dg_n = phase(dygraph_path, fluid, kc)
    rows = phase(kernel_times, fa, fr, main_err, serve_n)
    rows += phase(train_kernel_times, fa, fr, sp, train_err, train_n, amp_n)
    rows += phase(gpt_kernel_times, fa, ft, tiled_err, gpt_train_n,
                  gpt_serve_n, gpt_amp_n)
    rows += phase(ln_kernel_times, lnk, ln_err, gpt_ln_n)
    rows += phase(mha_kernel_times, fa, mha_err, mha_train_n, mha_pred_n)
    rows += phase(ring_kernel_times, rb, sp_n)
    rows += phase(dygraph_kernel_times, fa, fr, lnk, *dg_n)
    rows += long_rows

    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
