#!/usr/bin/env python3
"""One section of chip_smoke.py's phases alone, on one CUDA card, for
iterating on a slice without the whole script. Only the dygraph, optim
and gpt_long sections run kernels of ours; they build them first (all
sources at once).

    cd <checkout> && python3 tools/torch_phases.py \
        yolov3|ctr|mask_rcnn|dygraph|optim|gpt_long

yolov3: the reduced training step against the CPU (yolov3_train_small),
bench_yolov3's AMP step at the paper's width (yolov3_train_full) and the
paper-width predictor (yolov3_predictor).
ctr: bench.py's deepfm program at its CPU config against the CPU, plain,
per-slot fused and cached (ctr_train_small), its deepfm leg at
DeepFMConfig.criteo() (ctr_deepfm), its deepfm_fused leg
(ctr_deepfm_fused) and bench_serving.py's ctr_rank ranker
(ctr_rank_serving).
mask_rcnn: bench.py's mask_rcnn leg at its CPU config against the CPU,
batched and legacy (mask_rcnn_train_small), its batched AMP step on an
accelerator (mask_rcnn_train_full), mask_rcnn_infer behind the predictor
(mask_rcnn_predictor), and, which chip_smoke.py does not run, the legacy
leg's four-image unroll under AMP on an accelerator
(mask_rcnn_legacy_full).

dygraph: the eager BERT classifier at BERT-base width on the card against
the CPU (dygraph_small), the full-width eager training, flag-on step,
evaluation, checkpoint and DataParallel phases (dygraph_train_full),
and, which chip_smoke.py does not run, the static program of the same
network at the same B and S, timed and profiled to set beside the eager
step (dygraph_static), then the dygraph path's kernel rows
(dygraph_kernel_times).

optim: bench_bert's AMP step under Adam (train_full, for the ratio),
then the training-breadth phases: the full-width Lamb + clip AMP step
(optim_train_full); bench_bert at two layers under Lamb with the
global-norm clip, AdamW with the per-gradient clip and Momentum with
L2Decay under piecewise_decay, card vs CPU (optim_train_small); every
optimizer, averager and static schedule on fit-a-line, card vs CPU
(optim_zoo).

gpt_long: bench.py's accelerator legs gpt_s4096 and gpt_s8192: #7-#9
against their plain versions at the legs' shapes (long_parity), each leg
(gpt_long_leg), then the three kernels' times at those shapes
(long_kernel_times), printed as chip_smoke.py's kernels line.

Imports the port and chip_smoke.py from the current directory, turns
TF32 off as chip_smoke.py does, runs each phase in turn (a failed phase
is reported and the next one runs), prints each phase's time and exits
non-zero if any failed.
"""

import json
import sys
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SECTIONS = {
    "yolov3": (("small", lambda fluid, kc: cs.yolov3_train_small(fluid)),
               ("full", cs.yolov3_train_full),
               ("predictor", cs.yolov3_predictor)),
    "ctr": (("small", lambda fluid, kc: cs.ctr_train_small(fluid)),
            ("deepfm", cs.ctr_deepfm),
            ("deepfm_fused", cs.ctr_deepfm_fused),
            ("ctr_rank", cs.ctr_rank_serving)),
    "mask_rcnn": (("small", cs.mask_rcnn_train_small),
                  ("full", cs.mask_rcnn_train_full),
                  ("predictor", cs.mask_rcnn_predictor),
                  ("legacy", cs.mask_rcnn_legacy_full)),
}


def _dygraph_sections():
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_residual as fr
    from paddle_tpu_torch.kernels import layer_norm as lnk

    launches = []
    return (("build", lambda fluid, kc: _build.build()),
            ("small", lambda fluid, kc: cs.dygraph_small(fluid)),
            ("full", lambda fluid, kc: launches.extend(
                cs.dygraph_train_full(fluid, kc))),
            ("static", lambda fluid, kc: cs.dygraph_static(fluid)),
            ("kernels", lambda fluid, kc: print(
                cs.dygraph_kernel_times(fa, fr, lnk, *launches))))


SECTIONS["dygraph"] = _dygraph_sections()


def _optim_sections():
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.kernels import _build

    adam = []
    return (("build", lambda fluid, kc: _build.build()),
            ("adam", lambda fluid, kc: adam.append(
                cs.train_full(fluid, layers, kc, amp=True)[1])),
            ("full", lambda fluid, kc: cs.optim_train_full(
                fluid, layers, kc, adam[0] if adam else None)),
            ("small", lambda fluid, kc: cs.optim_train_small(fluid, layers)),
            ("zoo", lambda fluid, kc: cs.optim_zoo(fluid)))


SECTIONS["optim"] = _optim_sections()


def _gpt_long_sections():
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_tiled as ft

    errs, launches = {}, {}

    def leg(B, S):
        def run(fluid, kc):
            launches[f"gpt_s{S}"] = cs.gpt_long_leg(fluid, kc, B, S)
        return run

    return (("build", lambda fluid, kc: _build.build()),
            ("parity", lambda fluid, kc: errs.update(cs.long_parity(ft))),
            *((f"s{S}", leg(B, S)) for B, S in cs.GPT_LONG_LEGS),
            ("kernels", lambda fluid, kc: print(json.dumps({
                "kernels": cs.long_kernel_times(ft, errs, launches)}))))


SECTIONS["gpt_long"] = _gpt_long_sections()


def main(argv):
    if len(argv) != 1 or argv[0] not in SECTIONS:
        print(f"usage: torch_phases.py {'|'.join(SECTIONS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_phases: no CUDA device is available", file=sys.stderr)
        return 1
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_tiled as ft
    from paddle_tpu_torch.kernels import fused_residual as fr
    from paddle_tpu_torch.kernels import layer_norm as lnk
    from paddle_tpu_torch.kernels import ring_block as rb
    from paddle_tpu_torch.kernels import sum_partials as sp

    print(cs.gpu_line(), torch.__version__, torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kc = cs.counters(fa, fr, sp, ft, lnk, rb)
    failed = []
    for name, fn in SECTIONS[argv[0]]:
        t0 = time.perf_counter()
        try:
            fn(fluid, kc)
        except Exception as e:  # report every phase
            print(f"PHASE {name} FAILED: {type(e).__name__}: {e}")
            failed.append(name)
        print(f"PHASE {name}: {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
