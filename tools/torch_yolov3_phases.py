#!/usr/bin/env python3
"""chip_smoke.py's YOLOv3 phases alone, on one CUDA card: the reduced
training step against the CPU (yolov3_train_small), bench_yolov3's AMP
step and the paper's width (yolov3_train_full) and the paper-width
predictor (yolov3_predictor). Builds no kernel: none runs on this path.

    cd <checkout> && python3 tools/torch_yolov3_phases.py

Imports the port and chip_smoke.py from the current directory, turns
TF32 off as chip_smoke.py does, runs each phase in turn (a failed phase
is reported and the next one runs), prints each phase's time and exits
non-zero if any failed.
"""

import sys
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_yolov3_phases: no CUDA device is available",
              file=sys.stderr)
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
    for name, fn in (("small", lambda: cs.yolov3_train_small(fluid)),
                     ("full", lambda: cs.yolov3_train_full(fluid, kc)),
                     ("predictor", lambda: cs.yolov3_predictor(fluid, kc))):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report every phase
            print(f"PHASE {name} FAILED: {type(e).__name__}: {e}")
            failed.append(name)
        print(f"PHASE {name}: {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
