#!/usr/bin/env python3
"""Times of paddle_tpu_torch's attention kernels on one CUDA card, for
comparing two checkouts of the port in one call to the card.

    cd <checkout> && python3 <this file> <tag>

Imports the port and chip_smoke.py's timers from the current directory,
builds libflash_attention, libflash_tiled and libring_block there, and
prints lines starting with "[<tag>]": the card's name and power limit; an
instruction count and digest of each D=64 fp32 kernel of the three
libraries' SASS (cuobjdump -sass), so that an unchanged kernel shows as
unchanged; and one JSON object of median device times in ms, fp32 unless
named, dropout 0.1 in training:

    #1, #3 dq / dkv   fused_attention_qkv and its backward pair, at
                      BERT's B=32, S=512, H=12, D=64 with a key bias, and
                      causal at B=4, S=1024 (the whole-row kernels'
                      longest causal grid); #1 also in bf16 at B=32,
                      S=512 (BERT AMP), at serving's B=8, S=128 and at
                      GPT serving's full recompute, B=8, S=256, causal,
                      both in test mode;
    #5, #6 pair       fused_attention / attention_grads on the head views
                      at B=32, S=512; #5 also at the predictor's bucket
                      8, test mode, fp32 and bf16;
    #7, #9, #8        the KV-tiled forward and backward pair at GPT's
                      B=4, S=2048, causal;
    #12, #13, #14     the ring-block kernels at the SP path's
                      [1, 12, 8192, 64], causal, offsets (0, 0).

The backward kernels are timed apart by CUDA events around each launch
(chip_smoke.launch_ms). Run it from both checkouts in turns (A, B, B, A):
machines differ between calls.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import flash_tiled as ft  # noqa: E402
from paddle_tpu_torch.kernels import ring_block as rb  # noqa: E402

H, D = 12, 64
PAIR = (("flash_attention", "flash_attention_bwd_dq"),
        ("flash_attention", "flash_attention_bwd_dkv"))
TILED = (("flash_tiled", "flash_tiled_bwd_dq"),
         ("flash_tiled", "flash_tiled_bwd_dkv"))
RING = (("ring_block", "ring_block_bwd_dq"),
        ("ring_block", "ring_block_bwd_dkv"))
LIBS = ("flash_attention", "flash_tiled", "ring_block")


def sass_digests():
    """{kernel: (SASS instructions, digest)} of the D=64 fp32 kernels of
    LIBS."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = {}
    for lib in LIBS:
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            name = fn.split("\n", 1)[0]
            kernel = re.search(r"(\w+_kernel)IfLi64E", name)
            if kernel:
                body = [re.sub(r"/\*[0-9a-f]+\*/", "", line).strip()
                        for line in fn.splitlines()[1:] if "/*" in line]
                out[kernel.group(1)] = (len(body), hashlib.sha1(
                    "\n".join(body).encode()).hexdigest()[:10])
    return out


def times():
    res = {}
    kw = dict(scale=0.125, dropout_rate=0.1, is_test=False,
              seed=cs.MASK_SEED)
    for causal, B, S in ((False, 32, 512), (True, 4, 1024)):
        tag = f"{'causal ' if causal else ''}S={S}"
        qkv, bias = cs.attn_inputs(B, H, D, torch.float32, 1, S=S)
        do = torch.randn(B, S, H * D, device="cuda")
        ckw = dict(kw, causal=causal)
        res[f"#1 {tag}"] = cs.cuda_ms(
            lambda: fa.fused_attention_qkv(qkv, H, bias, **ckw), iters=10,
            reps=5)
        t = cs.launch_ms(
            lambda: fa.fused_attention_qkv_bwd(qkv, H, bias, do, **ckw),
            PAIR)
        res[f"#3 dq {tag}"] = t["flash_attention_bwd_dq"]
        res[f"#3 dkv {tag}"] = t["flash_attention_bwd_dkv"]
        if not causal:
            q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
            do4 = torch.randn(B, H, S, D, device="cuda")
            res["#5"] = cs.cuda_ms(
                lambda: fa.fused_attention(q, k, v, bias, **kw), iters=10,
                reps=5)
            res["#6 pair"] = cs.cuda_ms(
                lambda: fa.attention_grads(q, k, v, bias, do4,
                                           want_dbias=False, **kw),
                iters=10, reps=5)
            xb = qkv.to(torch.bfloat16)
            res["#1 bf16"] = cs.cuda_ms(
                lambda: fa.fused_attention_qkv(xb, H, bias, **kw), iters=10,
                reps=5)
    test = dict(scale=0.125, dropout_rate=0.1, is_test=True)
    qkv, bias = cs.attn_inputs(8, H, D, torch.float32, 1)
    res["#1 serving S=128"] = cs.cuda_ms(
        lambda: fa.fused_attention_qkv(qkv, H, bias, **test))
    qkv, _ = cs.attn_inputs(cs.GEN_BATCH, H, D, torch.float32, 1,
                            S=cs.GEN_MAX)
    res["#1 recompute causal S=256"] = cs.cuda_ms(
        lambda: fa.fused_attention_qkv(qkv, H, causal=True, **test))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _, bias = cs.mha_inputs(cs.MHA_BUCKETS[-1], 512, H, D,
                                         dtype, 1)
        res[f"#5 predictor {str(dtype)[6:]}"] = cs.cuda_ms(
            lambda: fa.fused_attention(q, k, v, bias, **test))
    B, S = cs.GPT_B, cs.GPT_S
    tkw = dict(scale=0.125, rate=0.1, is_test=False, causal=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda")
    do = torch.randn(B, S, H * D, generator=g, device="cuda")
    res["#7"] = cs.cuda_ms(
        lambda: ft.flash_tiled_fwd(qkv, None, cs.MASK_SEED, H, D, **tkw),
        iters=10, reps=5)
    out, lse = ft.flash_tiled_fwd(qkv, None, cs.MASK_SEED, H, D, **tkw)
    t = cs.launch_ms(lambda: ft.flash_tiled_bwd(qkv, None, cs.MASK_SEED, do,
                                                out, lse, H, D, **tkw),
                     TILED)
    res["#9"], res["#8"] = t["flash_tiled_bwd_dq"], t["flash_tiled_bwd_dkv"]
    del qkv, do, out, lse
    B, S = cs.SP_B, cs.SP_S
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                   for _ in range(4))
    res["#12"] = cs.cuda_ms(lambda: rb.ring_block_fwd(q, k, v, 0, 0, True,
                                                      0.125),
                            iters=10, reps=5)
    o, lse = rb.ring_block_fwd(q, k, v, 0, 0, True, 0.125)
    delta = (do * o).sum(-1)
    acc = [torch.zeros(B, H, S, D, device="cuda") for _ in range(3)]
    t = cs.launch_ms(lambda: rb.ring_block_bwd(q, k, v, do, lse, delta, 0, 0,
                                               True, 0.125, *acc),
                     RING, iters=5, reps=3)
    res["#13"], res["#14"] = t["ring_block_bwd_dq"], t["ring_block_bwd_dkv"]
    return res


def main():
    if not torch.cuda.is_available():
        print("torch_attn_times: no CUDA device is available",
              file=sys.stderr)
        return 1
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(LIBS + ("sum_partials",))
    print(f"[{tag}] {cs.gpu_line()}")
    for kernel, (n, digest) in sorted(sass_digests().items()):
        print(f"[{tag}] sass {kernel}<f32, 64>: {n} instructions, {digest}")
    print(f"[{tag}] " + json.dumps({k: round(v, 4)
                                    for k, v in times().items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
