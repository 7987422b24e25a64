#!/usr/bin/env python3
"""Times of paddle_tpu_torch's attention kernels, and of the row kernels
with sum_partials, on one CUDA card, for comparing two checkouts of the
port in one call to the card.

    cd <checkout> && python3 <this file> <tag> [--rows | --sass]

Imports the port and chip_smoke.py's timers from the current directory,
builds libflash_attention, libflash_tiled, libring_block,
libfused_dropout_add_ln, liblayer_norm and libsum_partials there, and
prints lines starting with "[<tag>]": the card's name and power limit;
for each kernel of the libraries it built, its instances, SASS
instructions and a digest of them all (cuobjdump -sass), so that an
unchanged kernel shows as unchanged; and one JSON object of median
device times in ms, fp32 unless named, dropout 0.1 in training:

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
                      B=4, S=2048, causal; #7 also in bf16 (GPT AMP's
                      activations), and the 4-D op's backward
                      (attention_grads: #7 again for its lse, then #9
                      and #8) on [4, 12, 2048, 64] head views;
    #12, #13, #14     the ring-block kernels at the SP path's
                      [1, 12, 8192, 64], causal, offsets (0, 0);
    #2, #4            the residual LayerNorm forward and backward at
                      BERT's R=16384, N=768, the backward through its
                      wrapper, x, y and dO fp32, then bf16 (BERT AMP's
                      activations; g fp32), with "row" and "sum" its row
                      kernel and sum_partials apart; "row r=<n>" the row
                      kernel at n rows a row group (bwd_groups' constants
                      set for the call);
    #10, #11          the LayerNorm forward and backward at GPT AMP's
                      R=8192, N=768, bf16 then fp32 (scale of x's
                      dtype), the backward through its wrapper and its two
                      kernels apart; "#11 <dtype> R=<R> r=<n>" its row
                      kernel at R = 8192 and 16384 and n rows a group;
    sum_partials      alone at its users' shapes: [2, bwd_groups(8192),
                      768] (#11), [32, 12, 512] (#3/#6's dbias at BERT's
                      shape), [4, 12, 2048] (#8's dbias, the 4-D op past
                      S=1024) and [2, bwd_groups(16384), 768] (#4).

With --rows only the row libraries are built, digested and timed; with
--sass every library is built and digested and nothing is timed. Run
from an older checkout, the row timings take what it has (its own
groups' constants; #11's groups only where its wrapper has them). The
backward kernels are timed apart by CUDA events around each launch
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
from paddle_tpu_torch.kernels import fused_residual as fr  # noqa: E402
from paddle_tpu_torch.kernels import layer_norm as lnk  # noqa: E402
from paddle_tpu_torch.kernels import ring_block as rb  # noqa: E402
from paddle_tpu_torch.kernels import sum_partials as sp  # noqa: E402

H, D = 12, 64
PAIR = (("flash_attention", "flash_attention_bwd_dq"),
        ("flash_attention", "flash_attention_bwd_dkv"))
TILED = (("flash_tiled", "flash_tiled_bwd_dq"),
         ("flash_tiled", "flash_tiled_bwd_dkv"))
RING = (("ring_block", "ring_block_bwd_dq"),
        ("ring_block", "ring_block_bwd_dkv"))
LIBS = ("flash_attention", "flash_tiled", "ring_block")
ROW_LIBS = ("fused_dropout_add_ln", "layer_norm", "sum_partials")
RES_BWD = (("fused_dropout_add_ln", "fused_dropout_add_ln_bwd"),
           ("sum_partials", "sum_partials"))
LN_BWD = (("layer_norm", "layer_norm_bwd"), ("sum_partials", "sum_partials"))


def sass_digests(libs):
    """{kernel: (instances, SASS instructions, digest)} of every kernel of
    the libraries, the digest over its instances' SASS in the order of
    their mangled names. (The names themselves are left out: nvcc gives
    an unnamed namespace a prefix that differs between checkouts.)"""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    found = {}
    for lib in libs:
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            name = fn.split("\n", 1)[0].strip()
            kernel = re.search(r"\d([a-z_]+_kernel)[IE]", name)
            if kernel:
                # addresses out, and runs of blanks as one: cuobjdump
                # pads its columns to the widest line of the library
                body = [" ".join(re.sub(r"/\*[0-9a-f]+\*/", "",
                                        line).split())
                        for line in fn.splitlines()[1:] if "/*" in line]
                found.setdefault(kernel.group(1), []).append((name, body))
    out = {}
    for kernel, fns in found.items():
        h = hashlib.sha1()
        for _, body in sorted(fns):
            h.update("\n".join(body).encode() + b"\0")
        out[kernel] = (len(fns), sum(len(b) for _, b in fns),
                       h.hexdigest()[:10])
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
    xb = qkv.to(torch.bfloat16)
    res["#7 bf16"] = cs.cuda_ms(
        lambda: ft.flash_tiled_fwd(xb, None, cs.MASK_SEED, H, D, **tkw),
        iters=10, reps=5)
    q4, k4, v4 = (t.contiguous() for t in
                  qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4))
    do4 = torch.randn(B, H, S, D, generator=g, device="cuda")
    res["4-D bwd S=2048"] = cs.cuda_ms(
        lambda: fa.attention_grads(q4, k4, v4, None, do4, want_dbias=False,
                                   causal=True, **kw),
        iters=5, reps=3)
    del qkv, do, out, lse, xb, q4, k4, v4, do4
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


# the module that owns bwd_groups' constants: sum_partials since both
# row backwards share them, fused_residual in older checkouts
GROUPS_OWNER = sp if hasattr(sp, "BWD_GROUPS") else fr


def at_group_rows(rows, fn):
    """fn() with every row backward's groups set to `rows` rows."""
    kept = GROUPS_OWNER.BWD_GROUPS, GROUPS_OWNER.BWD_MIN_ROWS
    GROUPS_OWNER.BWD_GROUPS, GROUPS_OWNER.BWD_MIN_ROWS = 1 << 30, rows
    try:
        return fn()
    finally:
        GROUPS_OWNER.BWD_GROUPS, GROUPS_OWNER.BWD_MIN_ROWS = kept


def row_times():
    res = {}
    R, N = 32 * 512, 768
    rkw = dict(rate=0.1, is_test=False, eps=1e-5, seed=cs.MASK_SEED)
    x, y, g, c = cs.res_inputs(R, N, torch.float32, cs.SEED)
    do = torch.randn(R, N, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        xd, yd, dod = (t.to(dtype) for t in (x, y, do))
        res[f"#2 {name}"] = cs.cuda_ms(
            lambda: fr.fused_dropout_add_ln_fwd(xd, yd, g, c, **rkw))

        def bwd():
            return fr.fused_dropout_add_ln_bwd(xd, yd, g, dod, **rkw)

        res[f"#4 {name}"] = cs.cuda_ms(bwd)
        t = cs.launch_ms(bwd, RES_BWD, iters=20)
        res[f"#4 {name} row"] = t["fused_dropout_add_ln_bwd"]
        res[f"#4 {name} sum"] = t["sum_partials"]
        for rows in (8, 16, 32, 64, 128):
            res[f"#4 {name} row r={rows}"] = at_group_rows(
                rows, lambda: cs.launch_ms(bwd, RES_BWD, iters=20))[
                    "fused_dropout_add_ln_bwd"]
    del x, y, g, c, do
    Rl = cs.GPT_B * cs.GPT_S
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for R11 in (Rl, 2 * Rl):
            xl, dyl, s, b = cs.ln_inputs(R11, N, dtype, dtype, cs.SEED)

            def bwd():
                return lnk.layer_norm_bwd(xl, s, dyl, 1e-5)

            if R11 == Rl:
                res[f"#10 {name}"] = cs.cuda_ms(
                    lambda: lnk.layer_norm_fwd(xl, s, b, 1e-5))
                res[f"#11 {name}"] = cs.cuda_ms(bwd)
                t = cs.launch_ms(bwd, LN_BWD, iters=20)
                res[f"#11 {name} row"] = t["layer_norm_bwd"]
                res[f"#11 {name} sum"] = t["sum_partials"]
            if hasattr(lnk, "bwd_groups"):
                for rows in (8, 16, 32, 64):
                    res[f"#11 {name} R={R11} r={rows}"] = at_group_rows(
                        rows, lambda: cs.launch_ms(bwd, LN_BWD, iters=20))[
                            "layer_norm_bwd"]
    groups = GROUPS_OWNER.bwd_groups
    for shape in ((2, groups(Rl)[0], N), (32, 12, 512), (4, 12, 2048),
                  (2, groups(R)[0], N)):
        part = torch.randn(*shape, device="cuda")
        res[f"sum_partials {list(shape)}"] = cs.cuda_ms(
            lambda: sp.sum_partials(part))
    return res


def main():
    if not torch.cuda.is_available():
        print("torch_attn_times: no CUDA device is available",
              file=sys.stderr)
        return 1
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    rows_only = "--rows" in sys.argv[2:]
    libs = ROW_LIBS if rows_only else LIBS + ROW_LIBS
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(libs)
    print(f"[{tag}] {cs.gpu_line()}")
    for kernel, (k, n, digest) in sorted(sass_digests(libs).items()):
        print(f"[{tag}] sass {kernel}: {k} instances, {n} instructions, "
              f"{digest}")
    if "--sass" in sys.argv[2:]:
        return 0
    res = {}
    if not rows_only:
        res.update(times())
    res.update(row_times())
    print(f"[{tag}] " + json.dumps({k: round(v, 5) for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
