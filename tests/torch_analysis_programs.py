"""The programs the analysis parity tests walk, built from one code path
in both packages (graph only: no startup run, no arrays):

- bench.py's bench_gpt_longctx program at GPT-small full width (V=32000,
  hidden 768, 12 layers, 12 heads), max_position = S, Adam(1e-4) under
  bench.py's `_amp`, for its accelerator legs gpt_s4096 (B=2) and
  gpt_s8192 (B=1);
- bench.py's bench_bert program at BertConfig.base(), B=32, S=512, P=2457,
  Adam under linear warmup over polynomial decay, under `_amp`;
- bench.py's bench_resnet program at the port's test size (ResNet-18,
  3x32x32, B=4, 10 classes, Momentum(1e-3, 0.9));
- bench.py's deepfm program at its CPU config (DeepFMConfig(1000, 6, 8,
  (16,), 4), B=64, Adam(1e-3)).

`pair(name)` returns the two main programs and the feed shapes;
`PROGRAMS` names them. Each program is built once a process.

The JAX package picks the KV-tiled attention by its backend
(paddle_tpu/kernels/flash_attention.py:uses_tiled_path reads
jax.default_backend()) and the port by shape alone, so on the CPU the JAX
package would build the GPT legs without the forward's saved Out and Lse.
Its GPT programs are built as on a TPU, where bench.py runs those legs:
with jax.default_backend answering "tpu" while the graph is built (shape
inference runs the emitters abstractly; nothing is compiled or run).

Two kinds of declaration differ between the packages' programs by design,
and `pair` rewrites the JAX program's declarations of them to the port's
before the tests compare (it fails on any other difference, naming it):
- integers: the JAX package runs without x64, so what an emitter makes
  as int64 (`range`'s ids, `fill_constant`, a reshape of int64 labels)
  it declares int32; the port keeps int64 (ROADMAP, parity method);
- the KV-tiled forward's Lse: the TPU kernel writes the row logsumexp
  broadcast over the lanes, [B, S, H*D] fp32
  (paddle_tpu/kernels/flash_tiled.py:225), the port's CUDA kernel
  [B, H, S] fp32 (paddle_tpu_torch/kernels/flash_tiled.py).
Every other declaration, every op and every attribute the cost model and
the memory plan read are then the same, so their numbers must be too.
"""

import contextlib
import functools

import jax

import paddle_tpu as jf
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import bert_pretrain as jbert_pretrain
from paddle_tpu.models.deepfm import DeepFMConfig as JDeepFMConfig
from paddle_tpu.models.deepfm import deepfm as jdeepfm
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_lm_loss as jgpt_lm_loss
from paddle_tpu.models.resnet import resnet_train_net as jresnet_train_net

import paddle_tpu_torch as tf
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import DeepFMConfig as TDeepFMConfig
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.models import resnet_train_net as tresnet_train_net
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import bert_pretrain as tbert_pretrain
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import gpt_lm_loss as tgpt_lm_loss
from test_torch_amp import bench_amp  # bench.py's `_amp`

JAX = dict(fluid=jf, unique_name=jun, mp=jmp,
           gpt=(JGPTConfig, jgpt_lm_loss), bert=(JBertConfig, jbert_pretrain),
           resnet=jresnet_train_net, deepfm=(JDeepFMConfig, jdeepfm))
PORT = dict(fluid=tf, unique_name=tf.unique_name, mp=tmp,
            gpt=(TGPTConfig, tgpt_lm_loss), bert=(TBertConfig, tbert_pretrain),
            resnet=tresnet_train_net, deepfm=(TDeepFMConfig, tdeepfm))
PROGRAMS = ("gpt_s4096", "gpt_s8192", "bert_base", "resnet18", "deepfm")
LEGS = {"gpt_s4096": (2, 4096), "gpt_s8192": (1, 8192)}


def _gpt(pkg, B, S):
    fluid = pkg["fluid"]
    cfg_cls, lm_loss = pkg["gpt"]
    cfg = cfg_cls(vocab_size=32000, hidden_size=768, num_layers=12,
                  num_heads=12, intermediate_size=3072, max_position=S)
    ids = fluid.data("ids", [B, S], "int64")
    loss = lm_loss(ids, cfg)
    bench_amp(pkg["mp"], fluid.optimizer.Adam(1e-4)).minimize(loss)
    return {"ids": (B, S)}


def _bert(pkg):
    fluid = pkg["fluid"]
    cfg_cls, pretrain = pkg["bert"]
    B, S = 32, 512
    P = max(1, int(0.15 * B * S))
    ids = fluid.data("ids", [B, S], "int64")
    types = fluid.data("types", [B, S], "int64")
    mask = fluid.data("mask", [B, S], "float32")
    mask_pos = fluid.data("mask_pos", [P], "int64")
    labels = fluid.data("labels", [P], "int64")
    loss = pretrain(ids, types, mask, labels, cfg_cls.base(),
                    mask_pos=mask_pos)
    layers = fluid.layers
    lr = layers.linear_lr_warmup(
        layers.polynomial_decay(1e-4, 100000, 1e-5), 1000, 0.0, 1e-4)
    bench_amp(pkg["mp"], fluid.optimizer.Adam(lr)).minimize(loss)
    return {"ids": (B, S), "types": (B, S), "mask": (B, S),
            "mask_pos": (P,), "labels": (P,)}


def _resnet(pkg):
    fluid, B = pkg["fluid"], 4
    image = fluid.data("image", [B, 3, 32, 32])
    label = fluid.data("label", [B, 1], "int64")
    loss, _ = pkg["resnet"](image, label, depth=18, class_num=10)
    fluid.optimizer.Momentum(1e-3, 0.9).minimize(loss)
    return {"image": (B, 3, 32, 32), "label": (B, 1)}


def _deepfm(pkg):
    fluid, B = pkg["fluid"], 64
    cfg_cls, deepfm = pkg["deepfm"]
    cfg = cfg_cls(vocab_size=1000, num_fields=6, embed_dim=8,
                  mlp_sizes=(16,), dense_dim=4)
    feat = fluid.data("feat", [B, cfg.num_fields], "int64")
    dense = fluid.data("dense", [B, cfg.dense_dim], "float32")
    label = fluid.data("label", [B, 1], "float32")
    loss, _ = deepfm(feat, label, cfg, dense_input=dense)
    fluid.optimizer.Adam(1e-3).minimize(loss)
    return {"feat": (B, 6), "dense": (B, 4), "label": (B, 1)}


@contextlib.contextmanager
def _as_on_a_tpu():
    real = jax.default_backend
    jax.default_backend = lambda: "tpu"
    try:
        yield
    finally:
        jax.default_backend = real


@functools.cache
def _built(which, name):
    pkg = JAX if which == "jax" else PORT
    fluid = pkg["fluid"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    backend = (_as_on_a_tpu() if which == "jax" and name in LEGS
               else contextlib.nullcontext())
    with pkg["unique_name"].guard(), fluid.program_guard(main, startup), \
            backend:
        if name in LEGS:
            feeds = _gpt(pkg, *LEGS[name])
        else:
            feeds = {"bert_base": _bert, "resnet18": _resnet,
                     "deepfm": _deepfm}[name](pkg)
    return main, feeds


def _by_design(name, jv, tv):
    """Whether the declarations jv (JAX) and tv (port) of `name` differ
    in one of the two ways the module docstring lists."""
    if jv.dtype == "int32" and tv.dtype == "int64":
        return tuple(jv.shape) == tuple(tv.shape)
    if name.startswith("fused_qkv_attention.lse_"):
        B, H, S = tv.shape
        return (jv.dtype == tv.dtype == "float32"
                and tuple(jv.shape[:2]) == (B, S))
    return False


@functools.cache
def pair(name):
    """(JAX package's main program, the port's, feed shapes) of program
    `name`, the JAX program's declarations that differ by design rewritten
    to the port's; fails on any other difference."""
    jmain, feeds = _built("jax", name)
    tmain, tfeeds = _built("port", name)
    assert feeds == tfeeds
    jvars = {v.name: v for v in jmain.list_vars()}
    tvars = {v.name: v for v in tmain.list_vars()}
    assert set(jvars) == set(tvars), set(jvars) ^ set(tvars)
    other = []
    for n, tv in tvars.items():
        jv = jvars[n]
        if (jv.dtype, tuple(jv.shape or ())) == (tv.dtype,
                                                 tuple(tv.shape or ())):
            continue
        if not _by_design(n, jv, tv):
            other.append((n, jv.dtype, jv.shape, tv.dtype, tv.shape))
            continue
        jv.dtype, jv.shape = tv.dtype, tuple(tv.shape)
    assert not other, other
    return jmain, tmain, feeds
