"""GPT, a decoder-only causal LM (counterpart of paddle_tpu/models/gpt.py),
built on the port's layers API: a pre-LN transformer decoder whose causal
mask runs inside the packed-QKV attention kernels (causal=True; the
whole-row kernels up to S = 1024, the KV-tiled ones beyond), so no
[B, nh, S, S] mask or probability tensor reaches device memory. The
parameter names are the JAX package's, so a state carries across by name
(convert.py). The KV-cache serving programs (gpt_prefill,
gpt_decode_step) are driven by serving/generate.py.

`gpt_tp_shardings` (Megatron annotations) comes with tensor parallelism.
"""

from __future__ import annotations

import math

from .. import layers
from ..errors import InvalidArgumentError
from ..framework.program import default_main_program
from ..initializer import Normal
from ..layers.tensor import _simple
from ..param_attr import ParamAttr


class GPTConfig:
    def __init__(
        self,
        vocab_size=50257,
        hidden_size=768,
        num_layers=12,
        num_heads=12,
        intermediate_size=3072,
        max_position=1024,
        hidden_dropout=0.1,
        attention_dropout=0.1,
        initializer_range=0.02,
        use_fused_attention=True,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.initializer_range = initializer_range
        self.use_fused_attention = use_fused_attention

    @classmethod
    def small(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(
            vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
            intermediate_size=256, max_position=128,
        )


def _init(cfg):
    return Normal(0.0, cfg.initializer_range)


def _dense(x, size, name, cfg, act=None):
    return layers.fc(
        x, size=size, num_flatten_dims=2, act=act,
        param_attr=ParamAttr(name=f"{name}_w", initializer=_init(cfg)),
        bias_attr=ParamAttr(name=f"{name}_b"),
    )


def _ln(x, name):
    return layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{name}_scale"),
        bias_attr=ParamAttr(name=f"{name}_bias"),
    )


def _decoder_layer(x, cfg, prefix, is_test):
    b, s, h = x.shape
    nh, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    # pre-LN attention block
    a = _ln(x, f"{prefix}_ln1")
    qkv = _dense(a, 3 * h, f"{prefix}_attn_qkv", cfg)
    if cfg.use_fused_attention:
        ctxv = layers.fused_qkv_attention(
            qkv, nh, causal=True, scale=1.0 / math.sqrt(dh),
            dropout_prob=cfg.attention_dropout, is_test=is_test,
        )
    else:
        def head(t):
            return layers.transpose(
                layers.reshape(t, [b, s, nh, dh]), [0, 2, 1, 3]
            )

        q = head(layers.slice(qkv, [2], [0], [h]))
        k = head(layers.slice(qkv, [2], [h], [2 * h]))
        v = head(layers.slice(qkv, [2], [2 * h], [3 * h]))
        scores = layers.matmul(
            q, k, transpose_y=True, alpha=1.0 / math.sqrt(dh)
        )
        # causal additive mask: 0 on/below the diagonal, -1e4 above
        mask = layers.reshape(
            layers.scale(
                layers.tril(layers.fill_constant([s, s], "float32", 1.0)),
                scale=1e4, bias=-1e4,
            ),
            [1, 1, s, s],
        )
        scores = scores + mask
        probs = layers.softmax(scores, axis=-1)
        probs = layers.dropout(
            probs, cfg.attention_dropout, is_test=is_test
        )
        ctxv = layers.reshape(
            layers.transpose(layers.matmul(probs, v), [0, 2, 1, 3]),
            [b, s, h],
        )
    attn = _dense(ctxv, h, f"{prefix}_attn_out", cfg)
    x = x + layers.dropout(attn, cfg.hidden_dropout, is_test=is_test)
    # pre-LN MLP block
    m = _ln(x, f"{prefix}_ln2")
    # tanh-approximate GELU, GPT-2's formula
    m = _dense(m, cfg.intermediate_size, f"{prefix}_mlp_in", cfg)
    m = layers.gelu(m, approximate=True)
    m = _dense(m, cfg.hidden_size, f"{prefix}_mlp_out", cfg)
    return x + layers.dropout(m, cfg.hidden_dropout, is_test=is_test)


def gpt_decoder(input_ids, cfg, is_test=False):
    """input_ids [B, S] int64 -> final hidden states [B, S, H]."""
    b, s = input_ids.shape
    tok = layers.embedding(
        input_ids, size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="wte", initializer=_init(cfg)),
    )
    pos_ids = layers.reshape(layers.range(0, s, 1, "int64"), [1, s])
    pos = layers.embedding(
        pos_ids, size=[cfg.max_position, cfg.hidden_size],
        param_attr=ParamAttr(name="wpe", initializer=_init(cfg)),
    )
    x = layers.dropout(tok + pos, cfg.hidden_dropout, is_test=is_test)
    for i in range(cfg.num_layers):
        x = _decoder_layer(x, cfg, f"gpt_l{i}", is_test)
    return _ln(x, "gpt_lnf")


def _lm_head(hidden, cfg):
    """The (shared-name) vocab projection every GPT graph variant uses —
    one definition so the `lm_head_w` checkpoint contract cannot drift."""
    return layers.fc(
        hidden, cfg.vocab_size, num_flatten_dims=2, bias_attr=False,
        param_attr=ParamAttr(name="lm_head_w", initializer=_init(cfg)),
    )


def gpt_lm_loss(input_ids, cfg, is_test=False, labels=None):
    """Next-token LM loss; labels default to input_ids shifted left (the
    final position predicts nothing and is dropped)."""
    b, s = input_ids.shape
    hidden = gpt_decoder(input_ids, cfg, is_test=is_test)
    # slice the HIDDEN states, not the logits: slicing after the vocab
    # projection copies a [B, S, V] tensor (~0.5 GB at S=2048/V=32k);
    # slicing before it is a [B, S, H] copy and the head matmul computes
    # only the s-1 predicted positions
    pred_h = layers.slice(hidden, [1], [0], [s - 1])
    pred = _lm_head(pred_h, cfg)
    if labels is None:
        tgt = layers.slice(input_ids, [1], [1], [s])
    else:
        tgt = layers.slice(labels, [1], [1], [s])
    loss = layers.softmax_with_cross_entropy(
        layers.reshape(pred, [b * (s - 1), cfg.vocab_size]),
        layers.reshape(tgt, [b * (s - 1), 1]),
    )
    return layers.mean(loss)


def gpt_logits(input_ids, cfg, is_test=True):
    """Full-context logits [B, S, V] — the serving/full-recompute head
    (no label shift, no loss): every position's next-token distribution."""
    hidden = gpt_decoder(input_ids, cfg, is_test=is_test)
    return _lm_head(hidden, cfg)


# --- KV-cache serving graphs (prefill + single-token decode) ---------------
#
# Generation through the training graph re-runs the whole context every
# token. The serving split keeps each layer's K/V rows in persistable scope
# vars shared BETWEEN two programs: a prefill program that embeds the full
# context once and fills the cache, and a single-token decode program that
# appends one K/V row and attends over the cache. Parameter names match
# gpt_decoder/gpt_logits exactly, so one state serves either graph
# (serving/generate.py drives the pair).


def gpt_cache_names(cfg):
    """The persistable cache var names both serving programs share."""
    out = []
    for i in range(cfg.num_layers):
        out += [f"gpt_l{i}_cache_k", f"gpt_l{i}_cache_v"]
    return out


def _cache_var(name, batch, max_len, hidden):
    blk = default_main_program().global_block
    if blk.has_var(name):
        return blk.var(name)
    return blk.create_var(
        name=name, shape=(batch, max_len, hidden), dtype="float32",
        persistable=True,
    )


def _cached_decoder_layer(x, cfg, prefix, write_pos, attend_pos, max_len):
    """Pre-LN decoder layer routed through the layer's KV cache: write this
    call's K/V rows at `write_pos`, attend Q over the cache up to
    `attend_pos` (inclusive). Dropout sites keep their test-mode
    ``downgrade_in_infer`` (1 - p) scaling so outputs match the training
    graph's ``is_test`` numerics (the freeze-parity contract)."""
    b, t, h = x.shape
    nh, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    a = _ln(x, f"{prefix}_ln1")
    qkv = _dense(a, 3 * h, f"{prefix}_attn_qkv", cfg)
    q = layers.slice(qkv, [2], [0], [h])
    k = layers.slice(qkv, [2], [h], [2 * h])
    v = layers.slice(qkv, [2], [2 * h], [3 * h])
    ck = _cache_var(f"{prefix}_cache_k", b, max_len, h)
    cv = _cache_var(f"{prefix}_cache_v", b, max_len, h)
    blk = default_main_program().global_block
    for cache, rows in ((ck, k), (cv, v)):
        blk.append_op(
            "kv_cache_write",
            {"Cache": [cache.name], "X": [rows.name],
             "Pos": [write_pos.name]},
            {"Out": [cache.name]},
        )
    ctxv = _simple(
        "kv_cache_attention",
        {"Q": [q], "CacheK": [ck], "CacheV": [cv], "Pos": [attend_pos]},
        {"num_heads": nh, "scale": 1.0 / math.sqrt(dh),
         "prob_scale": 1.0 - cfg.attention_dropout},
    )
    attn = _dense(ctxv, h, f"{prefix}_attn_out", cfg)
    x = x + layers.dropout(attn, cfg.hidden_dropout, is_test=True)
    m = _ln(x, f"{prefix}_ln2")
    m = _dense(m, cfg.intermediate_size, f"{prefix}_mlp_in", cfg)
    m = layers.gelu(m, approximate=True)
    m = _dense(m, cfg.hidden_size, f"{prefix}_mlp_out", cfg)
    return x + layers.dropout(m, cfg.hidden_dropout, is_test=True)


def gpt_prefill(context_ids, cfg, max_len):
    """Prefill graph body: embed the full [B, S] context, fill every
    layer's KV cache rows 0..S-1, and return the LAST position's
    next-token logits [B, 1, V]. `max_len` bounds the cache (must cover
    context + generated tokens; <= cfg.max_position)."""
    b, s = context_ids.shape
    if max_len > cfg.max_position:
        raise InvalidArgumentError(
            f"max_len {max_len} exceeds cfg.max_position {cfg.max_position}"
        )
    tok = layers.embedding(
        context_ids, size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="wte", initializer=_init(cfg)),
    )
    pos_ids = layers.reshape(layers.range(0, s, 1, "int64"), [1, s])
    pos = layers.embedding(
        pos_ids, size=[cfg.max_position, cfg.hidden_size],
        param_attr=ParamAttr(name="wpe", initializer=_init(cfg)),
    )
    x = layers.dropout(tok + pos, cfg.hidden_dropout, is_test=True)
    write_pos = layers.fill_constant([1], "int32", 0)
    attend_pos = layers.fill_constant([1], "int32", s - 1)
    for i in range(cfg.num_layers):
        x = _cached_decoder_layer(
            x, cfg, f"gpt_l{i}", write_pos, attend_pos, max_len
        )
    x = _ln(x, "gpt_lnf")
    last_h = layers.slice(x, [1], [s - 1], [s])
    return _lm_head(last_h, cfg)


def gpt_decode_step(token_ids, pos_ids, cfg, max_len):
    """Single-token decode graph body: embed the [B, 1] token at position
    `pos_ids` ([1, 1] int64 feed), append its K/V rows to every layer's
    cache at that position, attend over the cache, and return next-token
    logits [B, 1, V]. Run repeatedly with the same shapes."""
    b = token_ids.shape[0]
    # [B, 1] ids hit the v1 lookup_table (trailing-1 squeeze): restore the
    # [B, T=1, H] layout the layer stack expects
    tok = layers.reshape(
        layers.embedding(
            token_ids, size=[cfg.vocab_size, cfg.hidden_size],
            param_attr=ParamAttr(name="wte", initializer=_init(cfg)),
        ),
        [b, 1, cfg.hidden_size],
    )
    pos = layers.reshape(
        layers.embedding(
            pos_ids, size=[cfg.max_position, cfg.hidden_size],
            param_attr=ParamAttr(name="wpe", initializer=_init(cfg)),
        ),
        [1, 1, cfg.hidden_size],
    )
    x = layers.dropout(tok + pos, cfg.hidden_dropout, is_test=True)
    for i in range(cfg.num_layers):
        x = _cached_decoder_layer(
            x, cfg, f"gpt_l{i}", pos_ids, pos_ids, max_len
        )
    x = _ln(x, "gpt_lnf")
    return _lm_head(x, cfg)
