"""BERT encoder and MLM pretraining loss (counterpart of
paddle_tpu/models/bert.py), built on the port's layers API. The fused
paths are the port's: one packed-QKV attention op and one dropout +
residual + LayerNorm op per site; the composed paths
(use_fused_attention=False, use_fused_residual=False) build the same math
from plain ops."""

from __future__ import annotations

import math

from .. import layers
from ..initializer import Normal
from ..param_attr import ParamAttr


class BertConfig:
    def __init__(
        self,
        vocab_size=30522,
        hidden_size=768,
        num_layers=12,
        num_heads=12,
        intermediate_size=3072,
        max_position=512,
        type_vocab_size=2,
        hidden_dropout=0.1,
        attention_dropout=0.1,
        initializer_range=0.02,
        use_fused_attention=True,
        use_fused_residual=True,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.initializer_range = initializer_range
        self.use_fused_attention = use_fused_attention
        self.use_fused_residual = use_fused_residual

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny(cls):
        """For tests / dry runs: 2 layers, 128 hidden."""
        return cls(
            vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
            intermediate_size=512, max_position=128,
        )


def _init(cfg):
    return Normal(0.0, cfg.initializer_range)


def _dense(x, size, name, cfg, act=None):
    return layers.fc(
        x,
        size=size,
        num_flatten_dims=2,
        act=act,
        param_attr=ParamAttr(name=f"{name}_w", initializer=_init(cfg)),
        bias_attr=ParamAttr(name=f"{name}_b"),
    )


def _attention(x, attn_bias, cfg, prefix, is_test):
    b, s, h = x.shape
    nh, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    qkv = _dense(x, 3 * h, f"{prefix}_qkv", cfg)  # [B,S,3H] one matmul
    if cfg.use_fused_attention:
        # one op straight off the qkv matmul: the kernel reads the packed
        # projection in place; attn_bias is the [B,S] key mask
        ctxv = layers.fused_qkv_attention(
            qkv, nh, key_bias=attn_bias,
            scale=1.0 / math.sqrt(dh),
            dropout_prob=cfg.attention_dropout, is_test=is_test,
        )
        return _dense(ctxv, h, f"{prefix}_out", cfg)

    def head(t):
        return layers.transpose(layers.reshape(t, [b, s, nh, dh]), [0, 2, 1, 3])

    q = head(layers.slice(qkv, [2], [0], [h]))
    k = head(layers.slice(qkv, [2], [h], [2 * h]))
    v = head(layers.slice(qkv, [2], [2 * h], [3 * h]))
    scores = layers.matmul(q, k, transpose_y=True, alpha=1.0 / math.sqrt(dh))
    if attn_bias is not None:
        scores = scores + layers.reshape(attn_bias, [b, 1, 1, s])
    probs = layers.softmax(scores, axis=-1)
    probs = layers.dropout(
        probs, dropout_prob=cfg.attention_dropout, is_test=is_test
    )
    ctxv = layers.transpose(layers.matmul(probs, v), [0, 2, 1, 3])
    return _dense(layers.reshape(ctxv, [b, s, h]), h, f"{prefix}_out", cfg)


def _residual_ln(x, branch, cfg, ln_name, is_test):
    """LN(x + dropout(branch)): one fused op or the composed
    dropout/add/layer_norm ops — same math, same parameter names."""
    if cfg.use_fused_residual:
        return layers.fused_dropout_add_ln(
            x, branch, cfg.hidden_dropout, is_test=is_test,
            param_attr=ParamAttr(name=f"{ln_name}_scale"),
            bias_attr=ParamAttr(name=f"{ln_name}_bias"),
        )
    branch = layers.dropout(branch, cfg.hidden_dropout, is_test=is_test)
    return layers.layer_norm(
        x + branch,
        begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{ln_name}_scale"),
        bias_attr=ParamAttr(name=f"{ln_name}_bias"),
    )


def _encoder_layer(x, attn_bias, cfg, prefix, is_test):
    attn = _attention(x, attn_bias, cfg, f"{prefix}_attn", is_test)
    x = _residual_ln(x, attn, cfg, f"{prefix}_ln1", is_test)
    # tanh-approximate GELU, the original BERT formula
    ffn = _dense(x, cfg.intermediate_size, f"{prefix}_ffn_in", cfg)
    ffn = layers.gelu(ffn, approximate=True)
    ffn = _dense(ffn, cfg.hidden_size, f"{prefix}_ffn_out", cfg)
    return _residual_ln(x, ffn, cfg, f"{prefix}_ln2", is_test)


def _attn_bias(input_mask):
    """[B,S] float mask -> additive key-side attention bias [B,S]
    (0 keep, -1e4 mask)."""
    return layers.scale(input_mask, scale=1e4, bias=-1e4)


def bert_encoder_layers(x, input_mask, cfg, start=0, end=None, is_test=False):
    """Run encoder layers [start, end) over a [B,S,H] input."""
    attn_bias = _attn_bias(input_mask)
    end = cfg.num_layers if end is None else end
    for i in range(start, end):
        x = _encoder_layer(x, attn_bias, cfg, f"bert_l{i}", is_test)
    return x


def bert_encoder(input_ids, token_type_ids, input_mask, cfg, is_test=False,
                 num_layers=None):
    """input_ids/token_type_ids: [B,S] int64; input_mask: [B,S] float32.
    Returns the sequence output [B,S,H]; num_layers limits the stack."""
    b, s = input_ids.shape
    word_emb = layers.embedding(
        input_ids,
        size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="word_embedding", initializer=_init(cfg)),
    )
    pos_ids = layers.reshape(layers.range(0, s, 1, "int64"), [1, s])
    pos_emb = layers.embedding(
        pos_ids,
        size=[cfg.max_position, cfg.hidden_size],
        param_attr=ParamAttr(name="pos_embedding", initializer=_init(cfg)),
    )
    type_emb = layers.embedding(
        token_type_ids,
        size=[cfg.type_vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="type_embedding", initializer=_init(cfg)),
    )
    emb = word_emb + pos_emb + type_emb
    emb = layers.layer_norm(
        emb,
        begin_norm_axis=2,
        param_attr=ParamAttr(name="emb_ln_scale"),
        bias_attr=ParamAttr(name="emb_ln_bias"),
    )
    emb = layers.dropout(emb, cfg.hidden_dropout, is_test=is_test)
    n = cfg.num_layers if num_layers is None else num_layers
    return bert_encoder_layers(emb, input_mask, cfg, 0, n, is_test)


def _mlm_loss(rows, labels, label_shape, cfg):
    """Mean softmax cross-entropy of the vocab projection of `rows` [N, H]
    over the labels (reshaped to [N, 1]) that are not -100."""
    logits = layers.fc(
        rows,
        size=cfg.vocab_size,
        param_attr=ParamAttr(name="mlm_out_w", initializer=_init(cfg)),
        bias_attr=ParamAttr(name="mlm_out_b"),
    )
    labels = layers.reshape(labels, label_shape)
    loss = layers.softmax_with_cross_entropy(logits, labels, ignore_index=-100)
    # average over the masked positions only: ignored positions add zero
    # loss, so a plain mean would scale the loss by the masking ratio
    ignore = layers.fill_constant([1], "int64", -100)
    valid = layers.cast(layers.not_equal(labels, ignore), "float32")
    denom = layers.elementwise_max(
        layers.reduce_sum(valid), layers.fill_constant([1], "float32", 1.0)
    )
    return layers.elementwise_div(layers.reduce_sum(loss), denom)


def bert_mlm_head(seq, mlm_labels, cfg):
    """Masked-LM loss over the [B,S,H] sequence output; mlm_labels [B,S]
    int64 with ignore_index -100 on unmasked positions."""
    b, s, h = seq.shape
    return _mlm_loss(layers.reshape(seq, [b * s, h]), mlm_labels,
                     [b * s, 1], cfg)


def bert_mlm_head_gather(seq, mask_pos, mask_labels, cfg):
    """MLM head over the masked positions only: mask_pos [P] indexes the
    flattened [B*S] sequence and the vocab projection runs on those P
    rows; mask_labels [P] holds vocab ids with -100 padding."""
    b, s, h = seq.shape
    picked = layers.gather(layers.reshape(seq, [b * s, h]), mask_pos)
    return _mlm_loss(picked, mask_labels, [-1, 1], cfg)


def bert_pretrain(input_ids, token_type_ids, input_mask, mlm_labels, cfg,
                  is_test=False, mask_pos=None):
    """MLM pretraining loss (encoder + head). With mask_pos [P],
    mlm_labels is the gathered [P] label vector and the vocab projection
    runs only on the masked rows (bench.py's bench_bert program)."""
    seq = bert_encoder(input_ids, token_type_ids, input_mask, cfg, is_test)
    if mask_pos is not None:
        return bert_mlm_head_gather(seq, mask_pos, mlm_labels, cfg)
    return bert_mlm_head(seq, mlm_labels, cfg)
