"""The ERNIE-layout classifier the saved-model tests build with either
package (paddle_tpu or paddle_tpu_torch), and its feeds.

ERNIE 1.0's encoder (model/transformer_encoder.py, multi_head_attention)
projects query, key and value with three `fc`s, splits heads with
`reshape` + `transpose`, and attends; here the attention is one
`layers.fused_multihead_attention` op. The embeddings are bert_encoder's;
the [CLS] row goes to fc(2), softmax_with_cross_entropy and mean.
chip_smoke.py builds the same program on the card.
"""

import math

import numpy as np


def _attn_bias(layers, input_mask):
    """[B, S] float mask -> additive key bias (0 keep, -1e4 pad), as
    models/bert.py:_attn_bias makes it."""
    return layers.scale(input_mask, scale=1e4, bias=-1e4)


def _encoder_layer(fluid, layers, x, key_bias, cfg, S, prefix, is_test):
    nh = cfg.num_heads
    h = cfg.hidden_size
    dh = h // nh
    init = fluid.initializer.Normal(0.0, cfg.initializer_range)

    def dense(t, size, name, act=None):
        return layers.fc(
            t, size=size, num_flatten_dims=2, act=act,
            param_attr=fluid.ParamAttr(name=f"{name}_w", initializer=init),
            bias_attr=fluid.ParamAttr(name=f"{name}_b"))

    def heads(t):
        return layers.transpose(layers.reshape(t, [-1, S, nh, dh]),
                                [0, 2, 1, 3])

    q = heads(dense(x, h, f"{prefix}_query"))
    k = heads(dense(x, h, f"{prefix}_key"))
    v = heads(dense(x, h, f"{prefix}_value"))
    ctx = layers.fused_multihead_attention(
        q, k, v, key_bias, scale=1.0 / math.sqrt(dh),
        dropout_prob=cfg.attention_dropout, is_test=is_test)
    ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]), [-1, S, h])
    attn = dense(ctx, h, f"{prefix}_output")

    def residual_ln(a, branch, name):
        return layers.fused_dropout_add_ln(
            a, branch, cfg.hidden_dropout, is_test=is_test,
            param_attr=fluid.ParamAttr(name=f"{name}_scale"),
            bias_attr=fluid.ParamAttr(name=f"{name}_bias"))

    x = residual_ln(x, attn, f"{prefix}_post_att")
    ffn = layers.gelu(dense(x, cfg.intermediate_size, f"{prefix}_ffn_0"),
                      approximate=True)
    ffn = dense(ffn, h, f"{prefix}_ffn_1")
    return residual_ln(x, ffn, f"{prefix}_post_ffn")


def build_mha_classifier(fluid, layers, cfg, B, S, is_test):
    """(main, startup, loss, prob) of the classifier at batch B (-1: set
    at run time) and sequence S. Feeds: ids, types [B, S] int64, mask
    [B, S] float32, label [B, 1] int64. Call under unique_name.guard()
    with the optimizer, so both packages name every variable alike."""
    main, startup = fluid.Program(), fluid.Program()
    init = fluid.initializer.Normal(0.0, cfg.initializer_range)
    with fluid.program_guard(main, startup):
        ids = fluid.data("ids", [B, S], "int64")
        types = fluid.data("types", [B, S], "int64")
        mask = fluid.data("mask", [B, S], "float32")
        label = fluid.data("label", [B, 1], "int64")
        emb = layers.embedding(
            ids, size=[cfg.vocab_size, cfg.hidden_size],
            param_attr=fluid.ParamAttr(name="word_embedding",
                                       initializer=init))
        pos = layers.reshape(layers.range(0, S, 1, "int64"), [1, S])
        emb = emb + layers.embedding(
            pos, size=[cfg.max_position, cfg.hidden_size],
            param_attr=fluid.ParamAttr(name="pos_embedding",
                                       initializer=init))
        emb = emb + layers.embedding(
            types, size=[cfg.type_vocab_size, cfg.hidden_size],
            param_attr=fluid.ParamAttr(name="sent_embedding",
                                       initializer=init))
        x = layers.layer_norm(
            emb, begin_norm_axis=2,
            param_attr=fluid.ParamAttr(name="pre_encoder_layer_norm_scale"),
            bias_attr=fluid.ParamAttr(name="pre_encoder_layer_norm_bias"))
        x = layers.dropout(x, cfg.hidden_dropout, is_test=is_test)
        key_bias = _attn_bias(layers, mask)
        for i in range(cfg.num_layers):
            x = _encoder_layer(fluid, layers, x, key_bias, cfg, S,
                               f"encoder_layer_{i}", is_test)
        cls = layers.slice(x, [1], [0], [1])
        logits = layers.fc(
            cls, size=2,
            param_attr=fluid.ParamAttr(name="cls_out_w", initializer=init),
            bias_attr=fluid.ParamAttr(name="cls_out_b"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        prob = layers.softmax(logits)
    return main, startup, loss, prob


def mha_feed(cfg, B, S, seed):
    """One batch from numpy: random ids and types, a padded tail of keys in
    every other sample, random labels."""
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), np.float32)
    for b in range(1, B, 2):
        mask[b, S - 1 - (b * 7) % (S // 2):] = 0.0
    return {
        "ids": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64),
        "types": rng.randint(0, cfg.type_vocab_size, (B, S)).astype(np.int64),
        "mask": mask,
        "label": rng.randint(0, 2, (B, 1)).astype(np.int64),
    }
