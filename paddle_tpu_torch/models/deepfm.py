"""DeepFM CTR model (counterpart of paddle_tpu/models/deepfm.py).

Huge sparse id features -> first-order weights + FM second-order factor
interactions + a deep MLP tower. The tables are sparse_embedding lookups
(ops/sparse.py); the port runs them meshless, where the JAX package can
also row-shard them over the "ps" mesh axis.
"""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr


class DeepFMConfig:
    def __init__(self, vocab_size=100000, num_fields=10, embed_dim=16,
                 mlp_sizes=(64, 32), dense_dim=0):
        self.vocab_size = vocab_size
        self.num_fields = num_fields
        self.embed_dim = embed_dim
        self.mlp_sizes = tuple(mlp_sizes)
        # continuous features fed to BOTH the wide (linear) half and the
        # deep tower (the Criteo layout: 26 sparse + 13 dense)
        self.dense_dim = dense_dim

    @classmethod
    def criteo(cls):
        """The reference CTR benchmark shape (PaddleRec DeepFM on Criteo:
        26 sparse fields over a ~1M id space + 13 dense, d=10 factors,
        400x400x400 tower)."""
        return cls(vocab_size=1000000, num_fields=26, embed_dim=10,
                   mlp_sizes=(400, 400, 400), dense_dim=13)


def deepfm(feat_ids, label, cfg, axis="ps", dense_input=None,
           per_slot=False):
    """feat_ids: [B, F] int64 global feature ids; label: [B, 1] float32;
    dense_input: optional [B, dense_dim] float32 continuous features.
    Returns (avg_logloss, predict).

    The wide half is the FM itself — first-order sparse weights plus the
    factorized second-order term, which IS all pairwise feature crosses
    (sum_{i<j} <v_i, v_j> x_i x_j) without materializing the cross matrix;
    dense features get a linear wide term and join the deep tower input.

    ``per_slot=True`` builds the reference CTR layout (PaddleRec DeepFM:
    one embedding gather PER SPARSE SLOT against the shared global-id
    tables) — 2F+ lookup dispatch sites instead of 2, which is exactly the
    shape ``embedding.fuse_lookups`` coalesces back into one
    ``fused_lookup_table`` per table width. Numerically identical to the
    default layout."""
    b, f = feat_ids.shape

    if per_slot:
        # gather phase first (2F lookup sites, nothing reads them yet —
        # the layout fuse_lookups coalesces into one op per table width),
        # assembly phase after
        w1_raw, emb_raw = [], []
        for i in range(f):
            slot_ids = layers.slice(feat_ids, [1], [i], [i + 1])  # [B, 1]
            w1_raw.append(layers.sparse_embedding(
                slot_ids, [cfg.vocab_size, 1],
                param_attr=ParamAttr(name="deepfm_w1"), axis=axis,
            ))  # [B, 1]
            emb_raw.append(layers.sparse_embedding(
                slot_ids, [cfg.vocab_size, cfg.embed_dim],
                param_attr=ParamAttr(name="deepfm_emb"), axis=axis,
            ))  # [B, D]
        w1 = layers.concat(
            [layers.reshape(v, [b, 1, 1]) for v in w1_raw], axis=1
        )  # [B, F, 1]
        emb = layers.concat(
            [layers.reshape(v, [b, 1, cfg.embed_dim]) for v in emb_raw],
            axis=1,
        )  # [B, F, D]
    else:
        # first-order: sharded [V, 1] table
        w1 = layers.sparse_embedding(
            feat_ids, [cfg.vocab_size, 1],
            param_attr=ParamAttr(name="deepfm_w1"), axis=axis,
        )  # [B, F, 1]
        # factor embeddings: sharded [V, D] table
        emb = layers.sparse_embedding(
            feat_ids, [cfg.vocab_size, cfg.embed_dim],
            param_attr=ParamAttr(name="deepfm_emb"), axis=axis,
        )  # [B, F, D]
    first = layers.reduce_sum(layers.reshape(w1, [b, f]), 1, keep_dim=True)

    # FM second order: 0.5 * sum_d((sum_f v)^2 - sum_f v^2)
    sum_f = layers.reduce_sum(emb, 1)  # [B, D]
    sum_sq = layers.square(sum_f)
    sq_sum = layers.reduce_sum(layers.square(emb), 1)
    fm = layers.scale(
        layers.reduce_sum(sum_sq - sq_sum, 1, keep_dim=True), scale=0.5
    )

    # dense wide term (linear) + deep-tower concat
    wide_dense = None
    deep = layers.reshape(emb, [b, f * cfg.embed_dim])
    if dense_input is not None:
        wide_dense = layers.fc(
            dense_input, 1,
            param_attr=ParamAttr(name="deepfm_wide_w"),
            bias_attr=ParamAttr(name="deepfm_wide_b"),
        )
        deep = layers.concat([deep, dense_input], axis=1)
    for i, sz in enumerate(cfg.mlp_sizes):
        deep = layers.fc(
            deep, sz, act="relu",
            param_attr=ParamAttr(name=f"deepfm_mlp{i}_w"),
            bias_attr=ParamAttr(name=f"deepfm_mlp{i}_b"),
        )
    deep = layers.fc(
        deep, 1,
        param_attr=ParamAttr(name="deepfm_out_w"),
        bias_attr=ParamAttr(name="deepfm_out_b"),
    )

    logit = first + fm + deep
    if wide_dense is not None:
        logit = logit + wide_dense
    predict = layers.sigmoid(logit)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label)
    )
    return loss, predict
