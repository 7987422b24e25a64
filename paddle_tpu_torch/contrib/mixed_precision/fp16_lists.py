"""AMP op lists (counterpart of paddle_tpu/contrib/mixed_precision/
fp16_lists.py; reference contrib/mixed_precision/fp16_lists.py:28-39).
The lists are the JAX package's, verbatim.

white: compute in the low-precision dtype (matmuls, convolutions and the
attention kernels).
black: always compute in fp32 (reductions, losses, normalisations, where
low-precision accumulation visibly hurts).
gray (everything else): follow their inputs.

The default low dtype is bfloat16: fp32's exponent range, so loss scaling
is optional.
"""

WHITE_LIST = {
    "matmul",
    "mul",
    "bmm",
    "conv2d",
    "depthwise_conv2d",
    "conv2d_transpose",
    # attention kernels: bf16 in/out, fp32 softmax internally
    "fused_multihead_attention",
    "fused_qkv_attention",
}

BLACK_LIST = {
    # NOT softmax_with_cross_entropy: its emitter reduces in fp32 from
    # bf16 logits (ops/nn.py) — black-listing it forced a full fp32
    # [N, V] logits cast+materialization at LM heads
    "cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "mean",
    "reduce_mean",
    "reduce_sum",
    "sum",
    "exp",
    "log",
    "square",
    "layer_norm",
    "batch_norm",
    "group_norm",
    "instance_norm",
    "softmax",
    "log_softmax",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
