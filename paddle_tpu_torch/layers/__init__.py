"""fluid.layers-equivalent functional API: the layers of the serving and
training slices."""

from .attention import (  # noqa: F401
    fused_dropout_add_ln,
    fused_multihead_attention,
    fused_qkv_attention,
    ring_attention,
    ulysses_attention,
)
from .control_flow import increment  # noqa: F401
from .detection import multiclass_nms, yolo_box, yolov3_loss  # noqa: F401
from .functional_ext import pad2d, space_to_depth  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    linear_lr_warmup,
    polynomial_decay,
)
from .nn import (  # noqa: F401
    accuracy,
    adaptive_pool2d,
    batch_norm,
    conv2d,
    data,
    dropout,
    embedding,
    fc,
    layer_norm,
    mean,
    pool2d,
    resize_nearest,
    sigmoid_cross_entropy_with_logits,
    softmax_with_cross_entropy,
    sparse_embedding,
)
from .tensor import (  # noqa: F401
    cast,
    concat,
    elementwise_add,
    elementwise_div,
    elementwise_max,
    elementwise_min,
    elementwise_mul,
    elementwise_sub,
    fill_constant,
    gather,
    gelu,
    leaky_relu,
    less_than,
    matmul,
    not_equal,
    pow,
    range,
    reduce_mean,
    reduce_sum,
    relu,
    reshape,
    scale,
    sigmoid,
    slice,
    softmax,
    square,
    transpose,
    tril,
    triu,
)
