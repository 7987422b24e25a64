"""ResNet v1.5 (18/34/50/101/152), the image-classification flagship
(counterpart of paddle_tpu/models/resnet.py; reference
python/paddle/fluid/tests/book/test_image_classification.py, scaled to
ResNet-50 on ImageNet). NCHW at the API, as fluid's; the convolutions run
through F.conv2d and batch norm through the JAX package's formula
(ops/nn.py)."""

from __future__ import annotations

from .. import layers

_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _conv_bn(x, num_filters, filter_size, stride=1, act=None,
             is_test=False, padding=None):
    conv = layers.conv2d(
        x,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2 if padding is None else padding,
        bias_attr=False,
    )
    return layers.batch_norm(conv, act=act, is_test=is_test)


def _shortcut(x, num_filters, stride, is_test):
    if x.shape[1] != num_filters or stride != 1:
        return _conv_bn(x, num_filters, 1, stride, is_test=is_test)
    return x


def _basic_block(x, num_filters, stride, is_test):
    y = _conv_bn(x, num_filters, 3, stride, act="relu", is_test=is_test)
    y = _conv_bn(y, num_filters, 3, 1, is_test=is_test)
    short = _shortcut(x, num_filters, stride, is_test)
    return layers.relu(y + short)


def _bottleneck_block(x, num_filters, stride, is_test):
    y = _conv_bn(x, num_filters, 1, 1, act="relu", is_test=is_test)
    y = _conv_bn(y, num_filters, 3, stride, act="relu", is_test=is_test)
    y = _conv_bn(y, num_filters * 4, 1, 1, is_test=is_test)
    short = _shortcut(x, num_filters * 4, stride, is_test)
    return layers.relu(y + short)


def resnet(image, class_num=1000, depth=50, is_test=False,
           space_to_depth_stem=False):
    """Build ResNet; returns logits. image: NCHW float var.

    space_to_depth_stem: MLPerf ResNet's stem transform: space-to-depth(2)
    turns the input into [N, 12, H/2, W/2] (channels in (bh, bw, c)
    order) and a 4x4/s1 conv reads it in place of the 7x7/s2 conv on 3
    channels. The 4x4x12 kernel subsumes the 7x7x3 one at even
    alignments, so it trains to the same accuracy; checkpoints of one
    stem do not load into the other."""
    if depth not in _DEPTH_CFG:
        raise ValueError(f"unsupported depth {depth}; pick {sorted(_DEPTH_CFG)}")
    block_kind, counts = _DEPTH_CFG[depth]
    block = _basic_block if block_kind == "basic" else _bottleneck_block

    if space_to_depth_stem:
        x = layers.space_to_depth(image, blocksize=2)
        # SAME for the even 4-wide kernel needs asymmetric total pad 3
        # (symmetric (4-1)//2 would shrink the map to 111x111 and starve
        # the border pixels of full kernel support)
        x = layers.pad2d(x, paddings=[1, 2, 1, 2])
        x = _conv_bn(x, 64, 4, stride=1, act="relu", is_test=is_test,
                     padding=0)
    else:
        x = _conv_bn(image, 64, 7, stride=2, act="relu", is_test=is_test)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    num_filters = [64, 128, 256, 512]
    for stage, n_blocks in enumerate(counts):
        for i in range(n_blocks):
            stride = 2 if i == 0 and stage > 0 else 1
            x = block(x, num_filters[stage], stride, is_test)
    x = layers.pool2d(x, global_pooling=True, pool_type="avg")
    return layers.fc(x, size=class_num)


def resnet_train_net(image, label, depth=50, class_num=1000,
                     space_to_depth_stem=False):
    """logits -> (avg softmax-CE loss, top-1 accuracy)."""
    logits = resnet(image, class_num=class_num, depth=depth,
                    space_to_depth_stem=space_to_depth_stem)
    loss = layers.softmax_with_cross_entropy(logits, label)
    avg_loss = layers.reduce_mean(loss)
    acc = layers.accuracy(layers.softmax(logits), label)
    return avg_loss, acc
