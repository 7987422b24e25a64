"""Activation ops of the port's slices (counterpart of
paddle_tpu/ops/activation.py; reference operators/activation_op.cc)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.registry import register_op


@register_op("relu", inputs=["X"], outputs=["Out"])
def _relu(ctx, op, ins):
    return {"Out": [torch.relu(ins["X"][0])]}


@register_op("leaky_relu", inputs=["X"], outputs=["Out"])
def _leaky_relu(ctx, op, ins):
    # alpha defaults to the JAX package's 0.02 (torch's is 0.01); the
    # gradient at exactly 0 is alpha here, 1 in jax.nn.leaky_relu
    return {"Out": [F.leaky_relu(ins["X"][0], op.attr("alpha", 0.02))]}


@register_op("gelu", inputs=["X"], outputs=["Out"])
def _gelu(ctx, op, ins):
    approximate = "tanh" if op.attr("approximate", False) else "none"
    return {"Out": [F.gelu(ins["X"][0], approximate=approximate)]}


@register_op("softmax", inputs=["X"], outputs=["Out"])
def _softmax(ctx, op, ins):
    return {"Out": [torch.softmax(ins["X"][0], dim=op.attr("axis", -1))]}


@register_op("sigmoid", inputs=["X"], outputs=["Out"])
def _sigmoid(ctx, op, ins):
    return {"Out": [torch.sigmoid(ins["X"][0])]}


@register_op("tanh", inputs=["X"], outputs=["Out"])
def _tanh(ctx, op, ins):
    return {"Out": [torch.tanh(ins["X"][0])]}
