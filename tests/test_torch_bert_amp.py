"""Port parity for BERT training under AMP: bench.py's bench_bert program
at BERT-tiny (B=4, S=64, P=38), decorated as bench.py's `_amp` decorates
it on an accelerator (bf16, static loss scale 1.0, layer_norm and softmax
white-listed), dropout 0, two Adam steps (lr 1e-3) by paddle_tpu_torch
and by the JAX package on the CPU from one carried state. Every op's
runtime output dtype equals its declared dtype, and the fused ops behind
kernels #1-#4 receive what the kernels take: a bf16 QKV for the
attention, bf16 x and y with fp32 Scale and LnBias for the residual
LayerNorm (the rewrite's _GRAY_SLOT_KEEP), and a bf16 output gradient
for both grad ops.

Tolerances in bf16 terms, as test_torch_gpt_amp.py states them (a bf16
unit is 2^-8 relative). Measured on the CPU: loss 0.001 units (bound
2^-12); @GRAD relative L2 11.3 units of the JAX package's (bound 2^-4):
the JAX package's attention reference runs in bf16, and its own fp32
program is 11.4 units from its bf16 one, where the port's bf16
gradients lie 1.7 units from that fp32 program (bound 2^-5); moments
17.2 units (bound 2^-3); updates of the elements whose gradients agree
within 2^-4, 9.2 units of (|update| + lr) (bound 2^-4), exempt 7.1% of
the elements (cap 20%).
"""

from test_torch_amp import (check_two_amp_steps,  # noqa: F401
                            flags_restored)


def test_two_amp_adam_steps_match_the_jax_package(flags_restored,
                                                  monkeypatch):
    ins = check_two_amp_steps("bert", False, monkeypatch).inputs
    assert ins["fused_qkv_attention"] == {"QKV": {"bfloat16"},
                                          "KeyBias": {"bfloat16"}}
    assert ins["fused_qkv_attention_grad"]["OutGrad"] == {"bfloat16"}
    assert ins["fused_dropout_add_ln"] == {
        "X": {"bfloat16"}, "Y": {"bfloat16"}, "Scale": {"float32"},
        "LnBias": {"float32"}}
    assert ins["fused_dropout_add_ln_grad"] == {
        "X": {"bfloat16"}, "Y": {"bfloat16"}, "Scale": {"float32"},
        "LnBias": {"float32"}, "OutGrad": {"bfloat16"}}
