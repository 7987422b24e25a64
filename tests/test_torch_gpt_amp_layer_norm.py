"""Port parity for GPT training under AMP with
FLAGS_paddle_tpu_pallas_layer_norm on: the run of
test_torch_gpt_amp.py (the same program, steps and tolerances; see its
docstring) with the standalone LayerNorm's plain #10/#11 in the forward
and the dedicated layer_norm_grad op in the backward, each LN fed bf16
x, scale and bias as the rewrite white-lists layer_norm.
"""

from test_torch_amp import (check_two_amp_steps,  # noqa: F401
                            flags_restored)


def test_two_amp_adam_steps_with_the_flag_match_the_jax_package(
        flags_restored, monkeypatch):
    watch = check_two_amp_steps("gpt", True, monkeypatch)
    ins = watch.inputs
    assert ins["layer_norm"] == {"X": {"bfloat16"}, "Scale": {"bfloat16"},
                                 "Bias": {"bfloat16"}}
    assert ins["layer_norm_grad"] == {
        "X": {"bfloat16"}, "Scale": {"bfloat16"}, "Bias": {"bfloat16"},
        "YGrad": {"bfloat16"}}
    assert ins["fused_qkv_attention"]["QKV"] == {"bfloat16"}
