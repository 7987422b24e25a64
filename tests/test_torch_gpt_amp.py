"""Port parity for GPT training under AMP: bench.py's bench_gpt_longctx
program at GPT-tiny (B=2, S=64), decorated as bench.py's `_amp`
decorates it on an accelerator (bf16, static loss scale 1.0, layer_norm
and softmax white-listed), dropout 0, two Adam steps (lr 1e-3) by
paddle_tpu_torch and by the JAX package on the CPU from one carried
state, with FLAGS_paddle_tpu_pallas_layer_norm off (bench.py's default)
and on (the standalone LayerNorm's plain #10/#11 and the layer_norm_grad
op; that run is in test_torch_gpt_amp_layer_norm.py, so that each file
stays well under 20 s). Every op's runtime output dtype equals its
declared dtype.

Tolerances in bf16 terms (a bf16 unit is 2^-8 relative). The two
packages round at different places: the port rounds every op's output
to bf16, XLA on the CPU fuses elementwise chains in fp32 and rounds
once, and its attention reference runs in bf16 where the port's plain
attention computes in fp32. Measured on the CPU (flag off / on):
- loss: rtol 2^-12 (measured 0.003 units);
- every @GRAD: relative L2 error 2^-4 (16 units) of the JAX package's
  (measured 5.2 / 4.5 units); and the port's first-step @GRAD within
  2^-5 (8 units) of the JAX package's fp32 program's (measured 2.3 /
  2.1; the JAX package's own bf16 gradients lie 3.7 / 3.5 from it);
- Adam moments: relative L2 2^-3 (moment2 squares the gradient's error;
  measured 5.6 / 6.1 units); beta powers and the loss scale rtol 1e-6;
  good_steps and bad_steps equal;
- each parameter's update over the two steps (end - start) within 2^-4
  of (|update| + lr) (measured 8.3 / 7.8 units), but for elements whose
  two gradients differ by more than 2^-4 of the JAX package's at a step:
  Adam's first steps move a weight by about lr times the sign of its
  gradient, so such an element (a gradient that is rounding noise, as
  the key bias's, zero but for rounding) may move the other way. They
  are counted and must stay under 20% of the elements (measured 14.4% /
  14.8%).
The worst of each is printed.
"""

from test_torch_amp import (check_two_amp_steps,  # noqa: F401
                            flags_restored)


def test_two_amp_adam_steps_match_the_jax_package(flags_restored,
                                                  monkeypatch):
    """With the flag off, bench.py's default: the plain layer_norm, whose
    backward is the generic __vjp__ replay."""
    watch = check_two_amp_steps("gpt", False, monkeypatch)
    ins = watch.inputs
    # the activation stream reaches the kernels' ops in bf16
    assert ins["fused_qkv_attention"]["QKV"] == {"bfloat16"}
    assert ins["fused_qkv_attention_grad"]["OutGrad"] == {"bfloat16"}
    assert ins["layer_norm"] == {"X": {"bfloat16"}, "Scale": {"bfloat16"},
                                 "Bias": {"bfloat16"}}
    assert "layer_norm_grad" not in ins


def test_tiled_path_keeps_an_fp32_lse_under_amp(flags_restored):
    """At S=2048 (the KV-tiled kernels) the rewrite hands the attention a
    bf16 QKV, and the forward's saved Lse stays fp32 for the grad op."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_lm_loss
    from paddle_tpu_torch.optimizer import Adam
    from test_torch_amp import bench_amp

    cfg = GPTConfig.tiny()
    cfg.max_position = 2048
    main, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        ids = tf.data("ids", [1, 2048], "int64")
        loss = gpt_lm_loss(ids, cfg)
        bench_amp(mp, Adam(1e-3)).minimize(loss, startup)
    blk = main.global_block
    fwd = [op for op in blk.ops if op.type == "fused_qkv_attention"]
    grad = [op for op in blk.ops if op.type == "fused_qkv_attention_grad"]
    assert len(fwd) == len(grad) == cfg.num_layers
    for f, g in zip(fwd, reversed(grad)):  # the backward runs in reverse
        assert blk.var(f.inputs["QKV"][0]).dtype == "bfloat16"
        assert blk.var(f.outputs["Out"][0]).dtype == "bfloat16"
        assert blk.var(f.outputs["Lse"][0]).dtype == "float32"
        assert g.inputs["Lse"] == f.outputs["Lse"]
