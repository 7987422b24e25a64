"""Port parity for GPT training at S=2048: GPT-tiny with max_position=2048,
B=1, two Adam steps against the JAX package on the CPU, with the inputs
and tolerances of test_torch_gpt_training.py. In the port the attention
takes the KV-tiled path, whose forward saves Out and Lse for the grad op;
the JAX package on the CPU runs its jnp reference."""

from test_torch_gpt_training import check_two_adam_steps


def test_two_adam_steps_at_s2048_match_the_jax_package():
    check_two_adam_steps(1, 2048, 2048, tiled=True)
