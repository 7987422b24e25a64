"""Port parity for GPT training at S=4096, the length of bench.py's
gpt_s4096 leg: GPT-tiny with max_position=4096, B=1, two Adam steps
against the JAX package on the CPU, with the inputs and tolerances of
test_torch_gpt_training.py. In the port the attention takes the KV-tiled
path, whose forward saves Out and Lse for the grad op; the JAX package on
the CPU runs its jnp reference."""

from test_torch_gpt_training import check_two_adam_steps


def test_two_adam_steps_at_s4096_match_the_jax_package():
    check_two_adam_steps(1, 4096, 4096, tiled=True)
