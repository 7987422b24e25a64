"""Port parity of the plain KV-tiled attention against the JAX package's
Pallas kernels in interpret mode and its jnp reference, at S = 384 (three
tiles of 128 in the JAX kernels): the cases of test_torch_flash_tiled.py
that do not fit its time, with its inputs and tolerances."""

import pytest

from test_torch_flash_tiled import check_against_the_jax_package
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("B,S,causal", [(1, 384, True), (2, 384, False)])
def test_plain_tiled_matches_pallas_interpret_and_reference_at_s384(B, S,
                                                                    causal):
    check_against_the_jax_package(B, S, causal)
