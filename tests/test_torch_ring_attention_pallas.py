"""Port parity of sequence-parallel attention on an sp=4 mesh against the
JAX package's Pallas ring-block kernels in interpret mode: the non-causal
ring and the causal Ulysses cases of test_torch_ring_attention.py (which
describes the method and tolerances), with its inputs."""

import pytest

from test_torch_ring_attention import check, ranks  # noqa: F401


@pytest.mark.parametrize("op,causal", [("ring", False), ("ulysses", True)])
def test_sp4_matches_the_jax_packages_pallas_kernels_too(ranks, op,  # noqa: F811
                                                         causal):
    check(ranks, op, causal)
