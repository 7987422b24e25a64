"""Port parity of sequence-parallel attention on an sp=4 mesh against the
JAX package's chunked-jnp shard backend (`_FORCE_JNP`, set here by
monkeypatch only), ring and Ulysses, causal and not, with
test_torch_ring_attention.py's inputs and tolerances. The JAX package's
Ulysses takes its jnp fallback (the chunked online softmax over the full
sequence) there."""

import pytest

from paddle_tpu.parallel import ring_attention as jra
from test_torch_ring_attention import check, ranks  # noqa: F401


@pytest.mark.parametrize("op", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sp4_matches_the_jax_packages_jnp_backend(ranks, op,  # noqa: F811
                                                  causal, monkeypatch):
    monkeypatch.setattr(jra, "_FORCE_JNP", True)
    check(ranks, op, causal)
