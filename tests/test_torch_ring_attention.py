"""Port parity for sequence-parallel attention on an sp=4 mesh: the
port's ring and Ulysses attention, forward and gradients, on four gloo
ranks (spawned children over a FileStore under tmp_path, importing
neither jax nor paddle_tpu) against the JAX package's sp=4 mesh of its
8-device virtual CPU mesh (tests/conftest.py).

The JAX side: `_ring_core` and `ulysses_attention` under jax.shard_map,
differentiated as test_longcontext.py's
test_ring_backward_grads_match_dense_autodiff differentiates them, with
the Pallas ring-block kernels in interpret mode (b=1, h=16, s=128, d=32:
the packed heads fill 128 lanes, for Ulysses' local heads too): causal
ring and non-causal Ulysses in this file, the other two in
test_torch_ring_attention_pallas.py; and with the chunked-jnp backend
(`_FORCE_JNP`, set in the test only) for all four in
test_torch_ring_attention_jnp.py (each file stays under 20 s). The port's side runs its
plain per-shard versions (the CPU's), over the same ring schedule and
exchange (GroupExchange) the card runs. Tolerances, the JAX package's
own (test_longcontext.py): forward 2e-5, dq, dk and dv 2e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.parallel import ring_attention as jra
from torch_sp_worker import Ranks, attention_worker

SHAPE = (1, 16, 128, 32)
N = 4


def inputs():
    rng = np.random.RandomState(1)
    return {n: rng.randn(*SHAPE).astype(np.float32) for n in "qkvw"}


def jax_out_and_grads(op, causal, data):
    """(out, (dq, dk, dv)) of the JAX package's op on the sp=N mesh, the
    gradients those of sum(out * w)."""
    b, h, s, d = SHAPE
    scale = float(1.0 / np.sqrt(d))
    mesh = Mesh(np.array(jax.devices()[:N]), ("sp",))

    def local(q, k, v):
        if op == "ring":
            backend = "jnp" if jra._FORCE_JNP else "pallas"
            return jra._ring_core(q, k, v, "sp", N, causal, scale, backend,
                                  True)
        return jra.ulysses_attention(q, k, v, "sp", N, causal=causal)

    def f(q, k, v):
        return jax.shard_map(local, mesh=mesh,
                             in_specs=(P(None, None, "sp"),) * 3,
                             out_specs=P(None, None, "sp"),
                             check_vma=False)(q, k, v)

    @jax.jit
    def run(q, k, v, w):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(w)

    out, grads = run(*(jnp.asarray(data[n]) for n in "qkvw"))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's four ranks, started at once; the JAX package's side is
    computed while they run."""
    tmp = tmp_path_factory.mktemp("sp4")
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs())
    return Ranks(attention_worker, N, tmp, path)


def port_results(ranks):
    """The ranks' outputs and gradients, their sequence shards
    concatenated (waited for once)."""
    if not hasattr(ranks, "gathered"):
        res = ranks.results()
        for r in res:
            assert not r.pop("imported_jax")
        ranks.gathered = {key: np.concatenate([r[key] for r in res], axis=2)
                          for key in res[0]}
    return ranks.gathered


def check(ranks, op, causal):
    out, grads = jax_out_and_grads(op, causal, inputs())
    port = port_results(ranks)
    tag = f"{op}_{int(causal)}"
    np.testing.assert_allclose(port[tag + "_out"], out, atol=2e-5, rtol=0,
                               err_msg=tag)
    for g, n in zip(grads, "qkv"):
        np.testing.assert_allclose(port[f"{tag}_d{n}"], g, atol=2e-4,
                                   rtol=0, err_msg=f"{tag} d{n}")


@pytest.mark.parametrize("op,causal", [("ring", True), ("ulysses", False)])
def test_sp4_matches_the_jax_packages_pallas_kernels(ranks, op, causal):
    check(ranks, op, causal)
