"""Port parity of #13/#14's plain versions (paddle_tpu_torch.kernels.
ring_block.ring_block_bwd on the CPU) against the JAX package's per-shard
backward Pallas kernels in interpret mode and its chunked-jnp shard
backward, at the offsets of test_torch_ring_block.py (the cases that do
not fit that file's time), with its inputs. Tolerance, fp32: dq, dk, dv
atol 1e-4 (sums over up to 48 rows of terms of magnitude < 5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import ring_block as jrb
from paddle_tpu.parallel import ring_attention as jra
from paddle_tpu_torch.kernels import ring_block as trb
from test_torch_ring_block import (
    B,
    D,
    H,
    OFFSETS,
    SCALE,
    _inputs,
    _lanes,
    _pack,
    _t,
    _unpack,
)


@functools.partial(jax.jit, static_argnames=("causal",))
def _pallas_bwd(q, k, v, do, lse, delta, offs, causal):
    args = (q, k, v, do, lse, delta, offs, H, D, causal, SCALE, True)
    return (jrb.shard_dq(*args),) + tuple(jrb.shard_dkv(*args))


def _jax_bwd(q, k, v, do, lse, delta, row0, col0, causal):
    out = _pallas_bwd(_pack(q), _pack(k), _pack(v), _pack(do), _lanes(lse),
                      _lanes(delta), jnp.asarray([row0, col0], jnp.int32),
                      causal=causal)
    return tuple(_unpack(x) for x in out)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk,row0,col0", OFFSETS)
def test_backward_matches_pallas_interpret_and_jnp(Sq, Sk, row0, col0,
                                                   causal):
    """dq (#13) and dk, dv (#14) from the global lse and delta of a
    two-shard ring: the query shard's own (diagonal) shard merged with
    the visiting one. The global lse is finite on every row, so the
    Pallas kernels' masked entries read exp(-1e30 - lse) = 0 as the
    port's do."""
    q, k, v, do = _inputs(Sq, Sk, seed=7 + Sq + row0 + col0)
    _, k0, v0, _ = _inputs(Sq, Sq, seed=8 + Sq)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o0, l0 = trb.ring_block_fwd(tq, *_t(k0, v0), row0, row0, causal, SCALE)
    o1, l1 = trb.ring_block_fwd(tq, tk, tv, row0, col0, causal, SCALE)
    lse = torch.logaddexp(l0, l1)
    o = (o0 * torch.exp(l0 - lse)[..., None]
         + o1 * torch.exp(l1 - lse)[..., None])
    delta = (tdo * o).sum(-1)
    acc = [torch.zeros(B, H, Sq, D), torch.zeros(B, H, Sk, D),
           torch.zeros(B, H, Sk, D)]
    dq, dk, dv = trb.ring_block_bwd(tq, tk, tv, tdo, lse, delta, row0, col0,
                                    causal, SCALE, *acc)
    assert dq is acc[0] and dk is acc[1] and dv is acc[2]
    want = _jax_bwd(q, k, v, do, lse.numpy(), delta.numpy(), row0, col0,
                    causal)
    for got, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=name)
    jnp_want = jra._shard_bwd_jnp(
        *map(jnp.asarray, (q, k, v, do)), jnp.asarray(lse.numpy()[..., None]),
        jnp.asarray(delta.numpy()[..., None]), row0, col0, causal, SCALE)
    for got, w, name in zip((dq, dk, dv), jnp_want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_backward_adds_into_the_accumulators_and_skips_masked_rows():
    """The backward wrapper adds into what the accumulators hold; a shard
    wholly above the diagonal adds nothing, even where the lse of its
    rows is the finite -1e30."""
    q, k, v, do = _t(*_inputs(32, 32, seed=11))
    lse = torch.full((B, H, 32), trb.NEG_INF)
    delta = torch.zeros(B, H, 32)
    base = [torch.full((B, H, 32, D), 0.5) for _ in range(3)]
    got = trb.ring_block_bwd(q, k, v, do, lse, delta, 0, 64, True, SCALE,
                             *[b.clone() for b in base])
    assert all(torch.equal(g, b) for g, b in zip(got, base))
    o, lse = trb.ring_block_fwd(q, k, v, 32, 0, True, SCALE)
    delta = (do * o).sum(-1)
    once = trb.ring_block_bwd(q, k, v, do, lse, delta, 32, 0, True, SCALE,
                              *[torch.zeros(B, H, 32, D) for _ in range(3)])
    twice = trb.ring_block_bwd(q, k, v, do, lse, delta, 32, 0, True, SCALE,
                               *[t.clone() for t in once])
    for a, b in zip(once, twice):
        torch.testing.assert_close(b, 2 * a, rtol=1e-6, atol=1e-6)
