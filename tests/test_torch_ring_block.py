"""Port parity: paddle_tpu_torch.kernels.ring_block (#12-#14's plain
versions, on the CPU) against the JAX package's per-shard Pallas kernels
(paddle_tpu/kernels/ring_block.py) in interpret mode, and against its
chunked-jnp shard backend (parallel/ring_attention.py `_shard_fwd_jnp`,
`_shard_bwd_jnp`), at runtime causal offsets (row0, col0), causal and
not, with shards whose rows are wholly masked.

The JAX kernels pack heads in 128-lane rows ([B, S, H*D], here H=4,
D=32) and repeat each head's lse over its D lanes; the port's operands
are [B, H, S, D] and its lse [B, H, S]: the test converts. Inputs come
from numpy with a fixed seed. Tolerances, fp32: o and lse atol 2e-5
(online softmax over 32-48 keys summed in another order). The backward
cases are in test_torch_ring_block_bwd.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import ring_block as jrb
from paddle_tpu.parallel import ring_attention as jra
from paddle_tpu_torch.errors import InvalidArgumentError
from paddle_tpu_torch.kernels import ring_block as trb

B, H, D = 1, 4, 32
SCALE = 1.0 / np.sqrt(D)
# (Sq, Sk, row0, col0): the diagonal shard; a key shard wholly before the
# query shard; one wholly after it (every row masked); one straddling the
# diagonal with its first rows wholly masked; shards of other lengths
OFFSETS = [(32, 32, 0, 0), (32, 32, 64, 32), (32, 32, 32, 64),
           (32, 32, 40, 48), (48, 32, 16, 40)]


def _inputs(Sq, Sk, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Sq, D).astype(np.float32)
    k = rng.randn(B, H, Sk, D).astype(np.float32)
    v = rng.randn(B, H, Sk, D).astype(np.float32)
    do = rng.randn(B, H, Sq, D).astype(np.float32)
    return q, k, v, do


def _pack(x):
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(x.shape[0],
                                                       x.shape[2], -1))


def _unpack(x):
    x = np.asarray(x)
    return x.reshape(x.shape[0], x.shape[1], H, -1).transpose(0, 2, 1, 3)


def _lanes(stat):
    """[B, H, S] -> the JAX kernels' [B, S, H*D], each head repeated."""
    return jnp.asarray(np.repeat(stat.transpose(0, 2, 1), D, axis=-1))


@functools.partial(jax.jit, static_argnames=("causal",))
def _pallas_fwd(q, k, v, offs, causal):
    return jrb.shard_fwd(q, k, v, offs, H, D, causal, SCALE, True)


def _jax_fwd(q, k, v, row0, col0, causal):
    # jitted, with the offsets traced as the ring traces them: one compile
    # per shape and causal setting
    o, lse = _pallas_fwd(_pack(q), _pack(k), _pack(v),
                         jnp.asarray([row0, col0], jnp.int32), causal=causal)
    return _unpack(o), _unpack(lse)[..., 0]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk,row0,col0", OFFSETS)
def test_forward_matches_pallas_interpret_and_jnp(Sq, Sk, row0, col0,
                                                  causal):
    q, k, v, _ = _inputs(Sq, Sk, seed=Sq + row0 + col0)
    o, lse = trb.ring_block_fwd(*_t(q, k, v), row0, col0, causal, SCALE)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == (B, H, Sq, D) and lse.shape == (B, H, Sq)
    jo, jlse = _jax_fwd(q, k, v, row0, col0, causal)
    np.testing.assert_allclose(o.numpy(), jo, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=2e-5, rtol=0)
    no, nlse = jra._shard_fwd_jnp(*map(jnp.asarray, (q, k, v)), row0, col0,
                                  causal, SCALE)
    np.testing.assert_allclose(o.numpy(), np.asarray(no), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(nlse)[..., 0],
                               atol=2e-5, rtol=0)


def test_a_wholly_masked_row_gives_zero_and_the_finite_neg_inf():
    """Rows that see no key: o exactly 0 and lse exactly -1e30 (finite),
    and merging two such shards by logaddexp stays NaN-free."""
    q, k, v, _ = _inputs(32, 32, seed=3)
    o, lse = trb.ring_block_fwd(*_t(q, k, v), 40, 48, True, SCALE)
    dead = slice(0, 8)  # global rows 40..47 precede every column 48..79
    assert torch.all(o[:, :, dead] == 0)
    assert torch.all(lse[:, :, dead] == trb.NEG_INF)
    assert torch.all(lse[:, :, 8:] > -1e3)
    o2, lse2 = trb.ring_block_fwd(*_t(q, k, v), 0, 64, True, SCALE)
    assert torch.all(lse2 == trb.NEG_INF) and torch.all(o2 == 0)
    l_new = torch.logaddexp(lse2, lse2)
    merged = o2 * torch.exp(lse2 - l_new)[..., None]
    assert torch.isfinite(l_new).all() and torch.isfinite(merged).all()


def test_plain_versions_chunk_long_shards(monkeypatch):
    """Shards longer than KV_CHUNK stream their keys in blocks: the same
    answers as one block, both causal settings."""
    q, k, v, do = _t(*_inputs(40, 40, seed=5))
    for causal in (False, True):
        o1, l1 = trb.shard_fwd_ref(q, k, v, 8, 0, causal, SCALE)
        d1 = trb.shard_dq_ref(q, k, v, do, l1, (do * o1).sum(-1), 8, 0,
                              causal, SCALE)
        kv1 = trb.shard_dkv_ref(q, k, v, do, l1, (do * o1).sum(-1), 8, 0,
                                causal, SCALE)
        monkeypatch.setattr(trb, "KV_CHUNK", 16)
        o2, l2 = trb.shard_fwd_ref(q, k, v, 8, 0, causal, SCALE)
        d2 = trb.shard_dq_ref(q, k, v, do, l1, (do * o1).sum(-1), 8, 0,
                              causal, SCALE)
        kv2 = trb.shard_dkv_ref(q, k, v, do, l1, (do * o1).sum(-1), 8, 0,
                                causal, SCALE)
        monkeypatch.setattr(trb, "KV_CHUNK", 1024)
        for a, b in ((o1, o2), (l1, l2), (d1, d2), *zip(kv1, kv2)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_supports_and_refusals():
    """The kernels take D in (32, 64, 128), fp32 or bf16, any lengths; a
    meta or other non-CPU tensor they do not take is refused, never run
    by the plain version."""
    assert trb.ring_supports(64, torch.float32)
    assert trb.ring_supports(128, torch.bfloat16)
    assert not trb.ring_supports(48, torch.float32)
    assert not trb.ring_supports(64, torch.float16)
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(InvalidArgumentError):
        trb.ring_block_fwd(q, q, q, 0, 0, True, 0.125)
