"""The arithmetic of the forward kernels on the tensor cores, the whole-row
forward (#1/#5), the KV-tiled forward (#7) and the ring-block forward
(#12), which share one body (csrc/attn_mma.cuh's fwd_mma_block), through
the plain model of the card's products in paddle_tpu_torch.kernels.
ring_block (`tf32_split`: x = hi + lo, both TF32, as the card's
cvt.rna.tf32.f32 rounds).

The body, emulated key tile by key tile on the CPU for one head: S = Q K^T
over a tile of BS keys (64; 32 at D=128) with TF32 operands and fp32
sums, the policy's scores (whole-row, #1/#5 and #7: the scale, a key bias
with a padded tail, the causal cut at -1e30 for #7 at GPT's S=2048, and
the sequence end; ring: liveness at the shards' causal offsets, a dead
entry weighing exactly 0), an fp32 online softmax (the tile's row
max, alpha = exp(m - m_new), the row sum over every e, kept or dropped),
training dropout's keep mask (the kernels' Philox mask, prng_mask) on P,
and each tile's P V summed from zero with TF32 operands and added to the
rescaled O in fp32. Against fp64: with three TF32 terms a product
(lo.hi + hi.lo + hi.hi) the output holds the card tests' forward
tolerance, atol 5e-6, and the lse 1e-5; with one (hi.hi) the output
misses 5e-5. Rows that see no key give o = 0 and lse = NEG_INF exactly.
"""

import functools
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import prng_mask as pm
from paddle_tpu_torch.kernels import ring_block as rb
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

ATOL_OUT, ATOL_LSE = 5e-6, 1e-5  # the card tests' TOL["attention"], lse
MISS = 5e-5  # one TF32 term a product misses this
RATE = 0.1
SEED = (0x2024ABCD, 0x5EED0001)

# (kind, S, D, row0, col0): whole-row at BERT's S=512 with a key bias and
# training dropout; the KV-tiled forward (the whole-row policy, causal) at
# GPT's S=2048 with a key bias and training dropout, 32 key tiles of
# rescaling at D=64 and 64 at D=128; the ring's diagonal shard at S=2048,
# causal, at offsets whose first 60 rows see no key and whose diagonal
# cuts tiles
CASES = {
    "whole_row_s512_d64": ("whole_row", 512, 64, 0, 0),
    "whole_row_s512_d128": ("whole_row", 512, 128, 0, 0),
    "tiled_s2048_causal_d64": ("tiled", 2048, 64, 0, 0),
    "tiled_s2048_causal_d128": ("tiled", 2048, 128, 0, 0),
    "ring_s2048_causal_d64": ("ring", 2048, 64, 40, 100),
    "ring_s2048_causal_d128": ("ring", 2048, 128, 40, 100),
}


@functools.lru_cache(maxsize=None)
def _keep(S):
    return pm.keep_mask(SEED, RATE, S, S).numpy()


def _mm(a, b, terms):
    """a @ b as the card's products: fp32 sums of TF32 operands, one
    product (hi.hi) or three (lo.hi + hi.lo + hi.hi)."""
    ah, al = rb.tf32_split(a)
    bh, bl = rb.tf32_split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs, the fp64 reference (out, lse) and the visibility of one
    case."""
    kind, S, D, row0, col0 = CASES[name]
    rng = np.random.RandomState(S + D)
    q, k, v = (rng.randn(S, D).astype(np.float32) for _ in range(3))
    Q, K, V = (x.astype(np.float64) for x in (q, k, v))
    scale = 1 / math.sqrt(D)
    s = Q @ K.T * scale
    if kind != "ring":  # the whole-row policy: #1/#5, and #7 causal
        bias = np.zeros(S, np.float32)
        bias[S - 100:] = -1e4  # a padded tail of keys
        keep = _keep(S)
        vis = (np.tril(np.ones((S, S), bool)) if kind == "tiled"
               else np.ones((S, S), bool))
        s = s + bias[None]
        w = keep / (1 - RATE)  # the multiplier of a kept p
    else:
        bias = keep = None
        ar = np.arange(S)
        vis = (col0 + ar)[None, :] <= (row0 + ar)[:, None]
        w = np.ones((S, S))
    some = vis.any(1, keepdims=True)
    s = np.where(vis, s, -np.inf)
    m = np.where(some, s.max(1, keepdims=True), 0.0)
    e = np.where(vis, np.exp(s - m), 0.0)
    l = e.sum(1, keepdims=True)
    out = np.where(some, (e * w) @ V / np.where(some, l, 1.0), 0.0)
    lse = np.where(some, m + np.log(np.where(some, l, 1.0)), rb.NEG_INF)
    return (kind, q, k, v, bias, keep, vis, scale, out, lse[:, 0])


def _emulate(name, terms):
    """(out, lse) of the forward body on one head, tile by tile, with
    `terms` TF32 products a product."""
    kind, q, k, v, bias, keep, vis, scale, _, _ = _case(name)
    S, D = q.shape
    BS = 32 if D > 64 else 64
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    t_vis = torch.from_numpy(vis)
    ring, causal = kind == "ring", kind == "tiled"
    m0 = rb.NEG_INF if ring else -math.inf
    m = torch.full((S, 1), m0)
    l = torch.zeros(S, 1)
    acc = torch.zeros(S, D)
    # key tiles up to the last one any row sees (a tile dead for a row
    # leaves its m, l and O as they were)
    last = int(np.nonzero(vis.any(0))[0].max())
    for k0 in range(0, last + 1, BS):
        c = slice(k0, min(k0 + BS, S))
        sc = _mm(tq, tk[c].T, terms)
        if ring:
            live = t_vis[:, c]
            sc = torch.where(live, sc * scale, rb.NEG_INF)
        else:
            sc = sc * scale + torch.from_numpy(bias[c])
            if causal:  # j > i at NEG_INF; every row sees key 0
                sc = torch.where(t_vis[:, c], sc, rb.NEG_INF)
        m_new = torch.maximum(m, sc.max(1, keepdim=True).values)
        e = torch.exp(sc - m_new)
        if ring:  # a dead entry weighs 0, even in a wholly dead row
            e = torch.where(live, e, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + e.sum(1, keepdim=True)
        m = m_new
        if keep is not None:  # the sum counts every e; P drops
            e = torch.where(torch.from_numpy(keep[:, c]), e, 0.0)
        acc = acc * alpha + _mm(e, tv[c], terms)
    if ring:
        some = l > 0
        mul = torch.where(some, 1 / torch.where(some, l, 1.0), 0.0)
        lse = torch.where(some, m + torch.log(torch.where(some, l, 1.0)),
                          rb.NEG_INF)
    else:
        mul = (1 / (1 - RATE)) / l
        lse = m + torch.log(l)
    return (acc * mul).numpy(), lse[:, 0].numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_forward_holds_the_cards_tolerance(name):
    _, _, _, _, _, _, vis, _, out, lse = _case(name)
    got, got_lse = _emulate(name, 3)
    some = vis.any(1)  # rows with no live key: the test below
    err = float(np.abs(got - out).max())
    err_lse = float(np.abs(got_lse - lse)[some].max())
    assert err <= ATOL_OUT, (err, err_lse)
    assert err_lse <= ATOL_LSE, (err, err_lse)


@pytest.mark.parametrize("name", sorted(CASES))
def test_1xtf32_forward_misses_it(name):
    *_, out, _ = _case(name)
    got, _ = _emulate(name, 1)
    assert float(np.abs(got - out).max()) > MISS


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if CASES[n][0] == "ring"])
def test_ring_rows_without_a_live_key_give_zero_and_neg_inf(name):
    """The 60 rows before the first visible key: o = 0 and lse = NEG_INF
    exactly, as the plain version gives them (no NaN from a row whose
    max stays NEG_INF)."""
    _, _, _, _, _, _, vis, *_ = _case(name)
    dead = ~vis.any(1)
    assert dead.sum() == 60
    got, got_lse = _emulate(name, 3)
    assert not got[dead].any()
    assert (got_lse[dead] == np.float32(rb.NEG_INF)).all()
    assert np.isfinite(got).all() and np.isfinite(got_lse).all()
