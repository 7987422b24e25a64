"""The arithmetic of the backward pairs on the tensor cores, the
ring-block pair (#13, #14), the whole-row pair (#3/#6) and the KV-tiled
pair (#9/#8), through their plain model in
paddle_tpu_torch.kernels.ring_block: `tf32_round` (the card's
cvt.rna.tf32.f32: round to nearest, ties away from zero, onto 10
mantissa bits) and `tf32_split` (x = hi + lo, both TF32), which
csrc/mma_tiles.cuh applies to every fp32 operand of a 3xTF32 product
(lo*hi + hi*lo + hi*hi).

Why the split exists: one head, each pair's products emulated on the CPU
(TF32 operands, fp32 sums, each tile's product summed from zero and added
in fp32) against an fp64 reference: the ring pair at S=2048, causal; the
whole-row pair at BERT's S=512, D=64 with a padded key bias and training
dropout (the kernels' Philox mask); the tiled pair at GPT's S=2048,
causal, with training dropout, from the saved lse and output. One TF32
product a product misses the card tests' fp32 tolerance (atol 5e-5) by
far; three hold it as plain fp32 does.
"""

import math
import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import prng_mask as pm
from paddle_tpu_torch.kernels import ring_block as rb
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

F32_MAX = float(np.finfo(np.float32).max)
TINY = 2.0 ** -149  # the smallest fp32 subnormal


def _bits(x):
    return torch.tensor(x, dtype=torch.float32).view(torch.int32).item()


def _f32(bits):
    return torch.tensor([bits], dtype=torch.int32).view(torch.float32)


def _model(x):
    """TF32 rounding by arithmetic on float64 (independent of the bit
    operations): |x| to a multiple of its unit in the last of 11
    significant bits (2^-136 below the normal range), halves away from
    zero; past 2^128 infinity."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(np.abs(x))
    ulp = np.maximum(np.ldexp(1.0, e - 11), 2.0 ** -136)
    mag = np.floor(np.abs(x) / ulp + 0.5) * ulp
    mag = np.where(mag >= 2.0 ** 128, np.inf, mag)
    return np.copysign(mag, x).astype(np.float32)


# (value, its TF32 rounding)
KNOWN = {
    "one": (1.0, 1.0),
    "one_ulp_kept": (1 + 2 ** -10, 1 + 2 ** -10),
    "tie_away_from_zero": (1 + 2 ** -11, 1 + 2 ** -10),
    "negative_tie": (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    "below_the_tie": (1 + 2 ** -11 - 2 ** -23, 1.0),
    "odd_tie": (1 + 3 * 2 ** -11, 1 + 2 ** -9),
    "largest_finite_overflows": (F32_MAX, math.inf),
    "negative_largest": (-F32_MAX, -math.inf),
    "largest_that_stays": (float(_f32(0x7F7FEFFF)), float(_f32(0x7F7FE000))),
    "smallest_subnormal": (TINY, 0.0),
    "subnormal_tie": (2 ** 12 * TINY, 2 ** 13 * TINY),
    "negative_subnormal_tie": (-(2 ** 12) * TINY, -(2 ** 13) * TINY),
    "subnormal_to_normal": (float(_f32(0x007FFFFF)), 2.0 ** -126),
    "neg_inf_stand_in": (rb.NEG_INF, float(_model(np.float32(rb.NEG_INF)))),
    "infinity": (math.inf, math.inf),
}


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_tf32_round_known_answers(name):
    x, want = KNOWN[name]
    got = rb.tf32_round(torch.tensor([x]))
    assert _bits(got.item()) == _bits(want)


def test_tf32_round_keeps_the_sign_of_zero_and_nan():
    got = rb.tf32_round(torch.tensor([0.0, -0.0, math.nan]))
    assert [_bits(v) for v in got[:2].tolist()] == [0, _bits(-0.0)]
    assert math.isnan(got[2].item())


def test_tf32_round_matches_an_arithmetic_model():
    rng = np.random.RandomState(0)
    mant = rng.uniform(1, 2, 20000)
    exps = rng.randint(-149, 128, 20000)
    x = np.concatenate([
        np.ldexp(mant, exps) * rng.choice([-1, 1], 20000),
        # every tie and near-tie pattern of the 13 dropped bits
        np.ldexp(1 + np.arange(-4, 5)[:, None] * 2.0 ** -23
                 + np.arange(0, 2 ** 13, 2 ** 9)[None, :] * 2.0 ** -23,
                 0).ravel(),
    ]).astype(np.float32)
    got = rb.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _model(x).view(np.int32))
    assert not (got.view(np.int32) & 0x1FFF).any()


def test_bf16_values_are_tf32_fixed_points():
    """Every finite bf16 value (all 2^16 bit patterns) widens to an fp32
    that TF32 holds exactly: hi is the value, lo is 0, so the card drops
    the lo terms of a bf16 tile at compile time."""
    pattern = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32)
    x = pattern.to(torch.int16).view(torch.bfloat16).float()
    x = x[torch.isfinite(x)]
    hi, lo = rb.tf32_split(x)
    assert torch.equal(hi.view(torch.int32), x.view(torch.int32))
    assert not lo.any()


def test_tf32_split_reconstructs_fp32():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(np.ldexp(rng.uniform(-2, 2, 50000),
                                  rng.randint(-100, 100, 50000))
                         .astype(np.float32))
    hi, lo = rb.tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


def _mm(a, b, terms):
    """a @ b as the card's products: fp32 sums of TF32 operands, one
    product (hi.hi) or three (lo.hi + hi.lo + hi.hi)."""
    ah, al = rb.tf32_split(a)
    bh, bl = rb.tf32_split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def test_3xtf32_holds_the_cards_tolerance_where_1xtf32_does_not():
    """dq (#13) and dk (#14) of one head at S=2048, D=64, causal, from
    the fp32 global lse and delta, each product (S, dP, dQ, dK) as the
    card computes it, against fp64: within the card tests' 5e-5 with
    the split, past it with one TF32 product."""
    S, D = 2048, 64
    scale = 1 / math.sqrt(D)
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(S, D).astype(np.float32) for _ in range(4))
    vis = np.tril(np.ones((S, S), bool))
    Q, K, V, DO = (x.astype(np.float64) for x in (q, k, v, do))
    s = np.where(vis, Q @ K.T * scale, -np.inf)
    m = s.max(1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(1, keepdims=True))
    p = np.exp(s - lse)
    delta = (DO * (p @ V)).sum(1, keepdims=True)
    ds = p * (DO @ V.T - delta)
    ref = (ds @ K * scale, ds.T @ Q * scale)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_lse = torch.from_numpy(lse.astype(np.float32))
    t_delta = torch.from_numpy(delta.astype(np.float32))
    t_vis = torch.from_numpy(vis)
    errs = {}
    for terms in (1, 3):
        sc = _mm(tq, tk.T, terms)
        pp = torch.where(t_vis, torch.exp(sc * scale - t_lse), 0.0)
        dss = pp * (_mm(tdo, tv.T, terms) - t_delta)
        got = (_mm(dss, tk, terms) * scale, _mm(dss.T, tq, terms) * scale)
        errs[terms] = [float(np.abs(g.numpy() - r).max())
                       for g, r in zip(got, ref)]
    assert max(errs[3]) <= 5e-5, errs
    assert max(errs[1]) > 5e-5 * 10, errs


def test_3xtf32_holds_the_whole_row_pair_where_1xtf32_does_not():
    """dq, dk, dv and dbias of #3/#6 on one head at S=512, D=64, a key
    bias with a padded tail, dropout 0.1 in training (the port's plain
    Philox mask), as the card computes them: the dq kernel's two passes
    over key tiles of 64 (S = Q K^T and dP = dO V^T; the online row max,
    sum and sum of p dp; then dS = p (dp - delta) and dQ += dS K tile by
    tile), the dkv kernel's query tiles (dV += (keep . P)^T dO,
    dK += dS^T Q), every product with TF32 operands and fp32 sums. Against
    fp64: within the card tests' 5e-5 with the split, past it with one
    TF32 product."""
    S, D, T, rate = 512, 64, 64, 0.1
    scale, dscale = 1 / math.sqrt(D), 1 / (1 - rate)
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(S, D).astype(np.float32) for _ in range(4))
    bias = np.zeros(S, np.float32)
    bias[S - 100:] = -1e4
    keep = pm.keep_mask((0x2024ABCD, 0x5EED0001), rate, S, S).numpy()
    w = keep * dscale  # the multiplier of a kept p and dp
    Q, K, V, DO = (x.astype(np.float64) for x in (q, k, v, do))
    s = Q @ K.T * scale + bias[None]
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    dp = DO @ V.T * w
    ds = p * (dp - (dp * p).sum(1, keepdims=True))
    ref = (ds @ K * scale, ds.T @ Q * scale, (p * w).T @ DO, ds.sum(0))

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tb, tw = torch.from_numpy(bias), torch.from_numpy(w.astype(np.float32))
    errs = {}
    for terms in (1, 3):
        def scores(rows, cols):
            return _mm(tq[rows], tk[cols].T, terms) * scale + tb[cols]

        def dps(rows, cols):
            return _mm(tdo[rows], tv[cols].T, terms) * tw[rows, cols]

        every, tiles = slice(0, S), [slice(t, t + T) for t in range(0, S, T)]
        m = torch.full((S, 1), -math.inf)
        l, dsum = torch.zeros(S, 1), torch.zeros(S, 1)
        for c in tiles:  # dq, pass 1
            sc, dpc = scores(every, c), dps(every, c)
            m_new = torch.maximum(m, sc.max(1, keepdim=True).values)
            e, alpha = torch.exp(sc - m_new), torch.exp(m - m_new)
            l = l * alpha + e.sum(1, keepdim=True)
            dsum = dsum * alpha + (e * dpc).sum(1, keepdim=True)
            m = m_new
        lse, delta = m + torch.log(l), dsum / l
        dq, dk, dv = (torch.zeros(S, D) for _ in range(3))
        for c in tiles:  # dq, pass 2
            dsc = torch.exp(scores(every, c) - lse) * (dps(every, c) - delta)
            dq += _mm(dsc, tk[c], terms)
        db = torch.zeros(S)
        for r in tiles:  # dkv: query tiles
            pr = torch.exp(scores(r, every) - lse[r])
            dsr = pr * (dps(r, every) - delta[r])
            dv += _mm((pr * tw[r]).T, tdo[r], terms)
            dk += _mm(dsr.T, tq[r], terms)
            db += dsr.sum(0)
        got = (dq * scale, dk * scale, dv, db)
        errs[terms] = [float(np.abs(g.numpy() - r).max())
                       for g, r in zip(got, ref)]
    assert max(errs[3]) <= 5e-5, errs
    assert min(errs[1]) > 5e-5 * 5, errs


def test_3xtf32_holds_the_tiled_pair_where_1xtf32_does_not():
    """dq, dk, dv of the KV-tiled pair #9/#8 on one head at GPT's S=2048,
    D=64, causal, dropout 0.1 in training (the port's plain Philox mask),
    from the fp64 reference's saved lse and output rounded to fp32, as the
    card computes them: #9 in one pass over key tiles of 64 (S = Q K^T,
    dP = dO V^T, dS = p (dp - delta) with delta = rowsum(dO . out), and
    dQ += dS K tile by tile), #8 over the query tiles from its key tile's
    diagonal (dV += (keep . P)^T dO, dK += dS^T Q), every product with
    TF32 operands and fp32 sums. Against fp64: within the card tests' 5e-5
    with the split, past it with one TF32 product."""
    S, D, T, rate = 2048, 64, 64, 0.1
    scale, dscale = 1 / math.sqrt(D), 1 / (1 - rate)
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(S, D).astype(np.float32) for _ in range(4))
    keep = pm.keep_mask((0x2024ABCD, 0x5EED0001), rate, S, S).numpy()
    w = keep * dscale  # the multiplier of a kept p and dp
    vis = np.tril(np.ones((S, S), bool))
    Q, K, V, DO = (x.astype(np.float64) for x in (q, k, v, do))
    s = np.where(vis, Q @ K.T * scale, -np.inf)
    m = s.max(1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(1, keepdims=True))
    p = np.exp(s - lse)
    out = (p * w) @ V
    dp = DO @ V.T * w
    ds = p * (dp - (DO * out).sum(1, keepdims=True))
    ref = (ds @ K * scale, ds.T @ Q * scale, (p * w).T @ DO)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_lse = torch.from_numpy(lse.astype(np.float32))
    t_out = torch.from_numpy(out.astype(np.float32))
    tw = torch.from_numpy(w.astype(np.float32))
    t_vis = torch.from_numpy(vis)
    delta = (tdo * t_out).sum(1, keepdim=True)  # #9, from the saved out
    tiles = [slice(t, t + T) for t in range(0, S, T)]
    errs = {}
    for terms in (1, 3):
        def probs(rows, cols):
            sc = _mm(tq[rows], tk[cols].T, terms) * scale
            sc = torch.where(t_vis[rows, cols], sc, rb.NEG_INF)
            return torch.exp(sc - t_lse[rows])

        def dss(rows, cols):
            dpc = _mm(tdo[rows], tv[cols].T, terms) * tw[rows, cols]
            return probs(rows, cols) * (dpc - delta[rows])

        dq, dk, dv = (torch.zeros(S, D) for _ in range(3))
        for r in tiles:  # #9: query tile r, its key tiles up to the diagonal
            for c in tiles[:r.start // T + 1]:
                dq[r] += _mm(dss(r, c), tk[c], terms)
        for c in tiles:  # #8: key tile c, its query tiles from the diagonal
            for r in tiles[c.start // T:]:
                dv[c] += _mm((probs(r, c) * tw[r, c]).T, tdo[r], terms)
                dk[c] += _mm(dss(r, c).T, tq[r], terms)
        got = (dq * scale, dk * scale, dv)
        errs[terms] = [float(np.abs(g.numpy() - r).max())
                       for g, r in zip(got, ref)]
    assert max(errs[3]) <= 5e-5, errs
    assert min(errs[1]) > 5e-5 * 10, errs


def test_the_mma_tiles_rebuild_the_three_libraries_that_include_them(
        tmp_path):
    """mma_tiles.cuh is hashed into the names of libflash_attention (#3/#6
    and #1/#5), libflash_tiled (#9/#8 and #7, through attn_mma.cuh, the
    backward bodies they share) and libring_block (#12-#14) and no
    other's: an edit to it rebuilds those three libraries alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    for name in ("flash_attention", "flash_tiled", "ring_block"):
        names = [p.name for p in _build._sources(name, csrc)]
        assert "mma_tiles.cuh" in names and "attn_tiles.cuh" in names
    for name in ("flash_attention", "flash_tiled"):
        assert "attn_mma.cuh" in [p.name
                                  for p in _build._sources(name, csrc)]
    before = {n: _build.lib_path(n, csrc) for n in _build.SOURCES}
    header = csrc / "mma_tiles.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.lib_path(n, csrc) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if after[n] != before[n]] == \
        ["flash_attention", "flash_tiled", "ring_block"]
