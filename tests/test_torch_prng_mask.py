"""The port's training-dropout keep mask (paddle_tpu_torch/kernels/
prng_mask.py, the plain version of csrc/philox.cuh): Philox-4x32-10
known answers, the mask against an independent pure-Python Philox, the
16-bit threshold rule, the keep rate, independence from the tiling, and
the kernel build's rebuild on a header edit.

Known answers are Random123's for Philox-4x32-10 (kat_vectors). The keep
rate is checked within 5 sigma of 1-p over more than 10^6 elements.
"""

import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.errors import InvalidArgumentError
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import prng_mask as pm

M32 = 0xFFFFFFFF


def _philox_py(ctr, key):
    """Philox-4x32-10 in Python integers: the independent reference."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & M32]
        k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    words = pm.philox4x32_10(
        *(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w[0]) for w in words) == want
    assert tuple(_philox_py(ctr, key)) == want


def test_threshold_is_the_tpu_16_bit_rule():
    assert pm.threshold(0.0) == 0
    assert pm.threshold(0.1) == int(0.1 * 65536) == 6553
    assert pm.threshold(0.5) == 32768
    assert pm.threshold(1.0) == 0xFFFF  # clamped: keeps only u16 == 0xFFFF


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_mask_matches_an_independent_philox(lead):
    """Element (..., b, h, i, j) keeps when lane j & 7 (lane 2w = low half
    of word w) of Philox((j >> 3, i, h, b), seed) is >= the threshold."""
    seed, rate = (0x12345678, 0x9ABCDEF0), 0.3
    rows, cols, row0, col0 = 3, 21, 5, 11
    got = pm.keep_mask(seed, rate, rows, cols, lead=lead, row0=row0,
                       col0=col0)
    t = pm.threshold(rate)
    want = np.zeros(tuple(lead) + (rows, cols), bool)
    for ix in np.ndindex(*lead, rows, cols):
        *ld, r, c = ix
        b, h = (ld + [0, 0])[:2] if len(ld) == 2 else (0, 0)
        j, i = col0 + c, row0 + r
        words = _philox_py((j >> 3, i, h, b), seed)
        lane = j & 7
        u16 = (words[lane >> 1] >> (16 * (lane & 1))) & 0xFFFF
        want[ix] = u16 >= t
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_five_sigma(rate):
    n_rows, n_cols = 1536, 768  # 1.18e6 elements
    keep = pm.keep_mask((7, 11), rate, n_rows, n_cols)
    n = keep.numel()
    p = 1.0 - pm.threshold(rate) / 65536.0
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(keep.float().mean().item() - p) < 5 * sigma
    assert abs(p - (1 - rate)) < 2 ** -16


def test_a_tile_is_the_same_slice_of_the_whole_mask():
    seed = (3, 4)
    whole = pm.keep_mask(seed, 0.1, 130, 200, lead=(2, 3))
    for row0, col0, rows, cols in [(0, 0, 64, 64), (64, 64, 64, 64),
                                   (128, 192, 2, 8), (7, 13, 50, 61)]:
        tile = pm.keep_mask(seed, 0.1, rows, cols, lead=(2, 3), row0=row0,
                            col0=col0)
        assert torch.equal(tile, whole[..., row0:row0 + rows,
                                       col0:col0 + cols])
    flat = pm.keep_mask(seed, 0.1, 40, 100)
    assert torch.equal(pm.keep_mask(seed, 0.1, 8, 30, row0=32, col0=70),
                       flat[32:, 70:])


def test_seeds_and_rates_change_the_mask():
    a = pm.keep_mask((1, 2), 0.5, 64, 64)
    assert not torch.equal(a, pm.keep_mask((1, 3), 0.5, 64, 64))
    assert not torch.equal(a, pm.keep_mask((2, 2), 0.5, 64, 64))
    assert pm.keep_mask((1, 2), 0.0, 16, 16).all()


def test_training_dropout_needs_seed_words():
    with pytest.raises(InvalidArgumentError):
        pm.mask_args(0.1, False, None, "test")
    assert pm.mask_args(0.1, True, None, "test") == (0, 0, 0, 6553)
    assert pm.mask_args(0.1, False, (1, 2), "test") == (1, 1, 2, 6553)


def test_editing_a_header_rebuilds_the_libraries_that_include_it(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build.lib_path(n, csrc) for n in _build.SOURCES}
    assert before == {n: _build.lib_path(n) for n in _build.SOURCES}
    header = csrc / "philox.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.lib_path(n, csrc) for n in _build.SOURCES}
    for name in ("flash_attention", "fused_dropout_add_ln"):
        assert after[name] != before[name]  # both include philox.cuh
    assert after["sum_partials"] == before["sum_partials"]


def test_the_row_chunks_rebuild_the_two_row_libraries_that_include_them(
        tmp_path):
    """row_chunks.cuh, the row helpers of #4's and #11's backwards, is
    hashed into the names of libfused_dropout_add_ln and liblayer_norm
    and no other's: an edit to it rebuilds those two libraries alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build.lib_path(n, csrc) for n in _build.SOURCES}
    header = csrc / "row_chunks.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.lib_path(n, csrc) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if after[n] != before[n]] == \
        ["fused_dropout_add_ln", "layer_norm"]
