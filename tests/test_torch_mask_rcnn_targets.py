"""Port parity for the Mask R-CNN slice's sampling and label cores
(paddle_tpu_torch/ops/detection_ext.py anchor_assign, proposal_labels,
mask_labels) against the JAX package's one-image cores
(paddle_tpu/ops/detection_ext.py _anchor_assign_single,
_proposal_labels_single, _mask_labels_single), run eagerly on the CPU.

The port's cores take their jitter as an argument; the JAX package's
draw it with jax.random.uniform(key, (n,)). Each case hands the port the
JAX package's own draw under the same key, or, where the jitter is to
collide, replaces jax.random.uniform for the call by a function giving
a jitter of a few distinct values (monkeypatch: the JAX package is not
changed), and hands the port the same. The port's cores run every image
of a batch at once: a two-image case holds each image against the JAX
core run on that image alone.

Cases: two images with overlapping gt boxes; colliding jitter (eight
values); an image whose gt rows are all padding; crowd rows. Indices,
labels, masks and counts are equal; box targets within 1e-6 (logs and
divisions of values of magnitude ~1). Also the port's own jitter
(_helpers.sampling_jitter): the same on two calls, on the 2^-23 grid in
[0, 1), different between images and between seeds, zeros while shapes
are inferred.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import detection_ext as jde

from paddle_tpu_torch.framework.registry import EmitContext, OpView
from paddle_tpu_torch.ops import _helpers as th
from paddle_tpu_torch.ops import detection_ext as tde

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

HW, G = 64, 4
TARGET_ATOL = 1e-6
RPN = dict(pos_thresh=0.7, neg_thresh=0.3, sample_frac=0.5, batch_size=32,
           straddle=0.0)
LABELS = dict(fg_frac=0.25, fg_thresh=0.5, bg_hi=0.5, bg_lo=0.0,
              num_classes=5, bbox_w=(0.1, 0.1, 0.2, 0.2))
CAP = 16


def _anchors():
    """Anchors of a 64x64 image, stride 8, sizes 16 and 32, ratios 0.5,
    1, 2: [384, 4], some straddling the image's edge."""
    out = []
    for y in range(8):
        for x in range(8):
            cx, cy = x * 8 + 3.5, y * 8 + 3.5
            for size in (16, 32):
                for ar in (0.5, 1.0, 2.0):
                    w, h = size / np.sqrt(ar), size * np.sqrt(ar)
                    out.append([cx - w / 2, cy - h / 2, cx + w / 2,
                                cy + h / 2])
    return np.asarray(out, np.float32)


def _gt(rng, n_img):
    xy = rng.uniform(0, 36, (n_img, G, 2))
    wh = rng.uniform(10, 28, (n_img, G, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _case(name):
    """(gt [2, G, 4], is_crowd [2, G], gt classes [2, G], colliding?)."""
    rng = np.random.RandomState(3)
    gt = _gt(rng, 2)
    crowd = np.zeros((2, G), np.int32)
    cls = rng.randint(1, 5, (2, G)).astype(np.int32)
    if name == "no_valid_gt":
        gt[1] = -1.0
    if name == "crowd":
        crowd[0, :2] = 1
        crowd[1, 3] = 1
    return gt, crowd, cls, name == "colliding"


CASES = ("two_images", "colliding", "no_valid_gt", "crowd")


def _jitter(monkeypatch, collide, n, image):
    """The jitter of image `image`: JAX's draw under its key, or a
    colliding one (multiples of 1/8) that jax.random.uniform is made to
    give. Returns (key, jitter)."""
    key = jax.random.split(jax.random.key(7), 2)[image]
    if not collide:
        return key, np.asarray(jax.random.uniform(key, (n,)))
    jit = (np.random.RandomState(image).randint(0, 8, n) / 8).astype(
        np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda k, shape, *a, **kw: jnp.asarray(jit))
    return key, jit


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hold(got, want, what):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=TARGET_ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_anchor_assign_matches_the_jax_core(case, monkeypatch):
    anchors = _anchors()
    gt, crowd, _, collide = _case(case)
    info = np.tile([[HW, HW, 1.0]], (2, 1)).astype(np.float32)
    want, jitters = [], []
    for b in range(2):
        with monkeypatch.context() as m:
            key, jit = _jitter(m, collide, len(anchors), b)
            want.append(jde._anchor_assign_single(
                jnp.asarray(anchors), jnp.asarray(gt[b]),
                jnp.asarray(crowd[b]), jnp.asarray(info[b:b + 1]), key,
                retina=False, **RPN))
        jitters.append(jit)
    got = tde.anchor_assign(_t(anchors), _t(gt), _t(crowd), _t(info),
                            _t(np.stack(jitters)), **RPN)
    names = ("loc_index", "score_index", "tgt_label", "tgt_bbox", "bbox_w")
    for b in range(2):
        for name, g, w in zip(names, got, want[b]):
            _hold(g[b], w, f"image {b} {name}")
    n_fg = [int((np.asarray(w[0]) >= 0).sum()) for w in want]
    n_bg = [int((np.asarray(w[2]) == 0).sum()) for w in want]
    if case == "no_valid_gt":
        assert n_fg[1] == 0 and n_bg[1] == RPN["batch_size"]
    else:
        assert min(n_fg) > 0 and min(n_bg) > 0


@pytest.mark.parametrize("case", CASES)
def test_proposal_labels_match_the_jax_core(case, monkeypatch):
    gt, crowd, cls, collide = _case(case)
    rng = np.random.RandomState(5)
    # proposals: jittered copies of the gt boxes (fg), random boxes (bg)
    # and zero padding rows, as collect_fpn_proposals leaves them
    near = np.repeat(np.abs(gt), 3, axis=1) + rng.randn(2, 3 * G, 4) * 3
    rois = np.concatenate([near, _gt(rng, 2), np.zeros((2, 4, 4))],
                          1).astype(np.float32)
    n = rois.shape[1] + G
    want, jitters = [], []
    for b in range(2):
        with monkeypatch.context() as m:
            key, jit = _jitter(m, collide, n, b)
            want.append(jde._proposal_labels_single(
                jnp.asarray(rois[b]), jnp.asarray(cls[b]),
                jnp.asarray(crowd[b]), jnp.asarray(gt[b]), key, B=CAP,
                **LABELS))
        jitters.append(jit)
    got = tde.proposal_labels(_t(rois), _t(cls), _t(crowd), _t(gt),
                              _t(np.stack(jitters)), cap=CAP, **LABELS)
    names = ("rois", "labels", "targets", "inside_w", "n_live", "max_ov")
    for b in range(2):
        for name, g, w in zip(names, got, want[b]):
            _hold(g[b], w, f"image {b} {name}")
    labels = [np.asarray(w[1]) for w in want]
    if case == "no_valid_gt":
        assert (labels[1] <= 0).all()
    else:
        assert all((lb > 0).any() and (lb == 0).any() for lb in labels)


def test_mask_labels_match_the_jax_core():
    rng = np.random.RandomState(8)
    gt, _, cls, _ = _case("two_images")
    segms = np.zeros((2, G, HW, HW), np.float32)
    for b in range(2):
        for g in range(G):
            x0, y0, x1, y1 = gt[b, g].astype(int)
            segms[b, g, y0:y1, x0:x1] = rng.rand(y1 - y0, x1 - x0) > 0.3
    segms[1, 2] = 0.0  # a gt without a bitmap: never matched
    rois = np.concatenate([gt + rng.randn(2, G, 4).astype(np.float32),
                           _gt(rng, 2), np.zeros((2, 2, 4), np.float32)], 1)
    labels = np.concatenate([cls, np.zeros((2, G), np.int32),
                             -np.ones((2, 2), np.int32)], 1)
    got = tde.mask_labels(_t(cls), _t(segms), _t(rois), _t(labels), 7, 5)
    for b in range(2):
        want = jde._mask_labels_single(
            jnp.asarray(cls[b]), jnp.asarray(segms[b]), jnp.asarray(rois[b]),
            jnp.asarray(labels[b]), 7, 5)
        for name, g, w in zip(("mask_rois", "has_mask", "targets"), got,
                              want):
            _hold(g[b], w, f"image {b} {name}")
        tgt = np.asarray(want[2]).reshape(len(rois[b]), 5, 49)
        assert ((tgt == 0) | (tgt == 1)).any() and (tgt == -1).any()


def _ctx(seed=5, abstract=False):
    return EmitContext(torch.device("cpu"), seed=seed, step=3,
                       abstract=abstract)


def test_sampling_jitter_is_a_pure_function_on_the_2_23_grid():
    op = OpView("rpn_target_assign", {"__uid__": 17})
    a = th.sampling_jitter(_ctx(), op, 3, 5000, "cpu")
    b = th.sampling_jitter(_ctx(), op, 3, 5000, "cpu")
    assert a.dtype == torch.float32 and a.shape == (3, 5000)
    assert torch.equal(a, b)
    v = a.double().numpy()
    assert (v >= 0).all() and (v < 1).all()
    steps = v * 2.0 ** 23
    np.testing.assert_array_equal(steps, np.round(steps))
    assert 0.45 < v.mean() < 0.55
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    other = th.sampling_jitter(_ctx(seed=6), op, 3, 5000, "cpu")
    assert (other != a).float().mean() > 0.99
    seeded = OpView("rpn_target_assign", {"__uid__": 17, "seed": 11})
    s1 = th.sampling_jitter(_ctx(), seeded, 3, 5000, "cpu")
    s2 = th.sampling_jitter(_ctx(seed=6), seeded, 3, 5000, "cpu")
    assert torch.equal(s1, s2) and not torch.equal(s1, a)
    meta = th.sampling_jitter(_ctx(abstract=True), op, 3, 5000, "meta")
    assert meta.shape == (3, 5000) and meta.device.type == "meta"
