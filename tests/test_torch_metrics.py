"""Port parity for the metrics: the `auc` op (paddle_tpu_torch/ops/
metrics.py) in a one-op program, its statistics carried over three
batches, and the host-side streaming metrics (paddle_tpu_torch/
metrics.py: Accuracy, Precision, Recall, Auc, EditDistance and
CompositeMetric) fed the same batches as the JAX package's, the port's
also as torch tensors.

Inputs come from numpy with a fixed seed, with predictions on bucket
edges. Tolerances: the op's AUC rtol 1e-6 (a sum over the buckets in
fp32), its bucket counts exactly (after a cast: the JAX package's are
int32); the host metrics' values rtol 1e-12 (the same float64 numpy
arithmetic).
"""

import numpy as np
import pytest
import torch

from paddle_tpu import metrics as jm

from paddle_tpu_torch import metrics as tm

from torch_fit_a_line import JAX, PORT, run_op


def _batches(n=3, size=32, two_cols=True, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = rng.rand(size).astype("float32")
        p[:4] = [0.0, 1.0, 0.5, 0.25]  # bucket edges
        label = (rng.rand(size) < 0.4).astype("int64")[:, None]
        pred = np.stack([1 - p, p], 1) if two_cols else p
        out.append((pred, label))
    return out


@pytest.mark.parametrize("two_cols,num", [(True, 4095), (False, 200),
                                          (True, 7)])
def test_auc_op_matches_the_jax_package(two_cols, num):
    stats = {pkg: [np.zeros(num + 1, "int64")] * 2 for pkg in ("j", "t")}
    for pred, label in _batches(two_cols=two_cols):
        outs = {}
        for key, pkg in (("j", JAX), ("t", PORT)):
            outs[key] = run_op(
                pkg, "auc", {"Predict": [pred], "Label": [label],
                             "StatPos": [stats[key][0]],
                             "StatNeg": [stats[key][1]]},
                {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1},
                {"num_thresholds": num})
            stats[key] = [outs[key]["StatPosOut"][0],
                          outs[key]["StatNegOut"][0]]
        for slot in ("StatPosOut", "StatNegOut"):
            w = outs["j"][slot][0]
            np.testing.assert_array_equal(outs["t"][slot][0].astype(w.dtype),
                                          w)
        np.testing.assert_allclose(outs["t"]["AUC"][0], outs["j"]["AUC"][0],
                                   rtol=1e-6)
    assert 0.0 < float(outs["t"]["AUC"][0][0]) < 1.0
    assert int(stats["t"][0].sum() + stats["t"][1].sum()) == 3 * 32


def test_auc_op_is_zero_while_a_class_is_empty():
    pred = np.random.RandomState(3).rand(8).astype("float32")
    zeros = np.zeros(11, "int64")
    for label in (np.zeros((8, 1), "int64"), np.ones((8, 1), "int64")):
        ins = {"Predict": [pred], "Label": [label], "StatPos": [zeros],
               "StatNeg": [zeros]}
        outs = {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1}
        got = run_op(PORT, "auc", ins, outs, {"num_thresholds": 10})
        want = run_op(JAX, "auc", ins, outs, {"num_thresholds": 10})
        assert got["AUC"][0].tolist() == [0.0] == want["AUC"][0].tolist()


def _feed(metric_cls_pair, batches, as_tensor):
    jmet, tmet = (cls() for cls in metric_cls_pair)
    for args in batches:
        jmet.update(*args)
        targs = [torch.from_numpy(np.asarray(a)) if as_tensor
                 and isinstance(a, np.ndarray) else a for a in args]
        tmet.update(*targs)
    return jmet, tmet


def _binary_batches():
    rng = np.random.RandomState(1)
    return [((rng.rand(16) > 0.5).astype("float32"),
             (rng.rand(16) > 0.5).astype("int64")) for _ in range(3)]


# each metric's update arguments, a batch at a time
METRICS = {
    "Precision": _binary_batches,
    "Recall": _binary_batches,
    "Auc": _batches,
    "Accuracy": lambda: [(np.array([0.25], "float32"), 4.0),
                         (np.array([0.75], "float32"), 2.0)],
    "EditDistance": lambda: [(np.array([1.0, 0.0, 3.0], "float32"), None),
                             (np.array([2.0], "float32"), 4)],
}


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_the_jax_package(name, as_tensor):
    batches = METRICS[name]()
    jmet, tmet = _feed((getattr(jm, name), getattr(tm, name)), batches,
                       as_tensor)
    np.testing.assert_allclose(tmet.eval(), jmet.eval(), rtol=1e-12)
    assert tmet.get_config().keys() == jmet.get_config().keys()
    tmet.reset()
    jmet.reset()
    if name in ("Accuracy", "EditDistance"):
        with pytest.raises(ValueError):
            tmet.eval()
    else:
        assert tmet.eval() == jmet.eval() == 0.0


def test_composite_metric_matches_the_jax_package():
    batches = _binary_batches()
    comp = {}
    for mod in (jm, tm):
        c = mod.CompositeMetric()
        c.add_metric(mod.Precision())
        c.add_metric(mod.Recall())
        for preds, labels in batches:
            c.update(preds, labels)
        comp[mod] = c.eval()
    np.testing.assert_allclose(comp[tm], comp[jm], rtol=1e-12)
    with pytest.raises(TypeError):
        tm.CompositeMetric().add_metric(object())
