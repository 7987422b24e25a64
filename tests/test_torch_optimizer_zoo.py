"""Port parity for the optimizer zoo (paddle_tpu_torch/optimizer.py and
ops/optimizer_ops.py): AdamW, Lamb, LarsMomentum, Adagrad,
DecayedAdagrad, RMSProp (plain and centered), Adadelta, Adamax, Ftrl,
Dpsgd, ProximalGD and ProximalAdagrad, each for two steps on
tests/test_optimizers_sweep.py's fit-a-line program against the JAX
package (tests/torch_fit_a_line.py: one program built in both from a
fresh unique_name state, the JAX package's startup state carried across,
the same feeds). Also dpsgd's noise, DGCMomentum's refusal, set_lr, and
the ops average_accumulates and amp_check_finite_and_scale alone.

Tolerances, fp32 both sides, sums in other orders: losses rtol 1e-5;
every parameter and accumulator atol 1e-6 + rtol 1e-5 (the largest of
three feed seeds: 1.7e-6 of (|value| + 1e-6), RMSProp's momentum and
DecayedAdagrad's bias); the ops alone rtol 1e-6, counters exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tf
from paddle_tpu_torch.errors import UnimplementedError
from paddle_tpu_torch.ops._helpers import gaussian_noise
from paddle_tpu_torch.framework.registry import EmitContext, OpView

from torch_fit_a_line import (JAX, PORT, build, fit_a_line, line_feeds,
                              run_both, run_op, assert_states_close)
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

# name: (optimizer class, positional arguments, keyword arguments)
ZOO = {
    "AdamW": ("AdamW", (0.05,), dict(weight_decay=0.1)),
    "Lamb": ("Lamb", (0.05,), dict(lamb_weight_decay=0.01)),
    "LarsMomentum": ("LarsMomentum", (0.05,), dict(momentum=0.9)),
    "Adagrad": ("Adagrad", (0.2,), dict(initial_accumulator_value=0.1)),
    "DecayedAdagrad": ("DecayedAdagrad", (0.2,), {}),
    "RMSProp": ("RMSProp", (0.02,), dict(momentum=0.5)),
    "RMSPropCentered": ("RMSProp", (0.02,), dict(momentum=0.5,
                                                centered=True)),
    "Adadelta": ("Adadelta", (8.0,), {}),
    "Adamax": ("Adamax", (0.05,), {}),
    "Ftrl": ("Ftrl", (0.2,), dict(l1=0.01, l2=0.01)),
    "FtrlPower": ("Ftrl", (0.2,), dict(lr_power=-0.3)),
    "Dpsgd": ("Dpsgd", (0.1,), dict(clip=1.0, sigma=0.0)),
    "ProximalGD": ("ProximalGD", (0.05,), dict(
        l1_regularization_strength=0.01, l2_regularization_strength=0.01)),
    "ProximalAdagrad": ("ProximalAdagrad", (0.2,), dict(
        l1_regularization_strength=0.01, l2_regularization_strength=0.01)),
}


def maker(name, extra=lambda f: {}):
    """ZOO[name]'s optimizer in a package, with extra(fluid)'s keyword
    arguments besides."""
    cls, args, kw = ZOO[name]
    return lambda f: getattr(f.optimizer, cls)(*args, **kw, **extra(f))


# the accumulators each optimizer keeps per parameter
ACCUMS = {"AdamW": 4, "Lamb": 4, "LarsMomentum": 1, "Adagrad": 1,
          "DecayedAdagrad": 1, "RMSProp": 3, "RMSPropCentered": 3,
          "Adadelta": 2, "Adamax": 3, "Ftrl": 2, "FtrlPower": 2, "Dpsgd": 0,
          "ProximalGD": 0, "ProximalAdagrad": 1}


@pytest.mark.parametrize("name", list(ZOO))
def test_two_steps_match_the_jax_package(name):
    """The program op for op, the losses, and every parameter and
    accumulator after two steps (Dpsgd at sigma 0: no noise)."""
    r = run_both(fit_a_line(maker(name)), line_feeds(2))
    for got, want in zip(r["port"], r["jax"]):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert_states_close(r["port_end"], r["jax_end"], rtol=1e-5, atol=1e-6)
    accums = [v for v in r["port_main"].list_vars()
              if getattr(v, "_accum_of", None)]
    assert len(accums) == 2 * ACCUMS[name]
    for p in ("fc_w_0", "fc_b_0"):
        assert not np.array_equal(r["jax_end"][p], r["start"][p])
    for v in accums:  # RMSProp keeps its mean gradient only centered
        if name != "RMSProp" or "mean_grad" not in v.name:
            assert not np.array_equal(r["port_end"][v.name],
                                      r["start"][v.name]), v.name


def _dpsgd_end(seed, sigma=1.0):
    main, startup, (loss, _, _) = build(
        PORT, fit_a_line(lambda f: f.optimizer.Dpsgd(0.1, clip=1.0,
                                                     sigma=sigma)), seed)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    torch.manual_seed(0)
    exe.run(startup, scope=scope)
    start = scope.find_var("fc_w_0").clone()
    for feed in line_feeds(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return start, scope.find_var("fc_w_0")


def test_dpsgd_noise_is_a_function_of_the_seed():
    """With sigma 1 the update carries the op's own Gaussian draw: two
    runs of one program seed end equal, another seed ends elsewhere, and
    both differ from the noiseless step."""
    start, a = _dpsgd_end(5)
    start_b, b = _dpsgd_end(5)
    _, quiet = _dpsgd_end(5, sigma=0.0)
    assert torch.equal(start, start_b) and torch.equal(a, b)
    c_start, c = _dpsgd_end(6)
    assert not torch.equal(a - start, c - c_start)
    assert not torch.equal(a, quiet)


def test_gaussian_noise_is_standard_normal_and_keyed():
    ctx = EmitContext("cpu", seed=11, step=2)
    op = OpView("dpsgd", {"__uid__": 4})
    z = gaussian_noise(ctx, op, (256, 512), torch.device("cpu"))
    assert torch.isfinite(z).all()
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    assert torch.equal(z, gaussian_noise(ctx, op, (256, 512), "cpu"))
    other = EmitContext("cpu", seed=11, step=3)
    assert not torch.equal(z, gaussian_noise(other, op, (256, 512), "cpu"))
    seeded = OpView("dpsgd", {"__uid__": 4, "seed": 9})
    assert torch.equal(gaussian_noise(ctx, seeded, (8,), "cpu"),
                       gaussian_noise(other, seeded, (8,), "cpu"))


def test_dgc_momentum_raises_naming_its_item():
    with pytest.raises(UnimplementedError, match="item 1"):
        tf.optimizer.DGCMomentum(0.1, momentum=0.9)


def test_set_lr_takes_effect_at_run_time():
    """set_lr writes the [1] learning rate into the scope on its device;
    the next step moves by the new rate, as in the JAX package."""
    main, startup, (loss, opt, pg) = build(
        PORT, fit_a_line(lambda f: f.optimizer.SGD(0.1)))
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    opt.set_lr(0.0, scope=scope)
    before = scope.find_var("fc_w_0").clone()
    exe.run(main, feed=line_feeds(1)[0], scope=scope)
    assert torch.equal(before, scope.find_var("fc_w_0"))
    opt.set_lr(0.25, scope=scope)
    assert float(scope.find_var(opt._lr_var.name)) == 0.25
    exe.run(main, feed=line_feeds(1)[0], scope=scope)
    assert not torch.equal(before, scope.find_var("fc_w_0"))


@pytest.mark.parametrize("attrs,counts", [
    # spill into sum_2 at the 16384th update, then retire into sum_3
    ({"average_window": 0.5, "min_average_window": 2,
      "max_average_window": 5}, (4, 0, 16383)),
    # the window not yet full: accumulate only
    ({"average_window": 0.15, "min_average_window": 10000,
      "max_average_window": 10000}, (7, 3, 20)),
])
def test_average_accumulates_matches_the_jax_package(attrs, counts):
    rng = np.random.RandomState(4)
    ins = {"param": [rng.randn(3, 5).astype("float32")]}
    for i in (1, 2, 3):
        ins[f"in_sum_{i}"] = [rng.randn(3, 5).astype("float32")]
    for slot, n in zip(("in_num_accumulates", "in_old_num_accumulates",
                        "in_num_updates"), counts):
        ins[slot] = [np.array([n], "int32")]
    outs = {k: 1 for k in ("out_sum_1", "out_sum_2", "out_sum_3",
                           "out_num_accumulates", "out_old_num_accumulates",
                           "out_num_updates")}
    want = run_op(JAX, "average_accumulates", ins, outs, attrs)
    got = run_op(PORT, "average_accumulates", ins, outs, attrs)
    for slot in outs:
        w, g = want[slot][0], got[slot][0]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=slot)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=slot)


@pytest.mark.parametrize("poison", [None, np.inf, np.nan])
def test_amp_check_finite_and_scale_matches_the_jax_package(poison):
    rng = np.random.RandomState(5)
    xs = [rng.randn(4, 3).astype("float32"), rng.randn(6).astype("float32")]
    if poison is not None:
        xs[1][2] = poison
    ins = {"X": xs, "Scale": [np.array([0.125], "float32")]}
    outs = {"Out": 2, "FoundInfinite": 1}
    want = run_op(JAX, "amp_check_finite_and_scale", ins, outs, {})
    got = run_op(PORT, "amp_check_finite_and_scale", ins, outs, {})
    for g, w in zip(got["Out"], want["Out"]):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    assert got["FoundInfinite"][0].tolist() == [poison is not None]
    np.testing.assert_array_equal(got["FoundInfinite"][0],
                                  want["FoundInfinite"][0])
