"""Port parity for the eager (dygraph) path: the BERT classifier that
chip_smoke.py trains on the card (`build_dygraph_bert`), built in the JAX
package's dygraph and in the port's, on the CPU at 2 layers, hidden 64,
4 heads, FFN 192, vocab and positions 64 (few distinct shapes: the JAX
package compiles each op and each Adam update per shape), B=2, S=32,
dropout 0, fp32.

The JAX package's freshly initialised weights are carried into the
port's net by name (`convert.layer_state_from_numpy` of its
`state_dict()`), and both train three eager Adam steps under
LinearLrWarmup over PolynomialDecay on the same numpy batches.
tests/test_torch_dygraph_bert_eval.py holds the eval-mode logits.

Tolerances, fp32 on both sides, sums in other orders (those of
tests/test_torch_bert_training.py):
- loss: rtol 1e-5 at every step;
- every parameter's gradient at every step: atol 1e-5 + rtol 1e-4;
- each parameter after the three steps, end - start: within 1e-3 of
  (|update| + lr) of the JAX package's, but for the elements whose two
  gradients differ by more than 1e-4 of the JAX package's at a step
  (Adam follows the sign of a near-zero gradient); those stay under 2%
  of the elements.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu import dygraph as jdg
from paddle_tpu import layers as jl
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.optimizer import Adam as JAdam

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.optimizer import Adam as TAdam

from test_torch_bert_training import _check_updates

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import build_dygraph_bert, dygraph_batches  # noqa: E402

B, S, STEPS = 2, 32, 3
CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=192, max_position=64, hidden_dropout=0.0,
           attention_dropout=0.0)
LR_PEAK = 1e-3


def _schedule(dg):
    """A short warmup from 1e-4 over polynomial decay, so that every one
    of the three steps moves the weights at its own rate."""
    return dg.LinearLrWarmup(dg.PolynomialDecay(LR_PEAK, 10, 1e-4), 2, 1e-4,
                             LR_PEAK)


def _train(dg, layers, adam, place_guard, start=None):
    """(net's first state, per step (loss, {param: grad}), end state, the
    schedule's step after each minimize) of three eager steps."""
    cfg = JBertConfig(**CFG)
    batches = dygraph_batches(cfg, B, S, STEPS, seed=3)
    with place_guard():
        net = build_dygraph_bert(dg, layers, cfg)
        if start is not None:
            assert len(convert.layer_state_from_numpy(net, start)) == \
                len(start)
        first = net.state_dict()
        opt = adam(_schedule(dg), parameter_list=net.parameters())
        steps, lrs = [], []
        for b in batches:
            loss, _ = net(*[dg.to_variable(b[k])
                            for k in ("ids", "types", "mask", "label")])
            loss.backward()
            grads = {n: p.gradient() for n, p in net.named_parameters()}
            opt.minimize(loss)
            lrs.append(opt._learning_rate.step_num)
            net.clear_gradients()
            steps.append((np.asarray(loss.numpy()), grads))
        return first, steps, net.state_dict(), lrs


@pytest.fixture(scope="module")
def runs():
    jax_run = _train(jdg, jl, JAdam, jdg.guard)
    port_run = _train(tdg, tl, TAdam, lambda: tdg.guard(tf.CPUPlace()),
                      start=jax_run[0])
    return jax_run, port_run


def test_loss_and_every_gradient_match_the_jax_package(runs):
    (jfirst, jsteps, _, jlrs), (tfirst, tsteps, _, tlrs) = runs
    assert set(tfirst) == set(jfirst) and len(jfirst) == 33
    for n, v in jfirst.items():
        np.testing.assert_array_equal(tfirst[n], v, err_msg=n)
    assert tlrs == jlrs == [1, 2, 3]  # the schedule advanced once a step
    for step, ((jl_, jg), (tl_, tg)) in enumerate(zip(jsteps, tsteps)):
        np.testing.assert_allclose(tl_, jl_, rtol=1e-5,
                                   err_msg=f"loss, step {step}")
        assert set(tg) == set(jg)
        for n, want in jg.items():
            assert want is not None and tg[n] is not None, n
            np.testing.assert_allclose(tg[n], want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{n}, step {step}")


def test_parameters_after_three_adam_steps_match(runs):
    (jfirst, jsteps, jend, _), (_, tsteps, tend, _) = runs
    grads = {n: [(t[1][n], j[1][n]) for t, j in zip(tsteps, jsteps)]
             for n in jsteps[0][1]}
    exempt, total = _check_updates(jfirst, tend, jend, grads, LR_PEAK)
    print(f"updates: {exempt} of {total} elements exempt")
    assert exempt < 0.02 * total
    moved = sum(not np.array_equal(jfirst[n], tend[n]) for n in grads)
    assert moved == len(grads)

