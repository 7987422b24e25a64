"""Port parity for the eager (dygraph) path in evaluation: the BERT
classifier of tests/test_torch_dygraph_bert.py (chip_smoke.py's
`build_dygraph_bert`, 2 layers, hidden 64, 4 heads, B=2, S=32) with the
JAX package's initial weights carried across, in `net.eval()` under
`no_grad` (every fused op in test mode), on the CPU, fp32.

Tolerance: the logits within atol 1e-5 (two fp32 layers' sums in other
orders). The port's outputs under no_grad
record no graph, and a training-mode forward with dropout 0 gives the
same logits as eval mode (downgrade_in_infer at rate 0 scales by 1).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu import dygraph as jdg
from paddle_tpu import layers as jl
from paddle_tpu.models.bert import BertConfig as JBertConfig

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch import layers as tl

from test_torch_dygraph_bert import B, CFG, S

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import build_dygraph_bert, dygraph_batches  # noqa: E402

KEYS = ("ids", "types", "mask")


@pytest.fixture(scope="module")
def jax_eval():
    cfg = JBertConfig(**CFG)
    batch = dygraph_batches(cfg, B, S, 1, seed=5)[0]
    with jdg.guard():
        net = build_dygraph_bert(jdg, jl, cfg)
        net.eval()
        with jdg.no_grad():
            logits = net(*[jdg.to_variable(batch[k]) for k in KEYS]).numpy()
        return cfg, batch, net.state_dict(), np.asarray(logits)


def test_eval_logits_match_the_jax_package(jax_eval):
    cfg, batch, state, want = jax_eval
    with tdg.guard(tf.CPUPlace()):
        net = build_dygraph_bert(tdg, tl, cfg)
        convert.layer_state_from_numpy(net, state)
        net.eval()
        with tdg.no_grad():
            out = net(*[tdg.to_variable(batch[k]) for k in KEYS])
        assert out.value.grad_fn is None and out.stop_gradient
        got = out.numpy()
        net.train()
        train = net(*[tdg.to_variable(batch[k]) for k in KEYS])
        assert train.value.grad_fn is not None
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(train.numpy(), got, rtol=0, atol=1e-6)
