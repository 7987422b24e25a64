"""Each optimizer of tests/test_torch_optimizer_zoo.py constructed with
regularization=L2Decay and grad_clip=GradientClipByGlobalNorm (active:
the scale below 1 at both steps), the weight with its own L1Decay
through ParamAttr, for two steps of fit-a-line against the JAX package
(tests/torch_fit_a_line.py). Tolerances as the zoo's: losses and clip
scales rtol 1e-5; every parameter and accumulator atol 1e-6 + rtol
1e-5."""

import numpy as np
import pytest

from test_torch_optimizer_zoo import ZOO, maker
from torch_fit_a_line import assert_states_close, fit_a_line, line_feeds, \
    run_both
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", list(ZOO))
def test_with_a_regularizer_and_a_clip_matches_the_jax_package(name):
    """Two steps; the program holds the weight's `sign` and the global
    norm's `reciprocal` once each."""
    def extra(f):
        return dict(regularization=f.regularizer.L2Decay(0.05),
                    grad_clip=f.clip.GradientClipByGlobalNorm(1.0))

    def body(fluid):
        attr = fluid.ParamAttr(regularizer=fluid.regularizer.L1Decay(0.02))
        loss, _, _ = fit_a_line(maker(name, extra), param_attr=attr)(fluid)
        return loss, fluid.default_main_program().global_block.var(
            "clip_scale_0")

    r = run_both(body, line_feeds(2), fetch=lambda out: list(out))
    for got, want in zip(r["port"], r["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert 0.0 < float(got[1][0]) < 1.0
    assert_states_close(r["port_end"], r["jax_end"], rtol=1e-5, atol=1e-6)
    ops = [op.type for op in r["port_main"].global_block.ops]
    assert ops.count("sign") == 1 and ops.count("reciprocal") == 1
