"""Eager DataParallel on two gloo ranks (tests/torch_sp_worker.py:
`Ranks` children over a FileStore under tmp_path; DataParallel over
the "dp" axis of a 2-rank mesh, parallel.make_mesh): each rank runs two
eager Adam steps of a small MLP on its half of the batch, scaling its
mean loss by 1/2 and summing the gradients over the ranks with
`apply_collective_grads` (one all_reduce per dtype over a coalesced
buffer). Every rank's summed gradients equal the single-process run's
on the whole batch (atol 1e-6 + rtol 1e-5: the two halves' sums in
another order), the parameters stay bit-equal across the ranks and match
the single-process run's after both steps, and no rank imported jax or
paddle_tpu."""

import numpy as np

import paddle_tpu_torch as tf
from paddle_tpu_torch import dygraph as tdg

from torch_sp_worker import Ranks, dygraph_dp_steps, dygraph_dp_worker

STEPS = 2


def test_two_ranks_match_the_single_process_run(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(8, 6).astype("float32")
    y = rng.randn(8, 3).astype("float32")
    with tdg.guard(tf.CPUPlace()):
        net = tdg.Sequential(tdg.Linear(6, 16, act="tanh"),
                             tdg.Linear(16, 3))
        state = net.state_dict()
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, x=x, y=y, **{f"state/{k}": v for k, v in state.items()})
    ranks = Ranks(dygraph_dp_worker, 2, tmp_path, str(inputs), STEPS)
    want = dygraph_dp_steps(tf, tdg, state, x, y, STEPS, False)
    got = ranks.results()
    for r, res in enumerate(got):
        assert not res["imported_jax"] and res["nranks"] == 2
        for i in range(STEPS):
            for n in state:
                key = f"{i}/grad/{n}"
                np.testing.assert_allclose(res[key], want[key], atol=1e-6,
                                           rtol=1e-5, err_msg=f"{r} {key}")
        for n in state:
            key = f"state/{n}"
            np.testing.assert_array_equal(res[key], got[0][key])
            np.testing.assert_allclose(res[key], want[key], atol=1e-6,
                                       rtol=1e-5, err_msg=key)
            assert not np.array_equal(res[key], state[n])
    # the ranks' losses are their halves' means; their mean is the whole's
    for i in range(STEPS):
        np.testing.assert_allclose(
            (got[0][f"{i}/loss"] + got[1][f"{i}/loss"]) / 2,
            want[f"{i}/loss"], rtol=1e-5)
