"""The lookup ops' static-size unique (paddle_tpu_torch/ops/sparse.py
static_unique) against ``jnp.unique(keys, size=N, fill_value=0,
return_inverse=True)``, which the JAX package's lookups call: equal
exactly, the distinct keys ascending, then the fill, and the same
inverse, on seeded keys (all distinct, all equal, power-law, with the id
0, one key).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.sparse import static_unique


def _keys(kind):
    rng = np.random.RandomState(7)
    return {
        "distinct": rng.permutation(300),
        "all_equal": np.full(64, 41),
        "power_law": (5000 * rng.power(0.35, 512)).astype(np.int64),
        "with_zero": np.array([0, 9, 0, 3, 9, 0, 1]),
        "one": np.array([5]),
    }[kind]


@pytest.mark.parametrize("kind", ["distinct", "all_equal", "power_law",
                                  "with_zero", "one"])
def test_static_unique_equals_jnp_unique(kind):
    keys = _keys(kind)
    want_u, want_inv = jnp.unique(jnp.asarray(keys, jnp.int32),
                                  size=len(keys), fill_value=0,
                                  return_inverse=True)
    got_u, got_inv = static_unique(torch.as_tensor(keys, dtype=torch.long))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_inv.numpy(),
                                  np.asarray(want_inv).reshape(-1))
    np.testing.assert_array_equal(got_u[got_inv].numpy(), keys)
