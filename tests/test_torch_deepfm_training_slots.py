"""bench deepfm_fused's per-slot DeepFM layout (one lookup per sparse
slot), unfused and fused by embedding.fuse_lookups: three Adam steps in
the port from the JAX package's startup state against the JAX package's,
under test_torch_deepfm_training.py's tolerances (that file has the
config, the feeds and the readings).
"""

import pytest

from test_torch_deepfm_training import check_three_adam_steps
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("layout", ["per_slot", "fused"])
def test_three_adam_steps_match_the_jax_package(layout):
    check_three_adam_steps(layout)
