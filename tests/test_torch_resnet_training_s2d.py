"""Port parity for bench_resnet's program with space_to_depth_stem:
space-to-depth(2) into a [B, 12, 16, 16] map, pad2d [1, 2, 1, 2] and a
4x4/s1 conv in place of the 7x7/s2 stem, ResNet-18 on 3x32x32, B=4, 10
classes, Momentum(1e-3, 0.9), the port against the JAX package on the
CPU, under test_torch_resnet_training.py's checks and tolerances (its
own file, so that parallel test workers run its JAX run beside that
file's)."""

import pytest

from test_torch_resnet_training import (check_programs_match,
                                        check_two_momentum_steps,
                                        jax_two_steps)
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def jax_run():
    return jax_two_steps(True)


def test_programs_match_in_ops_names_shapes_and_dtypes(jax_run):
    check_programs_match(jax_run, True)


def test_two_momentum_steps_match_the_jax_package(jax_run):
    check_two_momentum_steps(jax_run, True)
