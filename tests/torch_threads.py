"""A fixture for the port's CPU test files whose work is thousands of
small tensor ops (the tile-by-tile emulations of the kernels and the
plain tiled versions): one intra-op thread while the file runs.

With torch's default of one thread a core in every process, the six
workers of the parallel test run (pytest -n 6) spin 48 threads on an
8-core host through every small op's parallel region:
test_torch_ring_block_split.py's tiled-pair emulation took 513 s there
against 4 s alone, and test_torch_flash_tiled.py's mask test 54 s
against 2 s. One thread changes no result: these tests compare against
fp64 or their own tolerances, and the ops are too small to gain from
threads.

    from torch_threads import one_cpu_thread  # noqa: F401 (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
