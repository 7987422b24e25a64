"""tests/torch_sp_worker.py's Ranks, which the multi-rank CPU tests
(test_torch_ring_attention.py, test_torch_sp_training.py) start their
gloo ranks with: every wait it makes is bounded, so a rank that hangs or
dies fails the test in bounded time with each rank's exit code, and no
child outlives the call."""

import time

import pytest

import torch_sp_worker
from torch_sp_worker import Ranks


def test_results_return_what_every_rank_wrote(tmp_path):
    ranks = Ranks(torch_sp_worker.stall_worker, 2, tmp_path, {})
    assert [int(r["rank"]) for r in ranks.results()] == [0, 1]


def test_a_hung_and_a_failed_rank_fail_with_every_exit_code(tmp_path):
    """Rank 1 sleeps past the wait, rank 2 exits with 3: results() raises
    within the child timeout (plus the start) naming (rank, exit code)
    of all three, and kills rank 1."""
    ranks = Ranks(torch_sp_worker.stall_worker, 3, tmp_path,
                  {1: 3600.0, 2: -3})
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        ranks.results(timeout=5)
    assert time.monotonic() - t0 < 240 + 3 * 5 + 30
    msg = str(err.value)
    assert "[(0, 0), (1, -9), (2, 3)]" in msg, msg
    assert "ranks [1] still running after 5 s" in msg, msg
    assert not any(p.is_alive() for p in ranks.procs)


class _SlowStarts(Ranks):
    """Ranks whose starter pauses a second after each start."""

    def _start(self):
        for p in self.procs:
            if self._stop.is_set():
                return
            p.start()
            time.sleep(1.0)


def test_a_start_past_its_timeout_stops_the_starts_and_kills_the_started(
        tmp_path):
    """results() finds the starter mid-way (start_timeout under the
    pause): it starts no further rank, kills rank 0 (which would sleep
    an hour) and raises naming the ranks that started."""
    ranks = _SlowStarts(torch_sp_worker.stall_worker, 3, tmp_path,
                        {0: 3600.0})
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        ranks.results(start_timeout=0.5)
    assert time.monotonic() - t0 < 240 + 30
    msg = str(err.value)
    assert "started ranks [0] of 3, killed" in msg, msg
    assert "still under way" not in msg, msg
    assert ranks.procs[0].exitcode == -9
    assert [p.pid for p in ranks.procs[1:]] == [None, None]
    assert not ranks._starter.is_alive()
