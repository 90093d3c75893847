"""The deadlines of the parallel tests' rank programs
(`torch_parallel_workers.spawn`): a rank that never returns and a rank
that raises each end the spawn with a failure that names every rank's exit
code and the end of its stderr, and leave no rank running. No JAX import:
the ranks run gloo on the CPU."""

import time

import pytest

import torch_parallel_workers as workers


def test_a_stalled_rank_is_killed_at_the_deadline(monkeypatch):
    """Rank 1 sleeps an hour and rank 0 waits for it at the barrier: at a
    deadline of 30 s the spawn kills both and fails, naming the deadline,
    each rank's exit code (killed) and the line each wrote to stderr."""
    monkeypatch.setattr(workers, "SPAWN_DEADLINE_S", 30)
    with pytest.raises(AssertionError) as e:
        workers.spawn(2, "stall", 1)
    msg = str(e.value)
    assert "did not end within 30 s" in msg
    for r in (0, 1):
        assert f"-- rank {r}: exit code -9" in msg
        assert f"rank {r} of 2 started" in msg


def test_a_failing_rank_ends_the_spawn_with_its_traceback():
    """Rank 0 raises: the spawn fails with the rank's traceback and every
    rank's exit code, well before rank 1's barrier would time out (rank 1
    either fails at the barrier once rank 0 is gone or is terminated)."""
    t = time.monotonic()
    with pytest.raises(AssertionError) as e:
        workers.spawn(2, "raise", 0)
    msg = str(e.value)
    assert "-- rank 0: exit code" in msg and "-- rank 1: exit code" in msg
    rank0 = msg[msg.index("-- rank 0:"):msg.index("-- rank 1:")]
    assert "rank 0 fails on purpose" in rank0 and "ValueError" in rank0
    assert time.monotonic() - t < workers.TIMEOUT_S
