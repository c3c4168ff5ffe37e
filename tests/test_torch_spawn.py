"""PyTorch port: how ``utils.distributed.spawn`` orders a world's
failures, with no world started, and the intra-op threads it gives each
rank.

When a rank raises, its teardown breaks its peers' collectives and they
raise too; both exits can land inside one poll of the parent.  The report
must name the rank whose body raised first (by the time each rank caught
its error, written beside its result), then the other failed ranks, then
those that died without a result, in the order the poll saw them.  A
rank writes its result before its teardown, so the first failure is on
disk when its peers fail; and a caller that is killed takes its ranks
with it.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from neuronx_distributed_tpu_torch.utils.distributed import (
    failure_order,
    spawn,
)
import torch_tp_workers as workers

ROOT = ("error", "ValueError: planned failure", 10.0)
PEER = ("error", "RuntimeError: Connection closed by peer", 10.2)


@pytest.mark.parametrize("seen, results, want", [
    # both exits inside one poll, seen lowest rank first: the root cause
    # (rank 1) still leads
    ([0, 1], [PEER, ROOT], [1, 0]),
    ([1, 0], [PEER, ROOT], [1, 0]),
    # the peer was killed before it raised: no result of its own
    ([1], [None, ROOT], [1]),
    # a rank that died without a result (a crash) follows the raised ones
    ([2, 0], [PEER, ("ok", 3), None], [0, 2]),
    ([2, 3], [("ok", 1), ("ok", 2), None, None], [2, 3]),
    # equal times: by rank
    ([1, 0], [ROOT, ROOT], [0, 1]),
], ids=["one_poll_low_first", "one_poll_high_first", "peer_killed",
        "crash_after_raise", "crashes_in_poll_order", "tie_by_rank"])
def test_failure_order_puts_the_root_cause_first(seen, results, want):
    assert failure_order(seen, results) == want


def test_spawned_ranks_run_a_fixed_thread_count():
    """Each rank runs 2 intra-op threads, not one a core: worlds side by
    side would oversubscribe the machine.  ``env`` sets another count."""
    assert spawn(workers.rank_threads, 2, timeout_s=60) == [(2, "2")] * 2
    assert spawn(workers.rank_threads, 1, timeout_s=60,
                 env={"OMP_NUM_THREADS": "3"}) == [(3, "3")]


def test_the_rank_that_raised_is_reported_with_its_error():
    """Rank 1 raises, its teardown breaks rank 0's barrier: the report
    leads with rank 1 and its own error, written before the teardown."""
    with pytest.raises(RuntimeError) as e:
        spawn(workers.fail_on_rank1, 2, timeout_s=60)
    msg = str(e.value)
    assert msg.startswith("rank 1 of 2 failed first"), msg[:400]
    assert "ValueError: planned failure on rank 1" in msg


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie is dead but not yet reaped by its (dead) parent's adopter
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="the parent-death signal is Linux's")
def test_a_killed_caller_leaves_no_rank_running(tmp_path):
    """A caller killed with SIGKILL in the middle of a world (as a time
    limit kills a script) takes every rank with it."""
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import torch_tp_workers as w; "
            "from neuronx_distributed_tpu_torch.utils.distributed import "
            "spawn; spawn(w.report_pid_and_sleep, 2, (sys.argv[3],), "
            "timeout_s=300)")
    caller = subprocess.Popen([sys.executable, "-c", code, repo, here,
                               str(tmp_path)])
    try:
        deadline = time.monotonic() + 60
        while len(list(tmp_path.glob("*.pid"))) < 2:
            assert caller.poll() is None, "the caller exited early"
            assert time.monotonic() < deadline, "the ranks never started"
            time.sleep(0.1)
        pids = [int(p.read_text()) for p in tmp_path.glob("*.pid")]
        assert all(_alive(p) for p in pids)
        caller.send_signal(signal.SIGKILL)
        caller.wait()
        deadline = time.monotonic() + 20
        while any(_alive(p) for p in pids) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not any(_alive(p) for p in pids), "a rank outlived its caller"
    finally:
        if caller.poll() is None:
            caller.kill()
            caller.wait()
