"""PyTorch port: how ``utils.distributed.spawn`` orders a world's
failures, with no world started.

When a rank raises, its teardown breaks its peers' collectives and they
raise too; both exits can land inside one poll of the parent.  The report
must name the rank whose body raised first (by the time each rank caught
its error, written beside its result), then the other failed ranks, then
those that died without a result, in the order the poll saw them.
"""

import pytest

from neuronx_distributed_tpu_torch.utils.distributed import failure_order

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
