"""Seeded issue-order desync: rank 0 allreduces while rank 1
broadcasts on the same communicator — the classic mismatched-order bug
that hangs both engines until the watchdog fires.  accl_lint must flag
it (``desync-order``) and exit nonzero; CI asserts exactly that.
"""
import numpy as np

from accl_tpu_torch import ReduceFunction

LINT_RANKS = 2


def accl_main(accl, rank):
    src = accl.create_buffer(256, np.float32)
    dst = accl.create_buffer(256, np.float32)
    if rank == 0:
        accl.allreduce(src, dst, 256, ReduceFunction.SUM)
    else:
        accl.bcast(src, 256, root=0)
