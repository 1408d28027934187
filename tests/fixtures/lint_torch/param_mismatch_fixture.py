"""Seeded parameter mismatch: every rank allreduces — same op, same
order — but rank 1 passes a different count.  Each engine derives its
wire format and segmentation from its own descriptor, so this desyncs
the dataplane (or hangs the gang) at runtime.  accl_lint must flag it
(``param-mismatch``) and exit nonzero.
"""
import numpy as np

from accl_tpu_torch import ReduceFunction

LINT_RANKS = 2
COUNT = 256


def accl_main(accl, rank):
    src = accl.create_buffer(COUNT, np.float32)
    dst = accl.create_buffer(COUNT, np.float32)
    count = COUNT if rank == 0 else COUNT // 2
    accl.allreduce(src, dst, count, ReduceFunction.SUM)
