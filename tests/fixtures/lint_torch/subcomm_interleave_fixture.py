"""Seeded cross-communicator interleave hazard: a 2x2 grid where the
top row enters row-comm-then-col-comm but the bottom row enters
col-comm-then-row-comm.  Every per-comm stream agrees (same ops, same
params, same depth — ``desync-order`` stays quiet), but no global comm
order exists: the gang windows interlock, and the chunked/async
engines contend for the shared rx pool exactly like the 8-rank
sub-comm allgather wedge.  accl_lint must flag
``subcomm-interleave-hazard`` and exit nonzero.
"""
import numpy as np

LINT_RANKS = 4
COUNT = 256


def accl_main(accl, rank):
    row, col = divmod(rank, 2)
    # id discipline: every rank creates row comm then col comm, so id 1
    # is "my row" and id 2 is "my col" on every rank
    row_comm = accl.create_communicator([row * 2, row * 2 + 1])
    col_comm = accl.create_communicator([col, col + 2])

    src = accl.create_buffer(COUNT, np.float32)
    row_out = accl.create_buffer(COUNT * 2, np.float32)
    col_out = accl.create_buffer(COUNT * 2, np.float32)

    if row == 0:
        first, fout = row_comm, row_out
        second, sout = col_comm, col_out
    else:  # bottom row: opposite axis first — the seeded divergence
        first, fout = col_comm, col_out
        second, sout = row_comm, row_out

    ra = accl.allgather(src, fout, COUNT, comm_id=first, run_async=True)
    rb = accl.allgather(src, sout, COUNT, comm_id=second, run_async=True)
    ra.wait()
    ra.check()
    rb.wait()
    rb.check()
