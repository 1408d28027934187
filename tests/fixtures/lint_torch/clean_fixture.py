"""A representative CLEAN collective program: every checker must come
back empty.  Exercises the full surface the linter reasons about —
gang collectives (uniform parameters), an async neighbor exchange
(properly waited, deadlock-free order), a sub-communicator, rooted
collectives with valid comm-local roots, disjoint buffers, and
buffer free only after the last use.
"""
import numpy as np

from accl_tpu_torch import ReduceFunction

LINT_RANKS = 4
COUNT = 1024


def accl_main(accl, rank):
    nranks = accl.size
    src = accl.create_buffer(COUNT, np.float32)
    dst = accl.create_buffer(COUNT, np.float32)
    gathered = accl.create_buffer(COUNT * nranks, np.float32)

    # gang collectives with uniform parameters
    accl.allreduce(src, dst, COUNT, ReduceFunction.SUM)
    accl.allgather(src, gathered, COUNT)
    accl.bcast(src, COUNT, root=0)
    accl.barrier()

    # async ring exchange: send posted async, recv blocks, then drain
    peer = (rank + 1) % nranks
    frm = (rank - 1) % nranks
    req = accl.send(src, COUNT, dst=peer, tag=7, run_async=True)
    accl.recv(dst, COUNT, src=frm, tag=7)
    req.wait()
    req.check()

    # sub-communicator of the even ranks, comm-local root
    members = list(range(0, nranks, 2))
    if rank in members:
        cid = accl.create_communicator(members)
        sub = accl.create_buffer(COUNT, np.float32)
        accl.reduce(src, sub, COUNT, root=0, comm_id=cid)
        sub.free()

    gathered.free()
