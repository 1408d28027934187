"""Seeded leaked async request, run for real on a CPU ``CudaWorld`` as
``__main__``: every rank issues an async allreduce and never waits on
it.  accl_lint's shadow mode must warn (``leaked-request``) and exit 0,
or exit 1 under ``--strict``."""
import numpy as np

from accl_tpu_torch import CudaWorld, ReduceFunction

COUNT = 32


def accl_main(accl, rank):
    s = accl.create_buffer(COUNT, np.float32)
    d = accl.create_buffer(COUNT, np.float32)
    accl.allreduce(s, d, COUNT, ReduceFunction.SUM, run_async=True)


if __name__ == "__main__":
    with CudaWorld(2, device="cpu") as world:
        world.run(accl_main)
