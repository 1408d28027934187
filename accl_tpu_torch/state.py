"""Carry a world's state into a CudaWorld.

The system has no weights: its state is the per-rank buffers, the
communicator table and the ring threshold.  ``state`` is plain data:

    {"buffers": {rank: [np.ndarray, ...]},
     "comms": [[global ranks], ...],        # sub-communicators, in order
     "ring_threshold_bytes": int}

:func:`load_world_state` creates the same buffers with the same contents,
the same communicators (same ids on every rank) and the same threshold,
so the two worlds compute the same thing.
"""
from __future__ import annotations

import numpy as np

from .constants import TuningKey


def load_world_state(world, state: dict) -> dict:
    """Load ``state`` into ``world`` (a CudaWorld).  Returns
    ``{"buffers": {rank: [buffer, ...]}, "comms": [comm id, ...]}``."""
    buffers = {}
    for rank, arrays in state.get("buffers", {}).items():
        accl = world.accls[int(rank)]
        bufs = []
        for arr in arrays:
            buf = accl.create_buffer_like(np.asarray(arr))
            buf.sync_to_device()
            bufs.append(buf)
        buffers[int(rank)] = bufs
    comm_ids = []
    for members in state.get("comms", []):
        ids = set()
        for rank, accl in enumerate(world.accls):
            if rank in members:
                ids.add(accl.create_communicator(list(members)))
            else:
                ids.add(accl.reserve_communicator())
        (cid,) = ids  # every rank minted the same id
        comm_ids.append(cid)
    if "ring_threshold_bytes" in state:
        for accl in world.accls:
            accl.set_tuning(int(TuningKey.RING_THRESHOLD_BYTES),
                            int(state["ring_threshold_bytes"]))
    return {"buffers": buffers, "comms": comm_ids}
