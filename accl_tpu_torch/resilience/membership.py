"""Membership recovery: liveness probing and ULFM-style shrink (the
port's own copy of ``accl_tpu/resilience/membership.py``).

After a rank dies the survivors agree on who is alive (the backend's
heartbeat probe, :func:`probe_alive`) and build a fresh communicator
without the dead (:func:`shrink`), so the collective re-runs on the
smaller world.  A backend without a liveness plane (``CudaWorld``,
whose ranks share one engine) reports every rank alive: shrink then
mints a copy of the communicator, never a wrong exclusion.
"""
from __future__ import annotations

from typing import List, Optional

from ..constants import ACCLError, ErrorCode


def probe_alive(accl, comm_id: int = 0, window_s: float = 1.0) -> List[bool]:
    """Per-comm-local-rank liveness; the local rank is always alive.

    A non-positive window and a backend list longer than the
    communicator both raise an ACCLError naming the comm (a longer list
    answered for another world); a short list pads with dead (the
    backend proved nothing about the rest)."""
    comm = accl.communicator(comm_id)
    if not window_s > 0:
        raise ACCLError(
            f"probe_alive(comm {comm_id}): window_s={window_s!r} must be "
            f"> 0 (a zero/negative window can never collect a pong)")
    probe = getattr(accl.device, "probe_liveness", None)
    alive: Optional[List[bool]] = None
    if probe is not None:
        alive = probe(comm_id, comm.size, window_s)
    alive = [True] * comm.size if alive is None else list(alive)
    if len(alive) > comm.size:
        raise ACCLError(
            f"probe_alive(comm {comm_id}): backend returned liveness for "
            f"{len(alive)} ranks but the communicator has {comm.size} — "
            f"the probe answered for a different world; refusing to "
            f"truncate (a shrink built from it could exclude the wrong "
            f"ranks)")
    alive += [False] * (comm.size - len(alive))
    alive[comm.local_rank] = True
    return alive


def shrink(accl, comm_id: int = 0, window_s: float = 1.0) -> int:
    """Build a communicator over the survivors of ``comm_id`` and return
    its id.  Collective over the survivors, in create order; a shrink
    with no death still mints a fresh comm, so every member's ids
    advance alike."""
    comm = accl.communicator(comm_id)
    alive = probe_alive(accl, comm_id, window_s)
    # the session field is the world index on every backend, the
    # convention create_communicator and the engines' tables share
    survivors = [comm.ranks[i].session for i, ok in enumerate(alive) if ok]
    if not survivors:
        raise ACCLError(f"shrink(comm {comm_id}): no survivors",
                        int(ErrorCode.RANK_FAILED))
    return accl.create_communicator(survivors)
