"""Elastic membership: live rank join and communicator grow (the port's
own copy of ``accl_tpu/resilience/elastic.py``).

- :func:`grow` (``ACCL.grow_communicator``), the survivors' collective
  that mirrors shrink: the live members of a communicator plus the new
  ranks' rows become a fresh communicator.  The dead world stays fenced
  behind its bumped epoch; traffic on other comms is not drained.
- :func:`join_grown_world`, the joiner's side: sync the engine's state
  from a live sponsor (``device.join_sync``: the native engine's
  Join/Welcome/StateSync exchange; a no-op on ``CudaWorld``, whose ranks
  share one engine), pad the driver's comm-id space with placeholders,
  then adopt the grown communicator.
- :class:`MembershipBoard`, the in-process rendezvous where joiners
  announce themselves.  Agreement on who joins travels the data plane:
  the lowest survivor claims a batch and broadcasts the admitted
  sessions (:func:`admit_pending`).

Id alignment: communicator ids are per-rank upload indices that agree
across the group.  A joiner starts with one communicator, so it pads its
driver and engine tables to the sponsor's count before the grown comm
is uploaded anywhere, and the sponsor defers its own grow upload until
the joiner confirms the sync.  Placeholder slots are dead: the driver
refuses calls on them.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from ..communicator import Communicator, Rank
from ..constants import ACCLError
from ..observability import metrics as _metrics
from ..utils.logging import get_logger
from .membership import probe_alive

#: joiners admitted per round at most (the bcast payload is fixed)
MAX_JOINS_PER_ROUND = 16

#: the engine's wait for the sponsor's Join/Welcome/StateSync answer
JOIN_SYNC_TIMEOUT_S = 10.0


class JoinOffer:
    """One joiner's announcement on the membership board."""

    def __init__(self, session: int, rank_row: Rank):
        self.session = int(session)
        self.rank_row = rank_row
        self.announced_ns = time.monotonic_ns()
        self.claimed = False
        #: leader -> joiner: the sync instructions are written
        self.fulfilled = threading.Event()
        #: joiner -> leader: engine synced, comm ids aligned
        self.synced = threading.Event()
        # written by the claiming leader (valid once fulfilled)
        self.sponsor_session: Optional[int] = None
        self.rows: Optional[List[Rank]] = None  # the grown comm's rows
        self.grow_id: Optional[int] = None      # the grown comm's id
        self.pad_count: Optional[int] = None    # comm slots before grow
        self.local_rank: Optional[int] = None   # the joiner's row index

    def __repr__(self) -> str:
        return f"JoinOffer(session={self.session}, claimed={self.claimed})"


class MembershipBoard:
    """In-process join rendezvous: joiners announce, the recovery leader
    claims (:meth:`claim_pending` runs on one rank a round)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._offers: List[JoinOffer] = []

    def announce(self, session: int, rank_row: Rank) -> JoinOffer:
        offer = JoinOffer(session, rank_row)
        with self._lock:
            self._offers.append(offer)
        return offer

    def pending_count(self) -> int:
        with self._lock:
            return sum(1 for o in self._offers if not o.claimed)

    def claim_pending(self, max_n: int = MAX_JOINS_PER_ROUND
                      ) -> List[JoinOffer]:
        """Claim up to ``max_n`` unclaimed offers in session order."""
        with self._lock:
            avail = sorted((o for o in self._offers if not o.claimed),
                           key=lambda o: o.session)[:max_n]
            for o in avail:
                o.claimed = True
        return avail

    def offer_for(self, session: int) -> Optional[JoinOffer]:
        with self._lock:
            return next((o for o in self._offers if o.session == session),
                        None)


# ---------------------------------------------------------------------------
# survivor side
# ---------------------------------------------------------------------------
def grow(accl, new_ranks: Sequence[Rank], comm_id: int = 0,
         window_s: float = 1.0) -> int:
    """Mint the communicator of the live members of ``comm_id`` plus
    ``new_ranks``; returns its id.  Collective over the survivors, with
    the same rows in the same create order; each joiner adopts the same
    table through :func:`join_grown_world`."""
    comm = accl.communicator(comm_id)
    new_rows = list(new_ranks)
    if not new_rows:
        raise ACCLError(
            f"grow_communicator(comm {comm_id}): no new ranks given — "
            f"use shrink_communicator/create_communicator for "
            f"same-membership rebuilds")
    alive = probe_alive(accl, comm_id, window_s)
    rows = [comm.ranks[i] for i, ok in enumerate(alive) if ok] + new_rows
    sessions = [r.session for r in rows]
    if len(set(sessions)) != len(sessions):
        raise ACCLError(
            f"grow_communicator(comm {comm_id}): duplicate sessions in "
            f"the grown membership {sessions} — a replacement must join "
            f"with a FRESH session, not a dead rank's")
    local = [i for i, ok in enumerate(alive) if ok].index(comm.local_rank)
    new_id = accl._install_communicator(
        Communicator(rows, local, comm_id=len(accl._communicators)))
    if _metrics.enabled():
        _metrics.default_registry().inc("membership/grows")
    return new_id


def admit_pending(accl, comm_id: int, board: MembershipBoard,
                  wait_s: float = 5.0, window_s: float = 1.0,
                  registry=None) -> tuple:
    """Admit the pending joiners into a grown communicator: collective
    over the members of ``comm_id``.  Returns ``(new_comm_id,
    n_admitted)``; with no joiner inside ``wait_s`` the comm comes back
    unchanged.

    1. The lowest member (the leader) waits up to ``wait_s`` for an
       announcement, claims a batch and writes each offer's sync
       instructions;
    2. it broadcasts the admitted sessions over ``comm_id``: the
       agreement point;
    3. it waits for each joiner's state sync (the joiner pads before any
       member's grow upload bumps the sponsor's count);
    4. everyone mints the grown communicator (:func:`grow`)."""
    comm = accl.communicator(comm_id)
    leader = comm.local_rank == 0
    reg = registry if registry is not None else _metrics.default_registry()
    t0 = time.monotonic()
    claimed: List[JoinOffer] = []
    if leader:
        deadline = t0 + wait_s
        while time.monotonic() < deadline and board.pending_count() == 0:
            time.sleep(0.01)
        claimed = board.claim_pending()
        if _metrics.enabled():
            reg.observe_value("join_wait_us", (time.monotonic() - t0) * 1e6)
        pad_count = len(accl._communicators)
        rows = list(comm.ranks) + [o.rank_row for o in claimed]
        for i, offer in enumerate(claimed):
            offer.sponsor_session = comm.ranks[comm.local_rank].session
            offer.rows = rows
            offer.pad_count = pad_count
            offer.grow_id = pad_count
            offer.local_rank = comm.size + i
            offer.fulfilled.set()
    msg = accl.create_buffer(1 + MAX_JOINS_PER_ROUND, np.int32)
    if leader:
        msg.host[:] = 0
        msg.host[0] = len(claimed)
        for i, o in enumerate(claimed):
            msg.host[1 + i] = o.session
    accl.bcast(msg, 1 + MAX_JOINS_PER_ROUND, root=0, comm_id=comm_id)
    n = int(msg.host[0])
    if n == 0:
        return comm_id, 0
    sessions = [int(s) for s in msg.host[1:1 + n]]
    if leader:
        # a joiner that dies mid-sync must not make the leader diverge
        # from the others, who are past the bcast: grow with it in the
        # table (the next episode shrinks it away)
        for o in claimed:
            if not o.synced.wait(timeout=JOIN_SYNC_TIMEOUT_S):
                get_logger("accl_tpu_torch.elastic").warning(
                    "admit_pending(comm %d): joiner session %d never "
                    "completed its state sync inside %.0fs — growing "
                    "anyway (the agreement bcast already committed "
                    "every survivor to this membership)",
                    comm_id, o.session, JOIN_SYNC_TIMEOUT_S)
        new_rows = [o.rank_row for o in claimed]
    else:
        offers = [board.offer_for(s) for s in sessions]
        missing = [s for s, o in zip(sessions, offers) if o is None]
        if missing:
            raise ACCLError(
                f"admit_pending(comm {comm_id}): leader admitted "
                f"sessions {missing} unknown to this rank's board — "
                f"the membership boards have diverged")
        new_rows = [o.rank_row for o in offers]
    new_id = grow(accl, new_rows, comm_id=comm_id, window_s=window_s)
    return new_id, n


# ---------------------------------------------------------------------------
# joiner side
# ---------------------------------------------------------------------------
def join_grown_world(accl, offer: JoinOffer, timeout_s: float = 30.0) -> int:
    """Complete a join on the replacement rank: wait for the leader's
    instructions, sync the engine from the sponsor, pad the driver's
    comm ids, adopt the grown communicator.  Returns its id."""
    if not offer.fulfilled.wait(timeout=timeout_s):
        raise ACCLError(
            f"join(session {offer.session}): no survivor claimed this "
            f"offer inside {timeout_s:.0f}s — is a grow-policy "
            f"supervisor (or admit_pending) running on the survivors?")
    join_sync = getattr(accl.device, "join_sync", None)
    if join_sync is not None:
        if join_sync(offer.sponsor_session,
                     timeout_s=JOIN_SYNC_TIMEOUT_S) != 0:
            raise ACCLError(
                f"join(session {offer.session}): state sync against "
                f"sponsor session {offer.sponsor_session} timed out "
                f"(sponsor dead?)")
        count = getattr(accl.device, "comm_count", lambda: None)()
        if count is not None and count != offer.pad_count:
            raise ACCLError(
                f"join(session {offer.session}): engine synced "
                f"{count} comm slots but the leader promised "
                f"{offer.pad_count} — the sponsor grew mid-sync; "
                f"re-announce and retry")
    accl._pad_communicators(offer.pad_count)
    offer.synced.set()
    local = next(i for i, r in enumerate(offer.rows)
                 if r.session == offer.session)
    new_id = accl._install_communicator(
        Communicator(list(offer.rows), local, comm_id=offer.grow_id))
    if _metrics.enabled():
        _metrics.default_registry().inc("membership/joins")
    return new_id
