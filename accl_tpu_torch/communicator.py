"""Communicator: the rank table and sub-group machinery (reference
driver/xrt/include/accl/communicator.hpp:34-95).  The port's own copy
of ``accl_tpu/communicator.py``; ranks map to per-rank regions of the
card's memory instead of ip:port endpoints."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .constants import DEFAULT_MAX_EAGER_SIZE


@dataclass
class Rank:
    """One row of the communicator table (reference communicator.hpp:34-39)."""

    ip: str = "127.0.0.1"
    port: int = 0
    session: int = 0
    max_segment_size: int = DEFAULT_MAX_EAGER_SIZE
    device_index: Optional[int] = None


class Communicator:
    """A group of ranks with a local rank; its id goes into word 2 of
    every call descriptor."""

    #: True only for the slots a non-member pads its id space with, so
    #: that every rank's next communicator lands at the same id
    is_placeholder = False

    #: tenant label for per-tenant observability (accl_tpu/communicator.py:
    #: 50-55): a class attribute, so an unlabelled communicator answers
    #: None at no per-instance cost; set by ACCL.create_communicator
    #: (tenant=...) or ACCL.set_tenant.  The engine never sees it, only
    #: the flight records, the metrics and the trace do.
    tenant = None

    def __init__(self, ranks: Sequence[Rank], local_rank: int, comm_id: int = 0):
        if not 0 <= local_rank < len(ranks):
            raise ValueError(f"local_rank {local_rank} out of range for "
                             f"{len(ranks)} ranks")
        self._ranks = list(ranks)
        self._local_rank = local_rank
        self._id = comm_id

    @classmethod
    def placeholder(cls, comm_id: int) -> "Communicator":
        c = cls.__new__(cls)
        c._ranks = []
        c._local_rank = 0
        c._id = comm_id
        c.is_placeholder = True
        return c

    @property
    def id(self) -> int:
        return self._id

    @property
    def ranks(self) -> list[Rank]:
        return self._ranks

    @property
    def local_rank(self) -> int:
        return self._local_rank

    @property
    def size(self) -> int:
        return len(self._ranks)

    def to_words(self) -> list[int]:
        """The table as the native engine takes it: [size, local_rank,
        then per rank ip (u32), port, session, max_segment_size]
        (accl_tpu/communicator.py:95-106)."""
        words = [self.size, self.local_rank]
        for r in self._ranks:
            words += [_ip_encode(r.ip), r.port, r.session, r.max_segment_size]
        return words

    def split(self, indices: Sequence[int], comm_id: int) -> "Communicator":
        """Sub-communicator over a subset of ranks that holds the local
        rank (reference accl.cpp:971-978)."""
        if self._local_rank not in indices:
            raise ValueError("local rank must be part of the new communicator")
        new_ranks = [self._ranks[i] for i in indices]
        sub = Communicator(new_ranks, list(indices).index(self._local_rank),
                           comm_id)
        if self.tenant is not None:
            sub.tenant = self.tenant
        return sub

    def dump(self) -> str:
        ten = f" tenant={self.tenant}" if self.tenant is not None else ""
        lines = [f"communicator {self._id}: size={self.size} "
                 f"local_rank={self._local_rank}{ten}"]
        for i, r in enumerate(self._ranks):
            tag = " (local)" if i == self._local_rank else ""
            lines.append(f"  rank {i}: {r.ip}:{r.port} session={r.session} "
                         f"max_seg={r.max_segment_size}{tag}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        ten = f", tenant={self.tenant!r}" if self.tenant is not None else ""
        return (f"Communicator(id={self._id}, size={self.size}, "
                f"local_rank={self._local_rank}{ten})")


def _ip_encode(ip: str) -> int:
    """Dotted quad to u32 (reference common.cpp:75-90); 0 if malformed."""
    parts = ip.split(".")
    if len(parts) != 4:
        return 0
    val = 0
    for p in parts:
        val = (val << 8) | (int(p) & 0xFF)
    return val
