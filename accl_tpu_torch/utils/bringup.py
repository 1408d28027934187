"""One-call world bring-up + rank-table generation.

Port of ``accl_tpu/utils/bringup.py``, the equivalent of the reference
accl_network_utils: the `acclDesign` enum selecting the transport
design, `generate_ranks` building the rank table from a pattern or
file, and `initialize_world` performing the full bring-up in one call
(driver/utils/accl_network_utils.cpp:264-289, :292-362).  The designs:

- ``EMU_INPROC``: native engines in one process (AXIS3x loopback rung)
- ``EMU_TCP``:    one native engine per process over sockets (TCP rung)
- ``CUDA``:       the gang engine on one card, the ranks regions of its
  memory (the JAX package's ``TPU`` rung)

The JAX package's ``initialize_multihost`` (``jax.distributed`` over TPU
hosts) has no counterpart yet: it comes with multi-card worlds
(ROADMAP.md Queue 1 item 13).
"""
from __future__ import annotations

import enum
import json
from typing import Optional, Sequence

from ..communicator import Rank
from ..constants import DEFAULT_EAGER_RX_BUF_SIZE


class Design(enum.Enum):
    EMU_INPROC = "emu-inproc"
    EMU_TCP = "emu-tcp"
    CUDA = "cuda"


def generate_ranks(nranks: int, base_port: int = 5500,
                   ips: Optional[Sequence[str]] = None,
                   rank_file: Optional[str] = None,
                   max_segment_size: int = DEFAULT_EAGER_RX_BUF_SIZE) -> list[Rank]:
    """Build the rank table from a pattern or a JSON rank file
    (reference: generate_ranks file/pattern variants,
    accl_network_utils.cpp:235-289)."""
    if rank_file:
        with open(rank_file) as f:
            spec = json.load(f)
        return [
            Rank(ip=r.get("ip", "127.0.0.1"), port=r.get("port", base_port + i),
                 session=r.get("session", i),
                 max_segment_size=r.get("max_segment_size", max_segment_size))
            for i, r in enumerate(spec["ranks"])
        ]
    ips = list(ips) if ips else ["127.0.0.1"] * nranks
    return [
        Rank(ip=ips[i % len(ips)], port=base_port + i, session=i,
             max_segment_size=max_segment_size)
        for i in range(nranks)
    ]


def initialize_world(design: Design | str, nranks: int, rank: int = 0,
                     base_port: int = 5500, **kwargs):
    """One-call bring-up (reference: initialize_accl).

    EMU_INPROC / CUDA return a world object (all ranks, single process;
    ``CudaWorld`` on the card unless ``device="cpu"`` is passed);
    EMU_TCP returns this process's single-rank node."""
    design = Design(design) if not isinstance(design, Design) else design
    if design == Design.EMU_INPROC:
        from ..backends.emu import EmuWorld

        return EmuWorld(nranks, **kwargs)
    if design == Design.EMU_TCP:
        from ..backends.emu import EmuRankTcp

        return EmuRankTcp(rank, nranks, base_port, **kwargs)
    if design == Design.CUDA:
        from ..backends.cuda import CudaWorld

        return CudaWorld(nranks, **kwargs)
    raise ValueError(f"unknown design {design}")
