"""Wire-frame codec: the Python twin of ``native/src/common.hpp``.

Port of ``accl_tpu/utils/wire.py``: the same struct layout, because
both packages load the same ``native/libacclemu.so``.  One place knows
the 64-byte ``WireHeader`` layout outside the native library: tests
build and dissect frames through this module (and feed them to
``EmuDevice.ingest_bytes``), so a header-layout change breaks loudly in
one import instead of silently corrupting test vectors.

Layout (little-endian, 64 bytes total, ``static_assert``-pinned on the
C++ side)::

    count:u32 tag:u32 src:u32 seqn:u32 strm:u32 dst_session:u16
    msg_type:u8 host:u8 vaddr:u64 comm_id:u32 compressed:u32 epoch:u32
    pad[20]
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

HEADER_FMT = "<IIIIIHBBQIII20x"
HEADER_SIZE = struct.calcsize(HEADER_FMT)
assert HEADER_SIZE == 64, "wire header must be 64 bytes"

#: MsgType values (common.hpp enum MsgType) — every known frame kind
MSG_TYPES = {
    "egr": 0,
    "rndzvs_msg": 1,
    "rndzvs_init": 2,
    "rndzvs_wrdone": 3,
    "nack": 4,
    "heartbeat": 5,
    "abort": 6,
    "join": 7,
    "welcome": 8,
    "state_sync": 9,
}
MSG_TYPE_NAMES = {v: k for k, v in MSG_TYPES.items()}


@dataclass
class WireFrame:
    """One framed wire message: header fields + payload bytes."""

    count: int = 0
    tag: int = 0
    src: int = 0
    seqn: int = 0
    strm: int = 0
    dst_session: int = 0
    msg_type: int = 0
    host: int = 0
    vaddr: int = 0
    comm_id: int = 0
    compressed: int = 0
    epoch: int = 0
    payload: bytes = field(default=b"")

    def pack(self) -> bytes:
        hdr = struct.pack(
            HEADER_FMT, self.count & 0xFFFFFFFF, self.tag & 0xFFFFFFFF,
            self.src & 0xFFFFFFFF, self.seqn & 0xFFFFFFFF,
            self.strm & 0xFFFFFFFF, self.dst_session & 0xFFFF,
            self.msg_type & 0xFF, self.host & 0xFF,
            self.vaddr & 0xFFFFFFFFFFFFFFFF, self.comm_id & 0xFFFFFFFF,
            self.compressed & 0xFFFFFFFF, self.epoch & 0xFFFFFFFF)
        return hdr + self.payload

    @classmethod
    def unpack(cls, data: bytes) -> "WireFrame":
        if len(data) < HEADER_SIZE:
            raise ValueError(
                f"frame shorter than a wire header: {len(data)} bytes")
        (count, tag, src, seqn, strm, dst_session, msg_type, host, vaddr,
         comm_id, compressed, epoch) = struct.unpack(
             HEADER_FMT, data[:HEADER_SIZE])
        return cls(count=count, tag=tag, src=src, seqn=seqn, strm=strm,
                   dst_session=dst_session, msg_type=msg_type, host=host,
                   vaddr=vaddr, comm_id=comm_id, compressed=compressed,
                   epoch=epoch, payload=bytes(data[HEADER_SIZE:]))

    @property
    def type_name(self) -> str:
        return MSG_TYPE_NAMES.get(self.msg_type,
                                  f"unknown({self.msg_type})")

    def __repr__(self) -> str:  # pragma: no cover — debug aid
        return (f"WireFrame({self.type_name} src={self.src} "
                f"comm={self.comm_id} tag={self.tag} seqn={self.seqn} "
                f"count={self.count} payload={len(self.payload)}B)")
