"""ABI constants of the ACCL driver, for the PyTorch/CUDA port.

Bit-compatible with the reference ACCL host/device ABI (call descriptor
words, error codes, flag algebra; reference
driver/xrt/include/accl/constants.hpp:179-405).  This is the port's own
copy of ``accl_tpu/constants.py``, trimmed to what the driver's
collective path uses.
"""
from __future__ import annotations

import enum
import os
from dataclasses import dataclass


class Operation(enum.IntEnum):
    """Collective scenario codes carried in word 0 of a call descriptor
    (reference constants.hpp:191-210)."""

    config = 0
    copy = 1
    combine = 2
    send = 3
    recv = 4
    bcast = 5
    scatter = 6
    gather = 7
    reduce = 8
    allgather = 9
    allreduce = 10
    reduce_scatter = 11
    barrier = 12
    alltoall = 13
    nop = 255


#: scenarios that form cross-rank gangs in the engine; p2p and local ops
#: are single-rank
GANG_OPERATIONS = frozenset((
    Operation.bcast, Operation.scatter, Operation.gather,
    Operation.allgather, Operation.reduce, Operation.allreduce,
    Operation.reduce_scatter, Operation.alltoall, Operation.barrier,
))


class CfgFunc(enum.IntEnum):
    """Sub-functions of Operation.config (reference constants.hpp:179-185)."""

    reset_periph = 0
    enable_pkt = 1
    set_timeout = 2
    set_max_eager_msg_size = 3
    set_max_rendezvous_msg_size = 4


class ReduceFunction(enum.IntEnum):
    """On-path reduction operator (reference constants.hpp:216-219)."""

    SUM = 0
    MAX = 1


class DataType(enum.IntEnum):
    """Wire/arithmetic datatypes (reference constants.hpp:254-262, plus
    bfloat16 as a wire type)."""

    none = 0
    int8 = 1
    float16 = 2
    float32 = 3
    float64 = 4
    int32 = 5
    int64 = 6
    bfloat16 = 7


#: width in bits of each DataType (reference constants.hpp:268-272)
DATA_TYPE_SIZE = {
    DataType.none: 0,
    DataType.int8: 8,
    DataType.float16: 16,
    DataType.float32: 32,
    DataType.float64: 64,
    DataType.int32: 32,
    DataType.int64: 64,
    DataType.bfloat16: 16,
}


class StreamFlags(enum.IntFlag):
    """Streamed-operand markers (reference constants.hpp:278-282)."""

    NO_STREAM = 0
    OP0_STREAM = 1
    RES_STREAM = 2


class HostFlags(enum.IntFlag):
    """Host-resident-buffer markers (reference constants.hpp:302-307)."""

    NO_HOST = 0
    OP0_HOST = 1
    OP1_HOST = 2
    RES_HOST = 4


class CompressionFlags(enum.IntFlag):
    """Per-operand / on-the-wire compression markers
    (reference constants.hpp:327-333)."""

    NO_COMPRESSION = 0
    OP0_COMPRESSED = 1
    OP1_COMPRESSED = 2
    RES_COMPRESSED = 4
    ETH_COMPRESSED = 8


class ErrorCode(enum.IntFlag):
    """Sticky engine error bits (reference constants.hpp:355-387)."""

    COLLECTIVE_OP_SUCCESS = 0
    DMA_MISMATCH_ERROR = 1 << 0
    DMA_INTERNAL_ERROR = 1 << 1
    DMA_DECODE_ERROR = 1 << 2
    DMA_SLAVE_ERROR = 1 << 3
    DMA_NOT_OKAY_ERROR = 1 << 4
    DMA_NOT_END_OF_PACKET_ERROR = 1 << 5
    DMA_NOT_EXPECTED_BTT_ERROR = 1 << 6
    DMA_TIMEOUT_ERROR = 1 << 7
    CONFIG_SWITCH_ERROR = 1 << 8
    DEQUEUE_BUFFER_TIMEOUT_ERROR = 1 << 9
    DEQUEUE_BUFFER_SPARE_BUFFER_STATUS_ERROR = 1 << 10
    RECEIVE_TIMEOUT_ERROR = 1 << 11
    DEQUEUE_BUFFER_SPARE_BUFFER_DMATAG_MISMATCH = 1 << 12
    DEQUEUE_BUFFER_SPARE_BUFFER_INDEX_ERROR = 1 << 13
    COLLECTIVE_NOT_IMPLEMENTED = 1 << 14
    RECEIVE_OFFCHIP_SPARE_BUFF_ID_NOT_VALID = 1 << 15
    EAGER_THRESHOLD_INVALID = 1 << 16
    RENDEZVOUS_THRESHOLD_INVALID = 1 << 17
    DMA_SIZE_ERROR = 1 << 18
    ARITH_ERROR = 1 << 19
    PACK_TIMEOUT_STS_ERROR = 1 << 20
    PACK_SEQ_NUMBER_ERROR = 1 << 21
    COMPRESSION_ERROR = 1 << 22
    KRNL_TIMEOUT_STS_ERROR = 1 << 23
    KRNL_STS_COUNT_ERROR = 1 << 24
    SEGMENTER_EXPECTED_BTT_ERROR = 1 << 25
    DMA_TAG_MISMATCH_ERROR = 1 << 26
    COMM_ABORTED = 1 << 27
    RANK_FAILED = 1 << 28


class TuningKey(enum.IntEnum):
    """Runtime tuning-register keys (reference flat-tree thresholds,
    ccl_offload_control.h:86-90, plus the ring crossover)."""

    BCAST_FLAT_TREE_MAX_RANKS = 0
    REDUCE_FLAT_TREE_MAX_RANKS = 1
    GATHER_FLAT_TREE_MAX_FANIN = 2
    EGRESS_PIPELINE_DEPTH = 3
    GATHER_FLAT_TREE_MAX_COUNT = 4
    REDUCE_FLAT_TREE_MAX_COUNT = 5
    #: byte threshold at or above which allreduce / allgather /
    #: reduce_scatter ride the ring kernels (env default
    #: ACCL_RING_THRESHOLD)
    RING_THRESHOLD_BYTES = 6


TUNING_KEY_NAMES = {int(k): k.name for k in TuningKey}


def unknown_tuning_key_error(key: int) -> "ACCLError":
    names = ", ".join(f"{k}={v}" for k, v in sorted(TUNING_KEY_NAMES.items()))
    return ACCLError(f"set_tuning: unknown tuning key {key!r} — known keys: "
                     f"{names}")


class OperationStatus(enum.IntEnum):
    """Lifecycle of an async request (reference constants.hpp:226-230)."""

    QUEUED = 0
    EXECUTING = 1
    COMPLETED = 2


#: any-source / any-tag wildcard and the default tag
TAG_ANY = 0xFFFFFFFF

DEFAULT_EAGER_RX_BUFS = 16
DEFAULT_EAGER_RX_BUF_SIZE = 1024
DEFAULT_MAX_EAGER_SIZE = 32 * 1024
DEFAULT_MAX_RENDEZVOUS_SIZE = 32 * 1024


@dataclass
class CCLOCall:
    """The 15-word call descriptor (reference hostctrl.cpp:19-63).
    ``fused`` is the driver-side fused-lane hint, outside the wire ABI."""

    scenario: Operation = Operation.nop
    count: int = 0
    comm: int = 0
    root_src_dst: int = 0
    function: int = 0
    tag: int = TAG_ANY
    arithcfg: int = 0
    compression_flags: CompressionFlags = CompressionFlags.NO_COMPRESSION
    stream_flags: StreamFlags = StreamFlags.NO_STREAM
    host_flags: HostFlags = HostFlags.NO_HOST
    addr_0: int = 0
    addr_1: int = 0
    addr_2: int = 0
    fused: bool = False

    def to_words(self) -> list[int]:
        return [
            int(self.scenario), int(self.count), int(self.comm),
            int(self.root_src_dst), int(self.function), int(self.tag),
            int(self.arithcfg), int(self.compression_flags),
            int(self.stream_flags) | (int(self.host_flags) << 8),
            self.addr_0 & 0xFFFFFFFF, (self.addr_0 >> 32) & 0xFFFFFFFF,
            self.addr_1 & 0xFFFFFFFF, (self.addr_1 >> 32) & 0xFFFFFFFF,
            self.addr_2 & 0xFFFFFFFF, (self.addr_2 >> 32) & 0xFFFFFFFF,
        ]


def error_code_to_str(code: int) -> str:
    """Readable decode of a sticky error bitfield (reference
    constants.hpp:393-405)."""
    if code == 0:
        return "COLLECTIVE_OP_SUCCESS"
    names = [e.name for e in ErrorCode if e.value and code & e.value]
    return " | ".join(names) if names else f"UNKNOWN_ERROR({code:#x})"


class ACCLError(RuntimeError):
    """A collective returned a non-zero retcode, or a call was refused
    (reference accl.cpp:1226-1250 check_return_value)."""

    def __init__(self, message: str, code: int = 0):
        super().__init__(message)
        self.code = code


def env_int(name: str, default: int, minimum: int | None = None) -> int:
    """Integer env knob; a malformed value raises an ACCLError naming it."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        val = int(float(raw))
    except ValueError as e:
        raise ACCLError(f"{name}={raw!r} is not a number") from e
    if minimum is not None and val < minimum:
        raise ACCLError(f"{name}={raw!r} must be >= {minimum}")
    return val
