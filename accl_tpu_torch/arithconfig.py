"""Arithmetic/compression routing configuration.

One ArithConfig per (uncompressed, compressed) dtype pair selects the
reduction lane and whether wire payloads travel compressed (reference
driver/xrt/include/accl/arithconfig.hpp:32-119).  ``ACCL.initialize``
uploads :data:`DEFAULT_ARITH_CONFIG`; the engine recovers each call's
wire dtype from the descriptor's config id through
:data:`COMPRESSOR_WIRE_DTYPE`.  The port's own copy of
``accl_tpu/arithconfig.py``, with the int8 block-scaled pair
(:func:`int8_block_config`, registered at ``ACCL.initialize``) and the
automatic compression policy (:class:`CompressionPolicy`, armed from
``ACCL_COMPRESS``).

Host buffers are numpy arrays, and numpy has no bfloat16, so
:data:`NUMPY_TO_DATATYPE` has no bfloat16 entry.  The bfloat16 *wire*
lane over float32 buffers needs none: its cast runs in torch.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .constants import DATA_TYPE_SIZE, ACCLError, DataType, Operation, env_int


@dataclass(frozen=True)
class ArithConfig:
    """Datapath routing metadata for one dtype pair (reference
    arithconfig.hpp:32-100)."""

    uncompressed_elem_bits: int
    compressed_elem_bits: int
    elem_ratio_log: int
    compressor_tdest: int
    decompressor_tdest: int
    arith_is_compressed: bool
    arith_tdest: tuple[int, ...]  # per ReduceFunction (SUM, MAX)
    block: int = 0
    error_feedback: bool = False

    @property
    def compression_ratio(self) -> int:
        return 1 << self.elem_ratio_log


#: reduction lane ids, one per (dtype, function)
ARITH_LANE = {
    (DataType.float32, "sum"): 0,
    (DataType.float32, "max"): 1,
    (DataType.float64, "sum"): 2,
    (DataType.float64, "max"): 3,
    (DataType.int32, "sum"): 4,
    (DataType.int32, "max"): 5,
    (DataType.int64, "sum"): 6,
    (DataType.int64, "max"): 7,
    (DataType.float16, "sum"): 8,
    (DataType.float16, "max"): 9,
    (DataType.bfloat16, "sum"): 10,
    (DataType.bfloat16, "max"): 11,
}

COMPRESS_F32_F16 = 0
DECOMPRESS_F16_F32 = 1
COMPRESS_F32_BF16 = 2
DECOMPRESS_BF16_F32 = 3
COMPRESS_F32_I8 = 4
DECOMPRESS_I8_F32 = 5

#: default elements per fp32 scale on the int8 wire (ops/quantized.py
#: DEFAULT_BLOCK twin; overridable via ACCL_COMPRESS_BLOCK)
DEFAULT_COMPRESS_BLOCK = 256

_COMPRESSOR_LANES = {
    (DataType.float32, DataType.float16): (COMPRESS_F32_F16,
                                           DECOMPRESS_F16_F32),
    (DataType.float32, DataType.bfloat16): (COMPRESS_F32_BF16,
                                            DECOMPRESS_BF16_F32),
    (DataType.float32, DataType.int8): (COMPRESS_F32_I8, DECOMPRESS_I8_F32),
}

#: compressor lane id -> name of the wire representation: a dtype for the
#: cast lanes; "int8" is the block-scaled lane, whose wire form is (int8,
#: per-block fp32 scales) and which the engine routes to ops/quantized.py
COMPRESSOR_WIRE_DTYPE = {
    COMPRESS_F32_F16: "float16",
    COMPRESS_F32_BF16: "bfloat16",
    COMPRESS_F32_I8: "int8",
}


def _cfg(u: DataType, c: DataType, arith_compressed: bool = False) -> ArithConfig:
    ubits = DATA_TYPE_SIZE[u]
    cbits = DATA_TYPE_SIZE[c]
    ratio_log = max(0, (ubits // max(cbits, 1)).bit_length() - 1)
    arith_dtype = c if arith_compressed else u
    comp, decomp = _COMPRESSOR_LANES.get((u, c), (0, 0))
    return ArithConfig(
        uncompressed_elem_bits=ubits,
        compressed_elem_bits=cbits,
        elem_ratio_log=ratio_log,
        compressor_tdest=comp,
        decompressor_tdest=decomp,
        arith_is_compressed=arith_compressed,
        arith_tdest=(ARITH_LANE[(arith_dtype, "sum")],
                     ARITH_LANE[(arith_dtype, "max")]),
    )


#: default configs, in the order ACCL.initialize uploads them (the same
#: order as the reference's DEFAULT_ARITH_CONFIG, arithconfig.hpp:106-119)
DEFAULT_ARITH_CONFIG: dict[tuple[DataType, DataType], ArithConfig] = {
    (DataType.float16, DataType.float16): _cfg(DataType.float16, DataType.float16),
    (DataType.bfloat16, DataType.bfloat16): _cfg(DataType.bfloat16,
                                                 DataType.bfloat16),
    (DataType.float32, DataType.float32): _cfg(DataType.float32, DataType.float32),
    (DataType.float64, DataType.float64): _cfg(DataType.float64, DataType.float64),
    (DataType.int32, DataType.int32): _cfg(DataType.int32, DataType.int32),
    (DataType.int64, DataType.int64): _cfg(DataType.int64, DataType.int64),
    (DataType.float32, DataType.float16): _cfg(
        DataType.float32, DataType.float16, arith_compressed=True),
    (DataType.float32, DataType.bfloat16): _cfg(
        DataType.float32, DataType.bfloat16, arith_compressed=True),
}

def int8_block_config(block: int = DEFAULT_COMPRESS_BLOCK,
                      error_feedback: bool = False) -> ArithConfig:
    """The (float32, int8) block-scaled wire pair: 4:1 wire width, one
    fp32 scale per ``block`` elements, fp32 accumulate.  Registered at
    ``ACCL.initialize`` (not in DEFAULT_ARITH_CONFIG) so the block can
    follow ``ACCL_COMPRESS_BLOCK``; ``error_feedback`` makes the twin
    whose lane carries each hop's requantization error forward."""
    if block <= 0 or block > 65536:
        raise ACCLError(f"int8 wire lane: block {block} out of range "
                        f"(1..65536)")
    return ArithConfig(
        uncompressed_elem_bits=DATA_TYPE_SIZE[DataType.float32],
        compressed_elem_bits=DATA_TYPE_SIZE[DataType.int8],
        elem_ratio_log=2,
        compressor_tdest=COMPRESS_F32_I8,
        decompressor_tdest=DECOMPRESS_I8_F32,
        arith_is_compressed=False,
        arith_tdest=(ARITH_LANE[(DataType.float32, "sum")],
                     ARITH_LANE[(DataType.float32, "max")]),
        block=int(block),
        error_feedback=error_feedback,
    )


# ---------------------------------------------------------------------------
# wire-compression policy: automatic compress_dtype selection by
# collective, operand dtype and payload size, per communicator.  Disarmed
# (None on the driver) dispatch is exactly the static one.
# ---------------------------------------------------------------------------

#: collectives the policy compresses by default; p2p and alltoall stay
#: per-call opt-in
COMPRESSIBLE_OPS = frozenset(int(op) for op in (
    Operation.allreduce, Operation.reduce_scatter, Operation.allgather,
    Operation.reduce, Operation.bcast))


@dataclass
class CompressionPolicy:
    """Arms automatic ``compress_dtype`` selection on a driver: a call is
    compressed with ``dtype`` when its operands are float32, its scenario
    is in ``collectives`` and its payload is at least ``min_bytes``.
    ``per_comm`` overrides the decision per communicator id (a nested
    policy, or None to exempt that comm); ``error_feedback`` selects the
    int8 lane's error-feedback twin.

    Env arming (read at ``ACCL.initialize``): ``ACCL_COMPRESS`` (int8 |
    float16 | bfloat16 | 0/unset), ``ACCL_COMPRESS_MIN_BYTES`` (default
    65536), ``ACCL_COMPRESS_BLOCK`` (default 256), ``ACCL_COMPRESS_EF``
    (1 = error feedback)."""

    dtype: DataType = DataType.int8
    min_bytes: int = 64 * 1024
    block: int = DEFAULT_COMPRESS_BLOCK
    error_feedback: bool = False
    collectives: frozenset = COMPRESSIBLE_OPS
    per_comm: dict = field(default_factory=dict)

    def for_comm(self, comm_id: int) -> Optional["CompressionPolicy"]:
        if comm_id in self.per_comm:
            return self.per_comm[comm_id]
        return self

    def select(self, scenario: int, count: int, comm_id: int,
               elem_dtype: DataType) -> Optional[DataType]:
        """The wire dtype to compress this call with, or None.  Pure in
        its arguments and the policy's fields, so the driver's
        descriptor memo stays sound."""
        pol = self.for_comm(comm_id)
        if pol is None or int(scenario) not in pol.collectives:
            return None
        if elem_dtype != DataType.float32:
            return None
        if count * (DATA_TYPE_SIZE[DataType.float32] // 8) < pol.min_bytes:
            return None
        return pol.dtype

    def wants_error_feedback(self, comm_id: int) -> bool:
        pol = self.for_comm(comm_id)
        return bool(pol is not None and pol.error_feedback
                    and pol.dtype == DataType.int8)


def compress_block_from_env() -> int:
    return env_int("ACCL_COMPRESS_BLOCK", DEFAULT_COMPRESS_BLOCK, minimum=1)


#: ACCL_COMPRESS values that mean "explicitly off"
COMPRESS_OFF_TOKENS = frozenset(("0", "off", "none"))


def compression_policy_from_env() -> Optional[CompressionPolicy]:
    """``ACCL_COMPRESS`` names the wire dtype (0/empty = off); a
    malformed value raises an ACCLError naming it."""
    raw = os.environ.get("ACCL_COMPRESS", "").strip().lower()
    if raw == "" or raw in COMPRESS_OFF_TOKENS:
        return None
    names = {"int8": DataType.int8, "float16": DataType.float16,
             "fp16": DataType.float16, "bfloat16": DataType.bfloat16,
             "bf16": DataType.bfloat16}
    if raw not in names:
        raise ACCLError(f"ACCL_COMPRESS={raw!r} is not a wire dtype — want "
                        f"one of int8, float16, bfloat16 (or 0/unset for "
                        f"the lossless lanes)")
    return CompressionPolicy(
        dtype=names[raw],
        min_bytes=env_int("ACCL_COMPRESS_MIN_BYTES", 64 * 1024, minimum=0),
        block=compress_block_from_env(),
        error_feedback=os.environ.get("ACCL_COMPRESS_EF", "0") == "1",
    )


#: numpy dtype <-> DataType mapping used by the buffer layer
NUMPY_TO_DATATYPE = {
    np.dtype(np.float16): DataType.float16,
    np.dtype(np.float32): DataType.float32,
    np.dtype(np.float64): DataType.float64,
    np.dtype(np.int32): DataType.int32,
    np.dtype(np.int64): DataType.int64,
    np.dtype(np.int8): DataType.int8,
}

DATATYPE_TO_NUMPY = {v: k for k, v in NUMPY_TO_DATATYPE.items()}
