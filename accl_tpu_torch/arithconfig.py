"""Arithmetic/compression routing configuration.

One ArithConfig per (uncompressed, compressed) dtype pair selects the
reduction lane and whether wire payloads travel compressed (reference
driver/xrt/include/accl/arithconfig.hpp:32-119).  ``ACCL.initialize``
uploads :data:`DEFAULT_ARITH_CONFIG`; the engine recovers each call's
wire dtype from the descriptor's config id through
:data:`COMPRESSOR_WIRE_DTYPE`.  The port's own copy of
``accl_tpu/arithconfig.py``: the int8 block-scaled lane and the
automatic compression policy are not part of it.

Host buffers are numpy arrays, and numpy has no bfloat16, so
:data:`NUMPY_TO_DATATYPE` has no bfloat16 entry.  The bfloat16 *wire*
lane over float32 buffers needs none: its cast runs in torch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import DATA_TYPE_SIZE, DataType


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

_COMPRESSOR_LANES = {
    (DataType.float32, DataType.float16): (COMPRESS_F32_F16,
                                           DECOMPRESS_F16_F32),
    (DataType.float32, DataType.bfloat16): (COMPRESS_F32_BF16,
                                            DECOMPRESS_BF16_F32),
}

#: compressor lane id -> name of the wire dtype (the engine's cast lanes)
COMPRESSOR_WIRE_DTYPE = {
    COMPRESS_F32_F16: "float16",
    COMPRESS_F32_BF16: "bfloat16",
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
