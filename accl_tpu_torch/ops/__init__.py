"""Device kernels of the port and their plain PyTorch versions."""

from .compression import compress_cast, decompress_cast  # noqa: F401
from .flash import flash_attention  # noqa: F401
from .fused import fused_matmul_allreduce  # noqa: F401
from .quantized import (  # noqa: F401
    dequantize_blockwise,
    quantize_blockwise,
    quantized_all_reduce,
    quantized_ring_all_gather,
    quantized_ring_reduce_scatter,
)
from .reduce_ops import pallas_add, pallas_max, reduce_lane  # noqa: F401
from .ring import (  # noqa: F401
    ring_all_gather,
    ring_all_gather_segmented,
    ring_all_reduce,
    ring_all_reduce_segmented,
    ring_reduce_scatter,
    ring_reduce_scatter_segmented,
)
