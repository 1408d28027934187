"""accl_tpu_torch: the ACCL driver on PyTorch and CUDA.

A port of ``accl_tpu`` (the JAX/TPU package, which stays the reference)
to one NVIDIA H100: the same per-rank driver API (``ACCL``, buffers,
communicators, async requests, wire compression), a world-level gang
engine whose ranks are regions of one card's memory, hand-written CUDA
ring reduce-scatter / all-gather kernels for the large-message lane, the
int8 block-scaled and fused wire lanes, and the fused tensor-parallel
matmul with its hand-written CUDA matmul and matmul-reduce-scatter
kernels (``accl_tpu_torch.ops.fused``), and the model layer's serving
path (``accl_tpu_torch.models``: a tensor-parallel transformer forward,
prefill, decode and generation) with hand-written CUDA flash-attention
forward kernels (``accl_tpu_torch.ops.flash``).  It imports torch, numpy
and the standard library only.

    world = CudaWorld(8)            # on the card; CudaWorld(8, "cpu") for CPU
    world.run(fn)                   # fn(accl, rank) on one thread per rank
"""

from .accl import ACCL, GLOBAL_COMM  # noqa: F401
from .arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig  # noqa: F401
from .backends.cuda import CudaWorld  # noqa: F401
from .buffer import BaseBuffer, DummyBuffer  # noqa: F401
from .communicator import Communicator, Rank  # noqa: F401
from .constants import (  # noqa: F401
    TAG_ANY,
    ACCLError,
    CCLOCall,
    CfgFunc,
    CompressionFlags,
    DataType,
    ErrorCode,
    HostFlags,
    Operation,
    ReduceFunction,
    StreamFlags,
    TuningKey,
)
from .request import Request  # noqa: F401
from .state import (  # noqa: F401
    load_world_state,
    model_params_from_jax,
    model_params_to_numpy,
    tp_weight_shards,
)
