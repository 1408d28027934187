"""accl_tpu_torch: the ACCL driver on PyTorch and CUDA.

A port of ``accl_tpu`` (the JAX/TPU package, which stays the reference)
to one NVIDIA H100: the same per-rank driver API (``ACCL``, buffers,
communicators, async requests, wire compression), a world-level gang
engine whose ranks are regions of one card's memory, hand-written CUDA
ring reduce-scatter / all-gather kernels for the large-message lane, the
int8 block-scaled and fused wire lanes, and the fused tensor-parallel
matmul with its hand-written CUDA matmul and matmul-reduce-scatter
kernels (``accl_tpu_torch.ops.fused``), and the model layer
(``accl_tpu_torch.models``: a tensor-parallel transformer's forward,
prefill, decode and generation, and its dp x tp train step) with
hand-written CUDA flash-attention forward and backward kernels
(``accl_tpu_torch.ops.flash``), over the parallelism strategies of
``accl_tpu_torch.parallel``; persistent collective plans
(``ACCL.capture_plan``, ``accl_tpu_torch.plans``), batched gang dispatch
and the collective sanitizer (``accl_tpu_torch.analysis``,
``ACCL_SANITIZE``); fault tolerance (``accl_tpu_torch.resilience``:
abort, shrink, grow, reset and the recovery supervisor, on ``CudaWorld``
and on the native emulator's ``EmuWorld``, ``backends/emu.py``, which
adds retransmission, seeded chaos and live joins); kernel streams and
the device-side caller API (``ACCLCommand``, ``ACCLData``,
``DeviceCollectives``); offline tuning (``accl_tpu_torch.tuning``: the
fabric model, the hierarchical composer, the autotuner and its selection
table, armed by ``ACCL_TUNE_TABLE``).  It imports torch,
numpy, ctypes and the standard library only.

    world = CudaWorld(8)            # on the card; CudaWorld(8, "cpu") for CPU
    world.run(fn)                   # fn(accl, rank) on one thread per rank
"""

from . import analysis, optim, plans  # noqa: F401
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
from .device_api import ACCLCommand, ACCLData, DeviceCollectives  # noqa: F401
from .request import Request  # noqa: F401
from .resilience import (  # noqa: F401
    ChaosPlan,
    MembershipBoard,
    RecoveryPolicy,
    RecoverySupervisor,
    RetryPolicy,
)
from .state import (  # noqa: F401
    adamw_state_from_optax,
    adamw_state_to_numpy,
    load_world_state,
    model_params_from_jax,
    model_params_to_numpy,
    moe_params_from_jax,
    moe_params_to_numpy,
    tp_weight_shards,
)
