"""The model family on PyTorch: the transformer LM's forward and its
serving path (KV-cache prefill, decode, generation), tensor-parallel over
rank lists.  Port of ``accl_tpu/models`` (training, MoE and their decode
paths come in later slices)."""

from .decode import decode_step, generate, init_kv_cache, prefill  # noqa: F401
from .transformer import (  # noqa: F401
    ModelConfig,
    forward,
    init_params,
    param_specs,
    shard_params,
)
