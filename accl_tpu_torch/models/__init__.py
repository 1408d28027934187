"""The model family on PyTorch: the transformer LM's forward, loss and
train step, and its serving path (KV-cache prefill, decode, generation),
tensor-parallel over rank lists.  Port of ``accl_tpu/models`` (MoE and
its decode path come in a later slice)."""

from .decode import decode_step, generate, init_kv_cache, prefill  # noqa: F401
from .transformer import (  # noqa: F401
    ModelConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    param_specs,
    shard_params,
)
