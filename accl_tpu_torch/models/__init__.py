"""The model family on PyTorch: the transformer LM's forward, loss and
train step (tensor-, data- and sequence-parallel over rank lists), its
serving path (KV-cache prefill, decode, generation), and the
Mixture-of-Experts family (``moe``: forward, loss and the expert-parallel
train step; ``moe_decode``: its serving path).  ``place_params`` puts a
model on the cards of a mesh over several cards.  Port of
``accl_tpu/models``."""

from . import moe, moe_decode  # noqa: F401
from .decode import (  # noqa: F401
    DecodeGraph,
    decode_step,
    generate,
    init_kv_cache,
    prefill,
)
from .transformer import (  # noqa: F401
    ModelConfig,
    PlacedParams,
    Replicas,
    SpReplicas,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    nest_as,
    param_specs,
    place_params,
    placed_trees,
    shard_params,
)
