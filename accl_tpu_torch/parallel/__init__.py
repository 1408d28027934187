"""The SPMD layer over rank lists: meshes of rank slots on one card or on
several (``make_mesh(devices=)``), the functional collectives (every
crossing between members on several cards counted by ``moves``), the
parallelism strategies, and the sequence-parallel attention schedules
(ring, zigzag, windowed and Ulysses) with their dense reference.  Port
of ``accl_tpu/parallel``."""

from .collectives import (  # noqa: F401
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    gather,
    hierarchical_all_reduce,
    move,
    moves,
    ppermute,
    process_moves,
    reduce,
    reduce_scatter,
    reset_moves,
    ring_all_gather,
    ring_all_reduce,
    ring_reduce_scatter,
    scatter,
    send_recv,
)
from .mesh import (  # noqa: F401
    MeshConfig,
    RankMesh,
    make_hybrid_mesh,
    make_mesh,
)
from .ring_attention import (  # noqa: F401
    expand_gqa_kv,
    ring_attention,
    ulysses_attention,
)
from .strategies import (  # noqa: F401
    column_parallel,
    expert_combine,
    expert_dispatch,
    pipeline_apply,
    row_parallel,
    sync_gradients,
    zero_shard_gradients,
    zero_unshard_params,
)
