"""The SPMD layer over rank lists: meshes of rank slots on one card, the
functional collectives, and the dense attention reference.  Port of
``accl_tpu/parallel`` (``strategies.py`` and the sequence-parallel
attention schedules are not ported yet)."""

from .collectives import (  # noqa: F401
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    gather,
    hierarchical_all_reduce,
    ppermute,
    reduce,
    reduce_scatter,
    ring_all_gather,
    ring_all_reduce,
    ring_reduce_scatter,
    scatter,
    send_recv,
)
from .mesh import MeshConfig, RankMesh, make_mesh  # noqa: F401
from .ring_attention import expand_gqa_kv  # noqa: F401
