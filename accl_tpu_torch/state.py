"""Carry a world's state into a CudaWorld.

The system has no weights: its state is the per-rank buffers, the
communicator table and the ring threshold.  ``state`` is plain data:

    {"buffers": {rank: [np.ndarray, ...]},
     "comms": [[global ranks], ...],        # sub-communicators, in order
     "ring_threshold_bytes": int}

:func:`load_world_state` creates the same buffers with the same contents,
the same communicators (same ids on every rank) and the same threshold,
so the two worlds compute the same thing.

:func:`tp_weight_shards` splits a full row-parallel weight into the
per-rank K-shards the fused tensor-parallel matmuls (``ops/fused.py``)
take, the way ``P("tp", None)`` shards it in the JAX package's model
(``accl_tpu/models/transformer.py`` ``param_specs``).

:func:`model_params_from_jax` carries the JAX package's model parameters
(its pytree, as numpy arrays) into the port's layout, split over the
tensor-parallel ranks; :func:`model_params_to_numpy` takes them back.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import TuningKey
from .models.transformer import shard_params
from .utils.device import resolve_device


def load_world_state(world, state: dict) -> dict:
    """Load ``state`` into ``world`` (a CudaWorld).  Returns
    ``{"buffers": {rank: [buffer, ...]}, "comms": [comm id, ...]}``."""
    buffers = {}
    for rank, arrays in state.get("buffers", {}).items():
        accl = world.accls[int(rank)]
        bufs = []
        for arr in arrays:
            buf = accl.create_buffer_like(np.asarray(arr))
            buf.sync_to_device()
            bufs.append(buf)
        buffers[int(rank)] = bufs
    comm_ids = []
    for members in state.get("comms", []):
        ids = set()
        for rank, accl in enumerate(world.accls):
            if rank in members:
                ids.add(accl.create_communicator(list(members)))
            else:
                ids.add(accl.reserve_communicator())
        (cid,) = ids  # every rank minted the same id
        comm_ids.append(cid)
    if "ring_threshold_bytes" in state:
        for accl in world.accls:
            accl.set_tuning(int(TuningKey.RING_THRESHOLD_BYTES),
                            int(state["ring_threshold_bytes"]))
    return {"buffers": buffers, "comms": comm_ids}


def tp_weight_shards(w_full, P: int, device="cuda") -> list:
    """A full row-parallel weight — numpy ``[K, N]``, or an output
    projection ``[H, Dh, D]`` taken as ``[H * Dh, D]`` — split along K
    into P contiguous shards ``[K / P, N]`` (rank r gets rows
    ``r * K / P`` to ``(r + 1) * K / P``), as tensors on ``device``."""
    w = np.asarray(w_full)
    if w.ndim == 3:
        w = w.reshape(w.shape[0] * w.shape[1], w.shape[2])
    if w.ndim != 2:
        raise ValueError(f"tp_weight_shards: want [K, N] or [H, Dh, D], got "
                         f"shape {w.shape}")
    K = w.shape[0]
    if K % P:
        raise ValueError(f"tp_weight_shards: K ({K}) does not divide into "
                         f"{P} shards")
    k = K // P
    return [torch.from_numpy(np.ascontiguousarray(w[r * k:(r + 1) * k])).to(
        device) for r in range(P)]


def model_params_from_jax(params: dict, cfg, tp: int = 1,
                          device="cuda") -> dict:
    """The JAX package's parameter pytree (``{"embed", "blocks": [...],
    "ln_f"}``, numpy arrays) as the port's parameters on ``device``:
    replicated leaves once, sharded leaves split over ``tp`` ranks by
    ``param_specs``."""
    dev = resolve_device(device, "model_params_from_jax")

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    full = {"embed": conv(params["embed"]), "ln_f": conv(params["ln_f"]),
            "blocks": [{k: conv(v) for k, v in blk.items()}
                       for blk in params["blocks"]]}
    return shard_params(full, cfg, tp)


def model_params_to_numpy(params: dict, cfg) -> dict:
    """The port's parameters, split over any rank count, back in the JAX
    pytree's layout as numpy arrays."""
    full = shard_params(params, cfg, 1)

    def conv(leaf):
        t = leaf[0] if isinstance(leaf, list) else leaf
        return t.detach().cpu().numpy()

    return {"embed": conv(full["embed"]), "ln_f": conv(full["ln_f"]),
            "blocks": [{k: conv(v) for k, v in blk.items()}
                       for blk in full["blocks"]]}
