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
:func:`moe_params_from_jax` and :func:`moe_params_to_numpy` do the same
for the MoE family's pytree, the expert banks split over the
expert-parallel members.  :func:`adamw_state_from_optax` carries an
``optax.adamw`` state of the JAX model into the port's ``optim.AdamWState``
(the moments split as the parameters), and :func:`adamw_state_to_numpy`
takes it back, so both packages can start from the same mid-run state.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import TuningKey
from .models.moe import place_params as moe_place_params
from .models.moe import shard_params as moe_shard_params
from .models.transformer import nest_as, placed_trees, shard_params
from .optim import AdamWState
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
                          device="cuda", mesh=None) -> dict:
    """The JAX package's parameter pytree (``{"embed", "blocks": [...],
    "ln_f"}``, numpy arrays) as the port's parameters on ``device``:
    replicated leaves once, sharded leaves split over ``tp`` ranks by
    ``param_specs``.  With a ``mesh`` over several cards, placed on its
    cards (``transformer.place_params``; tp is the mesh's extent)."""
    dev = resolve_device(device if mesh is None else mesh.device,
                         "model_params_from_jax")

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    full = {"embed": conv(params["embed"]), "ln_f": conv(params["ln_f"]),
            "blocks": [{k: conv(v) for k, v in blk.items()}
                       for blk in params["blocks"]]}
    return shard_params(full, cfg, tp, mesh=mesh)


def model_params_to_numpy(params: dict, cfg) -> dict:
    """The port's parameters, split over any rank count, back in the JAX
    pytree's layout as numpy arrays.  A placed container (``Replicas``,
    ``SpReplicas``) gives its first tree: every tree holds the same
    values."""
    full = shard_params(params, cfg, 1)

    def conv(leaf):
        t = leaf[0] if isinstance(leaf, list) else leaf
        return t.detach().cpu().numpy()

    return {"embed": conv(full["embed"]), "ln_f": conv(full["ln_f"]),
            "blocks": [{k: conv(v) for k, v in blk.items()}
                       for blk in full["blocks"]]}


def moe_params_from_jax(params: dict, cfg, ep: int = 1,
                        device="cuda", mesh=None) -> dict:
    """The JAX package's MoE parameter pytree (numpy arrays) as the port's
    MoE parameters on ``device``: the expert banks split over ``ep``
    members, the other leaves once.  With a ``mesh`` over several cards,
    placed on its cards (``moe.place_params``)."""
    dev = resolve_device(device if mesh is None else mesh.device,
                         "moe_params_from_jax")

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    full = {"embed": conv(params["embed"]), "ln_f": conv(params["ln_f"]),
            "blocks": [{k: conv(v) for k, v in blk.items()}
                       for blk in params["blocks"]]}
    if mesh is not None and mesh.devices is not None:
        return moe_place_params(full, cfg, mesh)
    return moe_shard_params(full, cfg, ep)


def moe_params_to_numpy(params: dict, cfg) -> dict:
    """The port's MoE parameters, split over any ep count, back in the JAX
    pytree's layout as numpy arrays."""
    full = moe_shard_params(params, cfg, 1)

    def conv(leaf):
        t = leaf[0] if isinstance(leaf, list) else leaf
        return t.detach().cpu().numpy()

    return {"embed": conv(full["embed"]), "ln_f": conv(full["ln_f"]),
            "blocks": [{k: conv(v) for k, v in blk.items()}
                       for blk in full["blocks"]]}


def _adam_node(opt_state):
    """The node of an optax state that carries ``count``, ``mu`` and
    ``nu`` (``ScaleByAdamState``, the first link of ``optax.adamw``'s
    chain)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (list, tuple)):
        for node in opt_state:
            found = _adam_node(node)
            if found is not None:
                return found
    return None


def adamw_state_from_optax(opt_state, cfg, tp: int = 1,
                           device="cuda", mesh=None):
    """An ``optax.adamw`` state of the JAX model (its ``ScaleByAdamState``
    anywhere in the chain's tuple; arrays or numpy) as the port's
    ``AdamWState`` on ``device``: the moments in the port's parameter
    layout, split over ``tp`` ranks, the count an int32 scalar.  With a
    ``mesh`` over several cards the moments are placed beside the shards
    they mirror (``model_params_from_jax(mesh=)``), the count on each
    member's hub; one state per placed tree, nested as the trees are (with
    a dp axis a list of one per data member, with an sp axis a list of one
    per sp member)."""
    node = _adam_node(opt_state)
    if node is None:
        raise ValueError("adamw_state_from_optax: no state with count, mu "
                         "and nu in the optimizer state")
    if mesh is not None and mesh.devices is not None:
        mu = model_params_from_jax(node.mu, cfg, tp, mesh=mesh)
        nu = model_params_from_jax(node.nu, cfg, tp, mesh=mesh)
        count = int(np.asarray(node.count))
        return nest_as(mu, [AdamWState(count=torch.tensor(
            count, dtype=torch.int32, device=m.places.devices[0]), mu=m, nu=n)
            for m, n in zip(placed_trees(mu), placed_trees(nu))])
    dev = resolve_device(device, "adamw_state_from_optax")
    return AdamWState(
        count=torch.tensor(int(np.asarray(node.count)), dtype=torch.int32,
                           device=dev),
        mu=model_params_from_jax(node.mu, cfg, tp, dev),
        nu=model_params_from_jax(node.nu, cfg, tp, dev))


def adamw_state_to_numpy(state: AdamWState, cfg) -> dict:
    """The port's ``AdamWState``, split over any rank count, as numpy:
    ``{"count": int, "mu": tree, "nu": tree}``, the moments in the JAX
    pytree's layout."""
    return {"count": int(state.count),
            "mu": model_params_to_numpy(state.mu, cfg),
            "nu": model_params_to_numpy(state.nu, cfg)}
