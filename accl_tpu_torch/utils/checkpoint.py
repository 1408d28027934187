"""Checkpoint/restore for model state.

Port of ``accl_tpu/utils/checkpoint.py``.  The reference is a stateless
communication library — its only resume mechanism is the retry queue's
current_step (SURVEY §5).  The framework still ships checkpointing for
the model layer:

- :func:`save_pytree`/:func:`load_pytree`: dependency-free host
  snapshots of a parameter tree (``<path>.npz`` with one ``leaf_{i}``
  array a leaf, plus ``<path>.json`` with the ``treedef`` text and
  ``n_leaves``).  The leaves go in JAX's flatten order (dict keys sorted,
  lists and tuples in order, ``None`` an empty node) and the ``treedef``
  text is ``jax.tree_util``'s ``PyTreeDef(...)`` text for the dict, list,
  tuple and None nodes the port's trees use, so a checkpoint written by
  either package loads in the other.  A bfloat16 leaf is stored as the
  JAX package stores one: numpy has no bfloat16, so ``np.savez`` writes
  its raw 2-byte words as dtype ``|V2``; :func:`load_pytree` reads such
  a leaf back as bfloat16 where ``like`` holds bfloat16.  (The JAX
  package's own ``load_pytree`` refuses ``|V2`` leaves, its own bfloat16
  checkpoints included.)
- :func:`save_sharded`/:func:`load_sharded`: one directory per step.
  The JAX package writes orbax checkpoints there; orbax is a JAX
  library, so the port keeps its own layout (the directory holds a
  :func:`save_pytree` pair, ``state.npz`` + ``state.json``, written to a
  temporary directory and renamed into place).  Orbax checkpoints do
  not cross over in either direction.  The reference's refusals are
  kept: an absolute path only, never an existing one.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

#: torch dtypes with a numpy twin (a checkpoint leaf is a numpy array);
#: bfloat16 has none and is stored as its raw words, ``|V2``, as
#: ``np.savez`` stores an ``ml_dtypes.bfloat16`` array
_NP_DTYPES = {
    torch.float64: np.float64, torch.float32: np.float32,
    torch.float16: np.float16, torch.int64: np.int64,
    torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8,
    torch.uint8: np.uint8, torch.bool: np.bool_,
    torch.bfloat16: np.dtype("V2"),
}


def _flatten(tree) -> list:
    """The leaves in ``jax.tree_util.tree_flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(t) for t in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def treedef_text(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts,
    lists, tuples, None and leaves."""
    return f"PyTreeDef({_structure(tree)})"


def _unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    return build(like)


def _np_dtype(x) -> np.dtype:
    """The numpy dtype a leaf is stored as (a tensor's must exist)."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _NP_DTYPES:
            raise ValueError(f"checkpoint leaf dtype {x.dtype} has no numpy "
                             f"counterpart")
        return np.dtype(_NP_DTYPES[x.dtype])
    return np.asarray(x).dtype


def _dtype_name(x) -> str:
    """The leaf's dtype as the JAX package's errors print it."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(_np_dtype(x))


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        dt = _np_dtype(x)
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(dt)
        return x.numpy()
    return np.asarray(x)


def _to_tensor(x: np.ndarray, exp) -> torch.Tensor:
    """A loaded leaf as a tensor on the device of ``exp`` (the CPU where
    ``exp`` is not a tensor); ``|V2`` words become bfloat16."""
    x = x if x.flags.c_contiguous else np.array(x, order="C")
    if x.dtype == np.dtype("V2"):
        t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t.to(exp.device if isinstance(exp, torch.Tensor) else "cpu")


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors to <path>.npz + <path>.json structure."""
    leaves = _flatten(tree)
    np.savez(path + ".npz", **{
        f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)
    })
    with open(path + ".json", "w") as f:
        json.dump({"treedef": treedef_text(tree), "n_leaves": len(leaves)},
                  f)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of `like` (shape/dtype validated); each
    leaf becomes a tensor on the device of `like`'s leaf (the CPU where
    that leaf is not a tensor)."""
    leaves = _flatten(like)
    treedef = treedef_text(like)
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, "
            f"`like` has {len(leaves)}")
    if meta["treedef"] != treedef:
        raise ValueError(
            f"checkpoint tree structure {meta['treedef']} does not match "
            f"`like` structure {treedef}")
    with np.load(path + ".npz") as data:
        loaded = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for i, (got, exp) in enumerate(zip(loaded, leaves)):
        shape = tuple(exp.shape) if isinstance(exp, torch.Tensor) \
            else np.shape(exp)
        if got.shape != shape:
            raise ValueError(
                f"checkpoint leaf {i} shape {got.shape} != expected "
                f"{shape}")
        if got.dtype != _np_dtype(exp):
            raise ValueError(
                f"checkpoint leaf {i} dtype {got.dtype} != expected "
                f"{_dtype_name(exp)}")
    return _unflatten(like, [_to_tensor(x, exp)
                             for x, exp in zip(loaded, leaves)])


def _require_absolute(path: str) -> str:
    # each host writes its own shards: a relative path would resolve
    # per-process and scatter the checkpoint across working directories
    if not os.path.isabs(path):
        raise ValueError(f"sharded checkpoint path must be absolute: {path!r}")
    return path


def save_sharded(path: str, tree: Any) -> None:
    """Write a tree (per-rank shard lists included) as one checkpoint
    directory.

    `path` must be an absolute directory path and must not already
    exist — save each step to its own path (e.g. ``.../step_000100``)
    so a crash mid-write never destroys the previous recovery point.
    The files are written into a temporary sibling directory that is
    renamed to `path` only when complete."""
    path = _require_absolute(path)
    if os.path.exists(path):
        raise ValueError(
            f"checkpoint path exists: {path!r} — write each step to a "
            f"fresh path; overwriting would delete the only recovery "
            f"point before the new write is finalized")
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp)
    try:
        save_pytree(os.path.join(tmp, "state"), tree)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_sharded(path: str, like: Any) -> Any:
    """Restore a :func:`save_sharded` directory onto the shapes, dtypes
    and devices of `like` (typically the freshly split init state).
    Non-tensor leaves (step counters etc.) are restored by shape/dtype
    via numpy coercion, as 0-d CPU tensors for scalars."""
    return load_pytree(os.path.join(_require_absolute(path), "state"), like)
