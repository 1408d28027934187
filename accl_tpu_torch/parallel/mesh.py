"""Logical parallelism axes over rank slots of one card.

Port of ``accl_tpu/parallel/mesh.py``.  On the TPU a mesh binds the axes
to chips; here the P rank slots of a mesh live on one device, and a
function runs "over an axis" by taking one tensor per member of that axis
(the rank-list convention of ``accl_tpu_torch/ops/fused.py``).  Axis
conventions are the JAX package's: ``dp``, ``fsdp``, ``tp``, ``sp``,
``pp``, ``ep``.  ``make_hybrid_mesh`` lays dcn axes outside ici axes
over the rank slots of one card; meshes over several cards come later.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import ACCLError
from ..utils.device import resolve_device


@dataclass
class MeshConfig:
    """Logical axis sizes; unspecified axes default to 1 and axes of size
    1 are dropped from the mesh."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def axes(self) -> dict:
        return {k: v for k, v in vars(self).items() if v > 1}

    @property
    def num_devices(self) -> int:
        n = 1
        for v in vars(self).values():
            n *= v
        return n


@dataclass(frozen=True)
class RankMesh:
    """The one-card counterpart of ``jax.sharding.Mesh``: named axes over
    ``size`` rank slots on ``device``."""

    axis_names: tuple
    sizes: tuple
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def ranks(self) -> np.ndarray:
        """The rank slot at each mesh position, blocked row-major (the
        order ``Mesh.devices`` holds the devices in)."""
        return np.arange(self.size).reshape(self.sizes)


def make_mesh(config: MeshConfig | None = None, device="cuda",
              **axis_sizes) -> RankMesh:
    """``make_mesh(dp=2, tp=4)`` -> a RankMesh with axes ("dp", "tp") over
    8 rank slots of ``device`` (the card by default; raises without one).
    Axis order follows MeshConfig's declaration order."""
    if config is None:
        config = MeshConfig(**axis_sizes)
    axes = config.axes() or {"dp": 1}
    return RankMesh(tuple(axes), tuple(axes.values()),
                    resolve_device(device, "make_mesh"))


def make_hybrid_mesh(ici: dict, dcn: dict, devices=None) -> RankMesh:
    """The multi-slice mesh, the twin of ``accl_tpu/parallel/mesh.py``
    ``make_hybrid_mesh``: ``dcn`` axes (across slices) outermost, ``ici``
    axes (within a slice) innermost, axes of size 1 dropped, rank slots
    blocked row-major, so ``make_hybrid_mesh({"tp": 4}, {"dp": 2})`` has
    axes ("dp", "tp") and slot 4 d + t at position (d, t).

    It returns a RankMesh on one card, as :func:`make_mesh` does.  A
    process's cards are one host, and so one slice: the JAX function's
    multi-slice branch (devices grouped by ``slice_index``) has nothing to
    group here and cannot be reached.  ``devices``: None (the card), a
    device, or a list of the slots' devices, at least as many as the
    mesh's slots (as the JAX function checks) and naming one device; a
    list naming more than one card raises, since model meshes over
    several cards come later."""
    if devices is None:
        devs = ["cuda"]
    elif isinstance(devices, (str, torch.device)):
        devs = [devices]
    else:
        devs = list(devices)
    dcn_sizes = {k: v for k, v in dcn.items() if v > 1}
    ici_sizes = {k: v for k, v in ici.items() if v > 1}
    names = tuple(dcn_sizes) + tuple(ici_sizes)
    shape = tuple(dcn_sizes.values()) + tuple(ici_sizes.values())
    need = int(np.prod(shape)) if shape else 1
    if isinstance(devices, (list, tuple)) and len(devs) < need:
        raise ValueError(f"hybrid mesh needs {need} devices, have "
                         f"{len(devs)}")
    distinct = {str(torch.device(d)) for d in devs}
    if len(distinct) > 1:
        raise ACCLError(f"make_hybrid_mesh: devices {sorted(distinct)} name "
                        f"more than one card; meshes over several cards are "
                        f"not part of accl_tpu_torch yet")
    return RankMesh(names, shape, resolve_device(devs[0], "make_hybrid_mesh"))
