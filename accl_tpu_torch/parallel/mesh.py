"""Logical parallelism axes over rank slots of one card.

Port of ``accl_tpu/parallel/mesh.py``.  On the TPU a mesh binds the axes
to chips; here the P rank slots of a mesh live on one device, and a
function runs "over an axis" by taking one tensor per member of that axis
(the rank-list convention of ``accl_tpu_torch/ops/fused.py``).  Axis
conventions are the JAX package's: ``dp``, ``fsdp``, ``tp``, ``sp``,
``pp``, ``ep``.  Multi-card meshes come later: ``make_hybrid_mesh``
raises.
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


def make_hybrid_mesh(ici: dict, dcn: dict, devices=None):
    """Multi-slice meshes need more than one card: not ported yet."""
    raise ACCLError("make_hybrid_mesh is not part of accl_tpu_torch yet "
                    "(meshes over more than one card come later)")
