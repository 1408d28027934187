"""Logical parallelism axes over rank slots, on one card or on several.

Port of ``accl_tpu/parallel/mesh.py``.  On the TPU a mesh binds the axes
to chips; here a mesh binds them to P rank slots, and a function runs
"over an axis" by taking one tensor per member of that axis (the
rank-list convention of ``accl_tpu_torch/ops/fused.py``).  Axis
conventions are the JAX package's: ``dp``, ``fsdp``, ``tp``, ``sp``,
``pp``, ``ep``.  ``make_hybrid_mesh`` lays dcn axes outside ici axes.

By default every slot lives on one device (``RankMesh.device``).  With
``devices=`` (``make_mesh``, ``make_hybrid_mesh``) each slot has a
device of its own, laid out row-major over the list as the JAX
functions lay devices out over the grid: ``RankMesh.devices`` holds the
slot -> device map in slot order, ``device_grid`` has the mesh's shape
(the counterpart of ``Mesh.devices``).  One card may hold several slots.
Every pair of the cards must have peer access, else the mesh raises
(the rule of ``CudaWorld(devices=)``); nothing is staged through the
host.  ``devices=["cpu"] * P`` builds such a mesh on the CPU, where the
models and strategies take their several-cards code path, every
crossing between two slots counted (``parallel.collectives.moves``).

Over several processes (after ``utils.bringup.initialize_multihost``
joined more than one), ``devices=`` is this process's own devices, every
process passing its own list in the same call: the mesh's global device
list is every process's list in process order (the order of
``jax.devices()``), its slots blocked row-major over it as above, so a
dcn axis of ``make_hybrid_mesh`` lands over the processes as the JAX
function's does (accl_tpu/parallel/mesh.py:116-120).  Each process holds
its own slots (``local_slots``); ``devices`` names every other slot by
a ``ProcessDevice`` (its process and its device there), and the
collectives take ``None`` for a member another process holds.  On the
CPU a process's devices are ``["cpu"] * k``.  Only this process's cards
are checked for peer access: other processes' are reached through CUDA
IPC (``utils/ipc.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import json

import numpy as np
import torch

from ..constants import ACCLError
from ..utils import bringup
from ..utils.device import resolve_device, resolve_devices


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
    """The counterpart of ``jax.sharding.Mesh``: named axes over ``size``
    rank slots, all on ``device``, or with ``devices`` slot s on
    ``devices[s]`` (``device`` is then slot 0's, over several processes
    this process's first slot's).  Two meshes compare by their axes and
    ``device``, as before slot maps existed.  ``processes``: slot ->
    process, for a mesh over several processes (None: every slot in this
    one); a slot of another process has a ``ProcessDevice`` in
    ``devices``."""

    axis_names: tuple
    sizes: tuple
    device: torch.device
    #: slot -> device, in slot order (None: every slot on ``device``)
    devices: Optional[tuple] = field(default=None, compare=False)
    #: slot -> process, in slot order (None: every slot in this process)
    processes: Optional[tuple] = field(default=None, compare=False)

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

    @property
    def device_grid(self) -> np.ndarray:
        """Each mesh position's device, in the mesh's shape: the
        counterpart of ``Mesh.devices``."""
        grid = np.empty(self.size, dtype=object)
        for s in range(self.size):
            grid[s] = self.slot_device(s)
        return grid.reshape(self.sizes)

    def slot_device(self, slot: int) -> torch.device:
        """Slot ``slot``'s device (a ``ProcessDevice`` for a slot of another
        process)."""
        return self.device if self.devices is None else self.devices[slot]

    def slot_process(self, slot: int) -> int:
        """The process that holds slot ``slot``."""
        if self.processes is None:
            return bringup.process_index()
        return self.processes[slot]

    def is_local(self, slot: int) -> bool:
        """Whether this process holds slot ``slot``."""
        return self.slot_process(slot) == bringup.process_index()

    @property
    def local_slots(self) -> tuple:
        """The slots this process holds, in slot order."""
        return tuple(s for s in range(self.size) if self.is_local(s))

    def group_processes(self, axis: str) -> list:
        """The groups along ``axis`` (at every coordinate of the other
        axes) whose slots more than one process holds."""
        if self.processes is None or axis not in self.axis_names:
            return []
        moved = np.moveaxis(self.ranks, self.axis_names.index(axis), -1)
        return [tuple(int(s) for s in g) for g in moved.reshape(
            -1, self.shape[axis]) if len({self.processes[s] for s in g}) > 1]

    def slot(self, **coords) -> int:
        """The slot at the given axis coordinates (axes left out at 0;
        names not in the mesh must be 0)."""
        index = []
        for name in coords:
            if name not in self.axis_names and coords[name]:
                raise ValueError(f"mesh has no axis {name!r}")
        for name in self.axis_names:
            index.append(int(coords.get(name, 0)))
        return int(self.ranks[tuple(index)]) if index else 0

    def group(self, axis: str, **coords) -> tuple:
        """The slots along ``axis`` at the other axes' ``coords`` (axes
        left out at 0), in the axis's order: ``group("tp", dp=d, sp=s)``
        is the tp group of data member d's sp member s,
        ``group("sp", dp=d, tp=t)`` the sp group of its tp rank t, in ring
        order.  An axis not in the mesh is a group of one slot."""
        n = self.shape.get(axis, 1)
        return tuple(self.slot(**{**coords, axis: i}) for i in range(n))


def _check_peers(devs: list, what: str) -> None:
    """Every pair of distinct cards in ``devs`` must have peer access
    (``cudaDeviceCanAccessPeer``), as ``CudaWorld(devices=)`` requires."""
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise ACCLError(f"{what}: cuda:{a} has no peer access to "
                                f"cuda:{b} (cudaDeviceCanAccessPeer): slots "
                                f"on these cards cannot share a mesh")


#: meshes over several processes made by this process (their exchange's
#: number: every process makes them in the same order)
_process_meshes = [0]


def _slot_devices(devices, need: int, what: str) -> tuple:
    """(slot devices, slot processes): the first ``need`` entries of
    ``devices``, resolved (a short list raises ValueError, as the JAX
    functions raise), with every pair of cards checked for peer access,
    and no process map.  Over several processes, ``devices`` is this
    process's own list: the slots are the first ``need`` of every
    process's lists in process order (exchanged through the store), each
    other process's as a ``ProcessDevice``, with their process map."""
    devs = list(devices)
    if bringup.process_count() > 1:
        from ..utils import ipc

        devs = resolve_devices(devs, len(devs), what)
        _check_peers(devs, what)
        n = _process_meshes[0]
        _process_meshes[0] += 1
        got = ipc.transport().exchange(
            f"mesh/{n}", json.dumps([str(d) for d in devs]).encode())
        me = bringup.process_index()
        every = [(q, torch.device(d)) for q, v in enumerate(got)
                 for d in json.loads(v)]
        if len(every) < need:
            raise ValueError(f"{what} needs {need} devices, the processes "
                             f"have {len(every)}")
        every = every[:need]
        if not any(q == me for q, _d in every):
            raise ACCLError(f"{what}: process {me} holds none of its "
                            f"{need} slots")
        return (tuple(d if q == me else bringup.ProcessDevice(q, d)
                      for q, d in every), tuple(q for q, _d in every))
    if len(devs) < need:
        raise ValueError(f"{what} needs {need} devices, have {len(devs)}")
    devs = resolve_devices(devs, need, what)
    _check_peers(devs, what)
    return tuple(devs), None


def _mesh_over(names, shape, devs, procs) -> RankMesh:
    """The mesh over slot devices ``devs`` (and processes ``procs``):
    ``device`` is this process's first slot's."""
    first = next(d for d in devs
                 if not isinstance(d, bringup.ProcessDevice))
    return RankMesh(names, shape, first, devs, procs)


def make_mesh(config: MeshConfig | None = None, device="cuda",
              devices=None, **axis_sizes) -> RankMesh:
    """``make_mesh(dp=2, tp=4)`` -> a RankMesh with axes ("dp", "tp") over
    8 rank slots of ``device`` (the card by default; raises without one).
    Axis order follows MeshConfig's declaration order.  ``devices``: a
    list of at least that many devices, slot s (row-major over the axes)
    on ``devices[s]``, as ``accl_tpu/parallel/mesh.py`` lays its device
    list over the grid.  Over several processes ``devices`` is this
    process's own list (module docstring)."""
    if config is None:
        config = MeshConfig(**axis_sizes)
    axes = config.axes() or {"dp": 1}
    names, shape = tuple(axes), tuple(axes.values())
    if devices is None:
        return RankMesh(names, shape, resolve_device(device, "make_mesh"))
    return _mesh_over(names, shape, *_slot_devices(
        devices, int(np.prod(shape)), "mesh"))


def make_hybrid_mesh(ici: dict, dcn: dict, devices=None) -> RankMesh:
    """The multi-slice mesh, the twin of ``accl_tpu/parallel/mesh.py``
    ``make_hybrid_mesh``: ``dcn`` axes (across slices) outermost, ``ici``
    axes (within a slice) innermost, axes of size 1 dropped, rank slots
    blocked row-major, so ``make_hybrid_mesh({"tp": 4}, {"dp": 2})`` has
    axes ("dp", "tp") and slot 4 d + t at position (d, t).

    A process's cards are one host, and so one slice: the JAX function's
    multi-slice branch (devices grouped by ``slice_index``) has nothing to
    group here and cannot be reached.  ``devices``: None (the card) or a
    device, every slot on it; or a list of at least as many devices as
    the mesh has slots (as the JAX function checks), slot s on
    ``devices[s]``, as the JAX function lays the list over its grid.
    Over several processes the list is this process's own devices and
    the slots block row-major over every process's, so the dcn axes land
    over the processes (module docstring)."""
    dcn_sizes = {k: v for k, v in dcn.items() if v > 1}
    ici_sizes = {k: v for k, v in ici.items() if v > 1}
    names = tuple(dcn_sizes) + tuple(ici_sizes)
    shape = tuple(dcn_sizes.values()) + tuple(ici_sizes.values())
    need = int(np.prod(shape)) if shape else 1
    if devices is None or isinstance(devices, (str, torch.device)):
        return RankMesh(names, shape, resolve_device(
            "cuda" if devices is None else devices, "make_hybrid_mesh"))
    return _mesh_over(names, shape, *_slot_devices(devices, need,
                                                   "hybrid mesh"))
