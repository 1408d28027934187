"""One-call world bring-up + rank-table generation.

Port of ``accl_tpu/utils/bringup.py``, the equivalent of the reference
accl_network_utils: the `acclDesign` enum selecting the transport
design, `generate_ranks` building the rank table from a pattern or
file, and `initialize_world` performing the full bring-up in one call
(driver/utils/accl_network_utils.cpp:264-289, :292-362).  The designs:

- ``EMU_INPROC``: native engines in one process (AXIS3x loopback rung)
- ``EMU_TCP``:    one native engine per process over sockets (TCP rung)
- ``CUDA``:       the gang engine, the ranks on one card or, with
  ``devices=``, on several (the JAX package's ``TPU`` rung)

``initialize_multihost`` is the twin of the JAX package's: the same
arguments and environment, and in place of ``jax.distributed`` a
rendezvous of the host processes on a ``torch.distributed.TCPStore`` at
the coordinator.  What it keeps is read back by the counterparts of
JAX's process functions: :func:`process_index`, :func:`process_count`,
:func:`local_devices` and :func:`devices` (the global list, in process
order, each entry a :class:`ProcessDevice`).  Without it they describe
one process, as JAX's do.  The processes' meshes, collectives and ring
kernels go through ``utils/ipc.py`` over the same store.
"""
from __future__ import annotations

import enum
import json
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence

import torch

from ..communicator import Rank
from ..constants import DEFAULT_EAGER_RX_BUF_SIZE, ACCLError


class Design(enum.Enum):
    EMU_INPROC = "emu-inproc"
    EMU_TCP = "emu-tcp"
    CUDA = "cuda"


def generate_ranks(nranks: int, base_port: int = 5500,
                   ips: Optional[Sequence[str]] = None,
                   rank_file: Optional[str] = None,
                   max_segment_size: int = DEFAULT_EAGER_RX_BUF_SIZE) -> list[Rank]:
    """Build the rank table from a pattern or a JSON rank file
    (reference: generate_ranks file/pattern variants,
    accl_network_utils.cpp:235-289)."""
    if rank_file:
        with open(rank_file) as f:
            spec = json.load(f)
        return [
            Rank(ip=r.get("ip", "127.0.0.1"), port=r.get("port", base_port + i),
                 session=r.get("session", i),
                 max_segment_size=r.get("max_segment_size", max_segment_size))
            for i, r in enumerate(spec["ranks"])
        ]
    ips = list(ips) if ips else ["127.0.0.1"] * nranks
    return [
        Rank(ip=ips[i % len(ips)], port=base_port + i, session=i,
             max_segment_size=max_segment_size)
        for i in range(nranks)
    ]


def initialize_world(design: Design | str, nranks: int, rank: int = 0,
                     base_port: int = 5500, **kwargs):
    """One-call bring-up (reference: initialize_accl).

    EMU_INPROC / CUDA return a world object (all ranks, single process;
    ``CudaWorld`` on the card unless ``device="cpu"`` is passed, its ranks
    on ``devices=`` when given, one per rank); EMU_TCP returns this
    process's single-rank node."""
    design = Design(design) if not isinstance(design, Design) else design
    if design == Design.EMU_INPROC:
        from ..backends.emu import EmuWorld

        return EmuWorld(nranks, **kwargs)
    if design == Design.EMU_TCP:
        from ..backends.emu import EmuRankTcp

        return EmuRankTcp(rank, nranks, base_port, **kwargs)
    if design == Design.CUDA:
        from ..backends.cuda import CudaWorld

        return CudaWorld(nranks, **kwargs)
    raise ValueError(f"unknown design {design}")


#: this process's rendezvous store: process 0's hosts the others' (kept
#: for the life of the process, as jax.distributed keeps its client)
_STORE = None
#: what initialize_multihost keeps besides the store: this process's id,
#: the process count, the coordinator's address, this process's devices
#: and (read at first use) every process's
_PROCESS = {"id": 0, "count": 1, "address": None, "local": None,
            "all": None}


@dataclass(frozen=True)
class ProcessDevice:
    """A device as every process of a multi-process run names it: the
    process that holds it (``process_index``, as a JAX device's) and the
    device there.  A mesh's slots of other processes hold one of these
    (``RankMesh.devices``); its own slots hold the ``torch.device``."""

    process_index: int
    device: torch.device

    def __str__(self) -> str:
        return f"{self.device}@process{self.process_index}"

    __repr__ = __str__

    @property
    def type(self) -> str:
        return self.device.type


def process_index() -> int:
    """This process's id (``jax.process_index()``): 0 without
    :func:`initialize_multihost`."""
    return _PROCESS["id"]


def process_count() -> int:
    """The processes that joined (``jax.process_count()``): 1 without
    :func:`initialize_multihost`."""
    return _PROCESS["count"]


def store():
    """The rendezvous store of :func:`initialize_multihost`, or None."""
    return _STORE


def _visible(ids=None) -> list:
    if torch.cuda.is_available():
        ids = range(torch.cuda.device_count()) if ids is None else ids
        return [torch.device("cuda", int(i)) for i in ids]
    return [torch.device("cpu")]


def local_devices() -> list:
    """This process's devices (``jax.local_devices()``): the cards of
    ``local_device_ids``, by default every card it sees; the CPU on a
    machine without one."""
    if _PROCESS["local"] is None:
        _PROCESS["local"] = _visible()
    return list(_PROCESS["local"])


def devices() -> list:
    """Every process's devices, process 0's first (``jax.devices()``),
    each a :class:`ProcessDevice`; read from the store at first use."""
    if _PROCESS["all"] is None:
        if _STORE is None:
            _PROCESS["all"] = [ProcessDevice(0, d) for d in local_devices()]
        else:
            from .ipc import store_wait

            out = []
            for p in range(process_count()):
                key = f"accl/devices/{p}"
                store_wait(_STORE, key, p, "devices()")
                out += [ProcessDevice(p, torch.device(d))
                        for d in json.loads(_STORE.get(key))]
            _PROCESS["all"] = out
    return list(_PROCESS["all"])


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         local_device_ids=None,
                         dry_run: bool = False,
                         timeout_s: float = 300.0) -> dict:
    """Multi-host bring-up, the twin of ``accl_tpu/utils/bringup.py``
    ``initialize_multihost`` (the reference's MPI-launch role: one
    process per host joins the others before any collective).

    Arguments default from the environment, as there: ``ACCL_COORDINATOR``
    (host:port of process 0), ``ACCL_NUM_PROCESSES``, ``ACCL_PROCESS_ID``;
    explicit arguments win.  ``dry_run=True`` returns the resolved kwargs
    (the JAX function's, ``local_device_ids`` as a list) and touches
    nothing.  Otherwise the process joins a ``torch.distributed.TCPStore``
    rendezvous at the coordinator: process 0 hosts the store, every
    process checks in and waits until all ``num_processes`` have, and
    process 0 returns only after every other process has seen them all
    (so its store outlives their wait).  No process group and no
    collective of any library is made.  A process that waits more than
    ``timeout_s`` raises ``ACCLError`` naming the processes that never
    checked in.  Where JAX auto-detects a TPU pod from its metadata, the
    port has nothing to detect: the three values are required.

    Afterwards the process keeps its id, the process count, the store and
    its devices (``local_device_ids``: its cards, by default every card
    it sees; the CPU without one), read by :func:`process_index`,
    :func:`process_count`, :func:`local_devices` and :func:`devices`.
    Meshes over the processes (``make_mesh``/``make_hybrid_mesh`` with
    ``devices=``) and every collective over them need each process to
    make the same calls in the same order, as any collective library
    does."""
    import os

    def _env_int(name):
        val = os.environ.get(name)
        return int(val) if val is not None else None

    kwargs = {}
    coordinator_address = (coordinator_address
                           or os.environ.get("ACCL_COORDINATOR"))
    num_processes = (num_processes if num_processes is not None
                     else _env_int("ACCL_NUM_PROCESSES"))
    process_id = (process_id if process_id is not None
                  else _env_int("ACCL_PROCESS_ID"))
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    if dry_run:
        return kwargs
    missing = [k for k in ("coordinator_address", "num_processes",
                           "process_id") if k not in kwargs]
    if missing:
        raise ACCLError(f"initialize_multihost: no {', '.join(missing)} "
                        f"(pass them or set ACCL_COORDINATOR, "
                        f"ACCL_NUM_PROCESSES, ACCL_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ACCLError(f"initialize_multihost: process_id {process_id} "
                        f"outside 0..{num_processes - 1}")
    _rendezvous(coordinator_address, num_processes, process_id, timeout_s)
    _PROCESS.update(id=process_id, count=num_processes,
                    address=coordinator_address,
                    local=_visible(local_device_ids), all=None)
    _STORE.set(f"accl/devices/{process_id}",
               json.dumps([str(d) for d in _PROCESS["local"]]))
    return kwargs


def _rendezvous(address: str, n: int, pid: int, timeout_s: float) -> None:
    """Check in at the store and wait for all ``n``; then check out, and
    on process 0 wait until every process has checked out."""
    global _STORE
    from torch.distributed import TCPStore

    host, _, port = address.rpartition(":")
    deadline = time.monotonic() + timeout_s
    try:
        store = TCPStore(host, int(port), n, pid == 0,
                         timedelta(seconds=timeout_s),
                         wait_for_workers=False)
    except (RuntimeError, OSError) as e:  # a refused or timed-out connect
        raise ACCLError(f"initialize_multihost: process {pid} cannot reach "
                        f"the coordinator at {address}: {e}") from e
    _STORE = store
    store.set(f"accl/joined/{pid}", "1")
    for phase in ("joined", "left"):
        if phase == "left":
            store.set(f"accl/left/{pid}", "1")
            if pid != 0:
                return
        while True:
            absent = [i for i in range(n)
                      if not store.check([f"accl/{phase}/{i}"])]
            if not absent:
                break
            if time.monotonic() > deadline:
                raise ACCLError(
                    f"initialize_multihost: process {pid} waited "
                    f"{timeout_s:.0f}s at {address}; process(es) {absent} "
                    f"never checked in")
            time.sleep(0.01)
