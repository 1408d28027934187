"""Device-side caller API: the reference's HLS bindings.

Port of ``accl_tpu/device_api.py``.  The reference lets FPGA kernels
issue collectives without the host driver: ``accl_hls::ACCLCommand``
(driver/hls/accl_hls.h:82-500) streams the 15-word call descriptor to the
client arbiter and blocks on the ack stream, and ``accl_hls::ACCLData``
(accl_hls.h:502-543) pushes and pulls data words on the engine's kernel
stream ports.  ``vadd_put`` (kernels/plugins/vadd_put/vadd_put.cpp:23-86)
is the canonical user.

Two call sites:

1. **Kernel-initiated calls against the engine** — :class:`ACCLCommand`
   posts raw descriptors straight onto the engine's command queue, which
   takes call bundles from any thread, and :class:`ACCLData` wraps the
   kernel stream push and pop.  On a ``CudaWorld`` a pushed operand is a
   tensor on the card, and stream collectives at or above the ring
   threshold run through the ring kernels as buffer collectives do.
2. **Device code over a rank list** — :class:`DeviceCollectives` binds the
   one-card collectives of ``accl_tpu_torch.parallel.collectives`` under
   the same method names.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .accl import GLOBAL_COMM
from .backends.base import CCLODevice
from .constants import (
    TAG_ANY,
    CCLOCall,
    CompressionFlags,
    HostFlags,
    Operation,
    OperationStatus,
    StreamFlags,
)
from .request import Request


def _collectives():
    from .parallel import collectives
    return collectives


class ACCLCommand:
    """Issue raw call descriptors from kernel code.

    Mirrors ``accl_hls::ACCLCommand``: the constructor captures the
    communicator and datapath-config ids (accl_hls.h:84-107), each helper
    marshals one descriptor (:219-500), and ``finalize_call`` blocks on
    the ack (:204-216).  Buffer operands are raw device addresses, as on
    the reference's command stream: kernels hold no driver buffer
    objects.
    """

    def __init__(self, device: CCLODevice, comm: int = GLOBAL_COMM,
                 arithcfg: int = 0):
        self._device = device
        self._comm = comm
        self._arithcfg = arithcfg
        self._pending: Optional[Request] = None

    # -- raw descriptor path (accl_hls.h:134-216) ----------------------
    def start_call(self, scenario: Operation, count: int,
                   root_src_dst: int = 0, function: int = 0,
                   tag: int = TAG_ANY,
                   compression_flags: CompressionFlags =
                   CompressionFlags.NO_COMPRESSION,
                   stream_flags: StreamFlags = StreamFlags.NO_STREAM,
                   addr_0: int = 0, addr_1: int = 0,
                   addr_2: int = 0) -> Request:
        """Post one 15-word descriptor on the engine command queue and
        return the pending request (the ack stream handle)."""
        if self._pending is not None:
            raise RuntimeError(
                "previous call not finalized (the reference command stream "
                "is strictly call/ack ordered per client)")
        call = CCLOCall(
            scenario=scenario, count=count, comm=self._comm,
            root_src_dst=root_src_dst, function=function, tag=tag,
            arithcfg=self._arithcfg, compression_flags=compression_flags,
            stream_flags=stream_flags, host_flags=HostFlags.NO_HOST,
            addr_0=addr_0, addr_1=addr_1, addr_2=addr_2,
        )
        req = Request(f"krnl:{scenario.name}")
        req.status = OperationStatus.EXECUTING
        self._device.start(call, req)
        self._pending = req
        return req

    def finalize_call(self, timeout: float = 60.0) -> int:
        """Block until the engine acks the call; raises on a non-zero
        retcode (accl_hls.h:204-216 reads the sts stream).  On timeout the
        call stays pending — it is still in flight on the engine, so the
        client must not issue another descriptor."""
        req = self._pending
        if req is None:
            raise RuntimeError("no call in flight")
        if not req.wait(timeout=timeout):
            raise TimeoutError("kernel call not acked")
        self._pending = None
        req.check()
        return req.retcode

    def _run(self, *args, **kw) -> int:
        self.start_call(*args, **kw)
        return self.finalize_call()

    # -- per-collective helpers (accl_hls.h:219-500) --------------------
    def copy(self, count: int, src_addr: int, dst_addr: int) -> int:
        return self._run(Operation.copy, count, addr_0=src_addr,
                         addr_2=dst_addr)

    def combine(self, count: int, function: int, op0_addr: int,
                op1_addr: int, res_addr: int) -> int:
        return self._run(Operation.combine, count, function=function,
                         addr_0=op0_addr, addr_1=op1_addr, addr_2=res_addr)

    def send(self, count: int, tag: int, dst: int,
             src_addr: int = 0,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM) -> int:
        return self._run(Operation.send, count, root_src_dst=dst, tag=tag,
                         addr_0=src_addr, stream_flags=stream_flags)

    def recv(self, count: int, tag: int, src: int,
             dst_addr: int = 0,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM) -> int:
        return self._run(Operation.recv, count, root_src_dst=src, tag=tag,
                         addr_2=dst_addr, stream_flags=stream_flags)

    def stream_put(self, count: int, stream_id: int, dst: int,
                   src_addr: int = 0,
                   from_stream: bool = True) -> int:
        """Put into a remote kernel stream (accl_hls.h:277-298).  With
        ``from_stream`` the payload comes off the local kernel input
        stream (the vadd_put pattern); otherwise from ``src_addr``."""
        if stream_id < 9:
            raise ValueError("stream ids < 9 are reserved")
        flags = StreamFlags.RES_STREAM
        if from_stream:
            flags |= StreamFlags.OP0_STREAM
        return self._run(Operation.send, count, root_src_dst=dst,
                         tag=stream_id, addr_0=src_addr, stream_flags=flags)

    def bcast(self, count: int, root: int, addr: int) -> int:
        return self._run(Operation.bcast, count, root_src_dst=root,
                         addr_0=addr, addr_2=addr)

    def scatter(self, count: int, root: int, src_addr: int,
                dst_addr: int) -> int:
        return self._run(Operation.scatter, count, root_src_dst=root,
                         addr_0=src_addr, addr_2=dst_addr)

    def gather(self, count: int, root: int, src_addr: int,
               dst_addr: int) -> int:
        return self._run(Operation.gather, count, root_src_dst=root,
                         addr_0=src_addr, addr_2=dst_addr)

    def reduce(self, count: int, root: int, function: int, src_addr: int,
               dst_addr: int) -> int:
        return self._run(Operation.reduce, count, root_src_dst=root,
                         function=function, addr_0=src_addr,
                         addr_2=dst_addr)

    def allgather(self, count: int, src_addr: int, dst_addr: int) -> int:
        return self._run(Operation.allgather, count, addr_0=src_addr,
                         addr_2=dst_addr)

    def allreduce(self, count: int, function: int, src_addr: int,
                  dst_addr: int) -> int:
        return self._run(Operation.allreduce, count, function=function,
                         addr_0=src_addr, addr_2=dst_addr)

    def reduce_scatter(self, count: int, function: int, src_addr: int,
                       dst_addr: int) -> int:
        return self._run(Operation.reduce_scatter, count, function=function,
                         addr_0=src_addr, addr_2=dst_addr)

    def barrier(self) -> int:
        return self._run(Operation.barrier, 0)


class ACCLData:
    """Kernel data streams (``accl_hls::ACCLData``, accl_hls.h:502-543):
    push operand bytes into the engine's kernel input stream and pull
    results from a named output stream."""

    def __init__(self, device: CCLODevice):
        self._device = device

    def push(self, data: np.ndarray) -> None:
        """Stream operand words to the engine (data_to_cclo port)."""
        self._device.push_krnl(np.asarray(data))

    def pull(self, count: int, dtype=np.float32, stream_id: int = 9,
             timeout: float = 10.0) -> np.ndarray:
        """Pull one message from a kernel output stream
        (data_from_cclo port, routed by the wire header's strm field)."""
        nbytes = count * np.dtype(dtype).itemsize
        raw = self._device.pop_stream(stream_id, nbytes, timeout)
        if raw is None:
            raise TimeoutError(f"no message on stream {stream_id}")
        if len(raw) != nbytes:
            raise ValueError(
                f"stream {stream_id} message is {len(raw)} bytes, "
                f"expected {nbytes} ({count} x {np.dtype(dtype).name})")
        return np.frombuffer(raw, dtype=dtype).copy()


class DeviceCollectives:
    """The device-code half: the same helper names, bound to the one-card
    collectives of ``accl_tpu_torch.parallel.collectives``.

    The JAX class binds each name to an SPMD lowering over one mesh axis,
    called inside ``shard_map`` on one member's value.  One card has no
    mesh: here the axis is a list, so every method takes the members'
    tensors in rank order (``xs[r]`` is what member ``r`` holds under
    ``shard_map``) and returns one result per member, ``out[r]`` being
    what member ``r``'s call returns there.  Members that end with the
    same value may share one tensor.  ``barrier`` takes the list too (one
    entry per member; only its length and device matter).
    """

    def allreduce(self, xs: Sequence, op: str = "sum") -> list:
        return _collectives().all_reduce(xs, op)

    def reduce(self, xs: Sequence, root: int, op: str = "sum") -> list:
        return _collectives().reduce(xs, root, op)

    def allgather(self, xs: Sequence, tiled: bool = True) -> list:
        return _collectives().all_gather(xs, tiled=tiled)

    def reduce_scatter(self, xs: Sequence) -> list:
        return _collectives().reduce_scatter(xs)

    def alltoall(self, xs: Sequence, split_axis: int = 0,
                 concat_axis: int = 0) -> list:
        return _collectives().all_to_all(xs, split_axis, concat_axis)

    def bcast(self, xs: Sequence, root: int) -> list:
        return _collectives().broadcast(xs, root)

    def scatter(self, xs: Sequence, root: int) -> list:
        return _collectives().scatter(xs, root)

    def gather(self, xs: Sequence, root: int) -> list:
        return _collectives().gather(xs, root)

    def send_recv(self, xs: Sequence, src: int, dst: int) -> list:
        return _collectives().send_recv(xs, src, dst)

    def barrier(self, xs: Sequence) -> list:
        return _collectives().barrier(xs)
