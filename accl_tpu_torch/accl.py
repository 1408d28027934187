"""The ACCL driver: public collective API and call marshaling.

Port of ``accl_tpu/accl.py``, the equivalent of the reference
``ACCL::ACCL`` host driver (driver/xrt/include/accl/accl.hpp:46-1148):
every call builds one call descriptor, syncs operand buffers to the
device, submits it through the request queue, and on completion syncs
results back and checks the engine retcode.  The collective algorithms
live in the engine (backends/cuda.py), as in the reference.

Wire compression: ``compress_dtype`` selects the f16/bf16 cast lanes or
the int8 block-scaled lane (float32 operands only); an armed
:class:`~accl_tpu_torch.arithconfig.CompressionPolicy` (``ACCL_COMPRESS``,
or :meth:`ACCL.set_compression`) selects it automatically.  ``fused=``
(default ``ACCL_FUSED``) puts allreduce, allgather and reduce_scatter on
the chunked ring lane of ``ops/fused.py``.

Left out of this port, and refused where a call asks for them: kernel
streams (``stream_flags``).  Persistent plans, the sanitizer, tuning
tables (and the table route that arms ``fused``), resilience and
observability are not part of it either.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from .arithconfig import (
    COMPRESS_OFF_TOKENS,
    DEFAULT_ARITH_CONFIG,
    compress_block_from_env,
    compression_policy_from_env,
    int8_block_config,
)
from .backends.base import CCLODevice
from .buffer import BaseBuffer, DummyBuffer
from .communicator import Communicator, Rank
from .constants import (
    DATA_TYPE_SIZE,
    DEFAULT_EAGER_RX_BUF_SIZE,
    DEFAULT_EAGER_RX_BUFS,
    DEFAULT_MAX_RENDEZVOUS_SIZE,
    TAG_ANY,
    TUNING_KEY_NAMES,
    ACCLError,
    CCLOCall,
    CfgFunc,
    CompressionFlags,
    DataType,
    Operation,
    ReduceFunction,
    StreamFlags,
    TuningKey,
    unknown_tuning_key_error,
)
from .request import Request, RequestQueue
from .utils.logging import get_logger

GLOBAL_COMM = 0  # id of the world communicator


def default_timeout() -> int:
    """Default engine receive budget in µs (``ACCL_DEFAULT_TIMEOUT``,
    reference default 1e6, accl.cpp:1112)."""
    raw = os.environ.get("ACCL_DEFAULT_TIMEOUT", "1000000")
    try:
        return int(float(raw))
    except ValueError as e:
        raise ACCLError(f"ACCL_DEFAULT_TIMEOUT={raw!r} is not a number") from e


class ACCL:
    """One rank's handle on the collective engine: construct with a
    backend device, :meth:`initialize` with the rank table, then call
    collectives."""

    def __init__(self, device: CCLODevice):
        self._device = device
        self._queue = RequestQueue()
        self._communicators: list[Communicator] = []
        self._arith_ids: dict[tuple[DataType, DataType], int] = {}
        self._initialized = False
        self.max_eager_size = DEFAULT_EAGER_RX_BUF_SIZE
        self.max_rendezvous_size = DEFAULT_MAX_RENDEZVOUS_SIZE
        #: host-side wait budget for synchronous calls
        self.call_timeout_s: float = 60.0
        self.engine_timeout_us: int = default_timeout()
        self._last_request: Optional[Request] = None
        # descriptor memo: _build is a pure function of its scalar args and
        # of each buffer's (address, dtype, host-only), so a training
        # loop's repeated call costs one dict hit; bounded LRU
        self._call_memo: OrderedDict = OrderedDict()
        self._call_memo_cap = 512
        self._async_pending: list = []
        #: the int8 pair's error-feedback twin: (uncompressed, compressed)
        #: -> arithcfg id, filled at initialize
        self._arith_ids_ef: dict[tuple[DataType, DataType], int] = {}
        #: wire-compression policy (arithconfig.CompressionPolicy), armed
        #: at initialize from ACCL_COMPRESS or by set_compression; None
        #: leaves every call's compress_dtype as the caller gave it
        self._compress_policy = None
        #: fused-lane default for calls that pass fused=None
        #: (ACCL_FUSED, read once here)
        self._fused_default = os.environ.get("ACCL_FUSED", "0") \
            not in ("", "0")

    # ------------------------------------------------------------------
    # bring-up (reference accl.cpp:1082-1130)
    # ------------------------------------------------------------------
    def initialize(self, ranks: Sequence[Rank], local_rank: int,
                   n_egr_rx_bufs: int = DEFAULT_EAGER_RX_BUFS,
                   egr_rx_buf_size: int = DEFAULT_EAGER_RX_BUF_SIZE,
                   max_eager_size: Optional[int] = None,
                   max_rendezvous_size: int = DEFAULT_MAX_RENDEZVOUS_SIZE,
                   timeout: Optional[int] = None) -> None:
        """Soft reset, rx pool, world communicator, arithmetic configs
        (with the int8 pair and its error-feedback twin, block from
        ``ACCL_COMPRESS_BLOCK``), timeout and thresholds, static tuning,
        the ``ACCL_COMPRESS`` policy, enable (reference order)."""
        if self._initialized:
            raise ACCLError("ACCL already initialized")
        self._config_call(CfgFunc.reset_periph)
        self._device.setup_rx_buffers(n_egr_rx_bufs, egr_rx_buf_size)
        comm = Communicator(list(ranks), local_rank, comm_id=GLOBAL_COMM)
        self._device.upload_communicator(comm)
        self._communicators = [comm]
        for key, cfg in DEFAULT_ARITH_CONFIG.items():
            self._arith_ids[key] = self._device.upload_arithconfig(cfg)
        block = compress_block_from_env()
        i8_pair = (DataType.float32, DataType.int8)
        self._arith_ids[i8_pair] = self._device.upload_arithconfig(
            int8_block_config(block))
        self._arith_ids_ef = {i8_pair: self._device.upload_arithconfig(
            int8_block_config(block, error_feedback=True))}
        self._call_memo.clear()
        if timeout is None:
            timeout = default_timeout()
        self.set_timeout(timeout)
        self.set_max_eager_msg_size(
            egr_rx_buf_size if max_eager_size is None else max_eager_size)
        self.set_max_rendezvous_msg_size(max_rendezvous_size)
        self.apply_static_tuning()
        # an explicit ACCL_COMPRESS=0 disarms; unset leaves it disarmed
        raw_compress = os.environ.get("ACCL_COMPRESS", "").strip().lower()
        if raw_compress in COMPRESS_OFF_TOKENS:
            self.set_compression(None)
        else:
            env_compress = compression_policy_from_env()
            if env_compress is not None:
                self.set_compression(env_compress)
        self._config_call(CfgFunc.enable_pkt)
        self._initialized = True

    # ------------------------------------------------------------------
    # properties / config
    # ------------------------------------------------------------------
    @property
    def device(self) -> CCLODevice:
        return self._device

    @property
    def comm(self) -> Communicator:
        return self._communicators[GLOBAL_COMM]

    @property
    def rank(self) -> int:
        return self.comm.local_rank

    @property
    def size(self) -> int:
        return self.comm.size

    def communicator(self, comm_id: int) -> Communicator:
        """The communicator for an id, or an ACCLError naming the id."""
        if isinstance(comm_id, int) and 0 <= comm_id < len(self._communicators):
            comm = self._communicators[comm_id]
            if comm.is_placeholder:
                raise ACCLError(f"communicator {comm_id} is a placeholder "
                                f"slot: this rank is not a member")
            return comm
        if not self._communicators:
            raise ACCLError(f"unknown communicator id {comm_id!r}: driver "
                            f"not initialized (call initialize() first)")
        raise ACCLError(f"unknown communicator id {comm_id!r}: this rank has "
                        f"ids 0..{len(self._communicators) - 1}")

    def arithcfg_id(self, uncompressed: DataType,
                    compressed: Optional[DataType] = None) -> int:
        pair = (uncompressed, uncompressed if compressed is None else compressed)
        try:
            return self._arith_ids[pair]
        except KeyError:
            raise ACCLError(f"no arithmetic config for dtype pair {pair}") \
                from None

    def create_communicator(self, indices: Sequence[int]) -> int:
        """Sub-communicator from global-rank indices; returns its id
        (reference accl.cpp:971-978).  Every member creates its
        sub-communicators in the same order, so ids align across ranks."""
        size = self.comm.size
        bad = [i for i in indices if not 0 <= i < size]
        if bad:
            raise ACCLError(f"create_communicator: rank indices {bad} outside "
                            f"the world (size {size})")
        new_id = len(self._communicators)
        sub = self.comm.split(indices, new_id)
        self._device.upload_communicator(sub)
        self._communicators.append(sub)
        return new_id

    def reserve_communicator(self) -> int:
        """Burn one communicator id with a placeholder slot, so a group
        this rank is not a member of gets the same id on its members (the
        engine's communicator table is shared by the world)."""
        cid = len(self._communicators)
        self._communicators.append(Communicator.placeholder(cid))
        return cid

    def set_max_eager_msg_size(self, nbytes: int) -> None:
        self._config_call(CfgFunc.set_max_eager_msg_size, value=nbytes)
        self.max_eager_size = nbytes

    def set_max_rendezvous_msg_size(self, nbytes: int) -> None:
        self._config_call(CfgFunc.set_max_rendezvous_msg_size, value=nbytes)
        self.max_rendezvous_size = nbytes

    def set_timeout(self, timeout: int) -> None:
        self._config_call(CfgFunc.set_timeout, value=timeout)
        self.engine_timeout_us = int(timeout)

    def static_tuning(self) -> dict:
        """Static tuning-register values (reference
        configure_tuning_parameters, accl.cpp:1214-1224)."""
        return {
            int(TuningKey.GATHER_FLAT_TREE_MAX_FANIN): 2,
            int(TuningKey.GATHER_FLAT_TREE_MAX_COUNT): 32 * 1024,
            int(TuningKey.BCAST_FLAT_TREE_MAX_RANKS): 3,
            int(TuningKey.REDUCE_FLAT_TREE_MAX_RANKS): 4,
            int(TuningKey.REDUCE_FLAT_TREE_MAX_COUNT):
                min(self.max_rendezvous_size // 4, 32 * 1024),
        }

    def apply_static_tuning(self) -> None:
        for key, value in self.static_tuning().items():
            self.set_tuning(key, value)

    def set_compression(self, policy) -> None:
        """Arm (or disarm, with ``None``) the wire-compression policy
        (:class:`~accl_tpu_torch.arithconfig.CompressionPolicy`): calls
        that match its collective, dtype and size thresholds get their
        ``compress_dtype`` chosen for them.  Drops the descriptor memo,
        whose entries predate the policy."""
        self._compress_policy = policy
        self._call_memo.clear()

    @property
    def compression_policy(self):
        return self._compress_policy

    def set_tuning(self, key: int, value: int) -> None:
        """Write one tuning register (constants.TuningKey);
        RING_THRESHOLD_BYTES moves the ring/plain crossover."""
        if key not in TUNING_KEY_NAMES:
            raise unknown_tuning_key_error(key)
        self._device.set_tuning(key, value)

    def get_duration(self, request: Optional[Request] = None) -> float:
        """Duration in ns of a completed call (reference accl.cpp:1387)."""
        req = request or self._last_request
        if req is None:
            raise ACCLError("get_duration: no request issued yet")
        if not req.done:
            raise ACCLError(f"get_duration: {req.description or 'request'} "
                            f"(id {req.id}) has not completed")
        return req.duration_ns

    # ------------------------------------------------------------------
    # buffers
    # ------------------------------------------------------------------
    def create_buffer(self, length: int, dtype=np.float32) -> BaseBuffer:
        """A paired host + device buffer of ``length`` elements."""
        return self._device.create_buffer(length, np.dtype(dtype))

    def create_buffer_like(self, data: np.ndarray) -> BaseBuffer:
        data = np.asarray(data)
        buf = self.create_buffer(int(data.size), data.dtype)
        buf.host[:] = data.reshape(-1)
        return buf

    # ------------------------------------------------------------------
    # collectives — each mirrors one reference entry point in accl.cpp
    # ------------------------------------------------------------------
    def send(self, srcbuf: BaseBuffer, count: int, dst: int, tag: int = TAG_ANY,
             comm_id: int = GLOBAL_COMM, from_fpga: bool = False,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM,
             compress_dtype: Optional[DataType] = None, run_async: bool = False):
        """Point-to-point send (reference accl.cpp:138)."""
        call = self._build(Operation.send, count, comm_id, root_src_dst=dst,
                           tag=tag, op0=srcbuf, stream_flags=stream_flags,
                           compress_dtype=compress_dtype)
        return self._execute(call, [] if from_fpga else [(srcbuf, count)], [],
                             run_async, f"send(dst={dst})")

    def recv(self, dstbuf: BaseBuffer, count: int, src: int, tag: int = TAG_ANY,
             comm_id: int = GLOBAL_COMM, to_fpga: bool = False,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM,
             compress_dtype: Optional[DataType] = None, run_async: bool = False):
        """Point-to-point receive (reference accl.cpp:252)."""
        call = self._build(Operation.recv, count, comm_id, root_src_dst=src,
                           tag=tag, res=dstbuf, stream_flags=stream_flags,
                           compress_dtype=compress_dtype)
        return self._execute(call, [], [] if to_fpga else [(dstbuf, count)],
                             run_async, f"recv(src={src})")

    def copy(self, srcbuf: BaseBuffer, dstbuf: BaseBuffer, count: int,
             from_fpga: bool = False, to_fpga: bool = False,
             run_async: bool = False):
        """Local device-side copy (reference accl.cpp:310)."""
        call = self._build(Operation.copy, count, GLOBAL_COMM, op0=srcbuf,
                           res=dstbuf)
        return self._execute(call, [] if from_fpga else [(srcbuf, count)],
                             [] if to_fpga else [(dstbuf, count)],
                             run_async, "copy")

    def combine(self, count: int, function: ReduceFunction, op0: BaseBuffer,
                op1: BaseBuffer, res: BaseBuffer, from_fpga: bool = False,
                to_fpga: bool = False, run_async: bool = False):
        """Local elementwise reduction of two buffers (reference
        accl.cpp:378)."""
        call = self._build(Operation.combine, count, GLOBAL_COMM,
                           function=int(function), op0=op0, op1=op1, res=res)
        return self._execute(call,
                             [] if from_fpga else [(op0, count), (op1, count)],
                             [] if to_fpga else [(res, count)],
                             run_async, f"combine({function.name})")

    def bcast(self, buf: BaseBuffer, count: int, root: int,
              comm_id: int = GLOBAL_COMM, from_fpga: bool = False,
              to_fpga: bool = False, compress_dtype: Optional[DataType] = None,
              run_async: bool = False):
        """Broadcast from root (reference accl.cpp:418)."""
        is_root = self.communicator(comm_id).local_rank == root
        call = self._build(Operation.bcast, count, comm_id, root_src_dst=root,
                           op0=buf if is_root else None,
                           res=None if is_root else buf,
                           compress_dtype=compress_dtype)
        sync_in = [(buf, count)] if (is_root and not from_fpga) else []
        sync_out = [(buf, count)] if (not is_root and not to_fpga) else []
        return self._execute(call, sync_in, sync_out, run_async,
                             f"bcast(root={root})")

    def scatter(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer, count: int,
                root: int, comm_id: int = GLOBAL_COMM, from_fpga: bool = False,
                to_fpga: bool = False, compress_dtype: Optional[DataType] = None,
                run_async: bool = False):
        """Scatter ``count`` elements to each rank from root (reference
        accl.cpp:464)."""
        comm = self.communicator(comm_id)
        is_root = comm.local_rank == root
        call = self._build(Operation.scatter, count, comm_id, root_src_dst=root,
                           op0=sendbuf if is_root else None, res=recvbuf,
                           compress_dtype=compress_dtype,
                           op0_dtype=(sendbuf.data_type if sendbuf is not None
                                      else None))
        sync_in = ([(sendbuf, count * comm.size)]
                   if (is_root and not from_fpga) else [])
        return self._execute(call, sync_in,
                             [] if to_fpga else [(recvbuf, count)],
                             run_async, f"scatter(root={root})")

    def gather(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer, count: int,
               root: int, comm_id: int = GLOBAL_COMM, from_fpga: bool = False,
               to_fpga: bool = False, compress_dtype: Optional[DataType] = None,
               run_async: bool = False):
        """Gather ``count`` elements from each rank at root (reference
        accl.cpp:513)."""
        comm = self.communicator(comm_id)
        is_root = comm.local_rank == root
        call = self._build(Operation.gather, count, comm_id, root_src_dst=root,
                           op0=sendbuf, res=recvbuf if is_root else None,
                           compress_dtype=compress_dtype,
                           res_dtype=(recvbuf.data_type if recvbuf is not None
                                      else None))
        sync_out = ([(recvbuf, count * comm.size)]
                    if (is_root and not to_fpga) else [])
        return self._execute(call, [] if from_fpga else [(sendbuf, count)],
                             sync_out, run_async, f"gather(root={root})")

    def allgather(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer, count: int,
                  comm_id: int = GLOBAL_COMM, from_fpga: bool = False,
                  to_fpga: bool = False,
                  compress_dtype: Optional[DataType] = None,
                  run_async: bool = False, fused: Optional[bool] = None):
        """All-gather (reference accl.cpp:571)."""
        comm = self.communicator(comm_id)
        call = self._build(Operation.allgather, count, comm_id, op0=sendbuf,
                           res=recvbuf, compress_dtype=compress_dtype,
                           fused=fused)
        return self._execute(call, [] if from_fpga else [(sendbuf, count)],
                             [] if to_fpga else [(recvbuf, count * comm.size)],
                             run_async, "allgather")

    def reduce(self, sendbuf: Optional[BaseBuffer],
               recvbuf: Optional[BaseBuffer], count: int, root: int,
               function: ReduceFunction = ReduceFunction.SUM,
               comm_id: int = GLOBAL_COMM, from_fpga: bool = False,
               to_fpga: bool = False, compress_dtype: Optional[DataType] = None,
               stream_flags: StreamFlags = StreamFlags.NO_STREAM,
               run_async: bool = False):
        """Rooted reduction (reference accl.cpp:627-794)."""
        is_root = self.communicator(comm_id).local_rank == root
        call = self._build(Operation.reduce, count, comm_id, root_src_dst=root,
                           function=int(function), op0=sendbuf,
                           res=recvbuf if is_root else None,
                           stream_flags=stream_flags,
                           compress_dtype=compress_dtype,
                           res_dtype=(recvbuf.data_type if recvbuf is not None
                                      else None))
        sync_out = [(recvbuf, count)] if (is_root and not to_fpga) else []
        return self._execute(call, [] if from_fpga else [(sendbuf, count)],
                             sync_out, run_async,
                             f"reduce(root={root},{function.name})")

    def allreduce(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer, count: int,
                  function: ReduceFunction = ReduceFunction.SUM,
                  comm_id: int = GLOBAL_COMM, from_fpga: bool = False,
                  to_fpga: bool = False,
                  compress_dtype: Optional[DataType] = None,
                  run_async: bool = False, fused: Optional[bool] = None):
        """All-reduce (reference accl.cpp:796)."""
        call = self._build(Operation.allreduce, count, comm_id,
                           function=int(function), op0=sendbuf, res=recvbuf,
                           compress_dtype=compress_dtype, fused=fused)
        return self._execute(call, [] if from_fpga else [(sendbuf, count)],
                             [] if to_fpga else [(recvbuf, count)],
                             run_async, f"allreduce({function.name})")

    def reduce_scatter(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
                       count: int,
                       function: ReduceFunction = ReduceFunction.SUM,
                       comm_id: int = GLOBAL_COMM, from_fpga: bool = False,
                       to_fpga: bool = False,
                       compress_dtype: Optional[DataType] = None,
                       run_async: bool = False, fused: Optional[bool] = None):
        """Reduce-scatter: each rank ends with ``count`` reduced elements
        (reference accl.cpp:844)."""
        comm = self.communicator(comm_id)
        call = self._build(Operation.reduce_scatter, count, comm_id,
                           function=int(function), op0=sendbuf, res=recvbuf,
                           compress_dtype=compress_dtype, fused=fused)
        return self._execute(call,
                             [] if from_fpga else [(sendbuf, count * comm.size)],
                             [] if to_fpga else [(recvbuf, count)],
                             run_async, f"reduce_scatter({function.name})")

    def alltoall(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer, count: int,
                 comm_id: int = GLOBAL_COMM, from_fpga: bool = False,
                 to_fpga: bool = False, run_async: bool = False):
        """All-to-all personalized exchange (reference accl.cpp:892)."""
        n = count * self.communicator(comm_id).size
        call = self._build(Operation.alltoall, count, comm_id, op0=sendbuf,
                           res=recvbuf)
        return self._execute(call, [] if from_fpga else [(sendbuf, n)],
                             [] if to_fpga else [(recvbuf, n)],
                             run_async, "alltoall")

    def barrier(self, comm_id: int = GLOBAL_COMM, run_async: bool = False):
        """Barrier over the communicator (reference accl.cpp:947)."""
        call = self._build(Operation.barrier, 0, comm_id)
        return self._execute(call, [], [], run_async, "barrier")

    def nop(self, run_async: bool = False):
        call = self._build(Operation.nop, 0, GLOBAL_COMM)
        return self._execute(call, [], [], run_async, "nop")

    # ------------------------------------------------------------------
    # marshaling (reference accl.cpp:1252-1372 prepare_call)
    # ------------------------------------------------------------------
    def _build(self, scenario: Operation, count: int, comm_id: int,
               root_src_dst: int = 0, function: int = 0, tag: int = TAG_ANY,
               op0: Optional[BaseBuffer] = None,
               op1: Optional[BaseBuffer] = None,
               res: Optional[BaseBuffer] = None,
               stream_flags: StreamFlags = StreamFlags.NO_STREAM,
               compress_dtype: Optional[DataType] = None,
               op0_dtype: Optional[DataType] = None,
               res_dtype: Optional[DataType] = None,
               fused: Optional[bool] = None) -> CCLOCall:
        """Build a call descriptor: the arithmetic config from the
        (uncompressed, compressed) dtype pair, per-operand and wire
        compression flags, dummies for absent operands — the reference's
        flag algebra (accl.cpp:1252-1372), memoized.  Every rank of a
        collective derives the same config and wire flag; absent operands
        contribute dtype hints (op0_dtype/res_dtype)."""
        if (comm_id < 0 or comm_id >= len(self._communicators)) and \
                (self._communicators or comm_id != GLOBAL_COMM):
            self.communicator(comm_id)  # raises the naming ACCLError
        if stream_flags != StreamFlags.NO_STREAM:
            raise ACCLError("kernel streams (stream_flags) are not part of "
                            "accl_tpu_torch yet")

        def _bkey(b):
            return None if b is None else (b.address, b.data_type,
                                           b.is_host_only)

        # fused=None resolves to the driver default before the lookup, so
        # two calls that differ only in fused never share a descriptor
        fused = self._fused_default if fused is None else bool(fused)
        memo_key = (scenario, count, comm_id, root_src_dst, function, tag,
                    _bkey(op0), _bkey(op1), _bkey(res), compress_dtype,
                    op0_dtype, res_dtype, fused)
        cached = self._call_memo.get(memo_key)
        if cached is not None:
            self._call_memo.move_to_end(memo_key)
            return cached

        dummy = DummyBuffer()
        op0 = op0 if op0 is not None else dummy
        op1 = op1 if op1 is not None else dummy
        res = res if res is not None else dummy
        dtypes = {b.data_type for b in (op0, op1, res) if not b.is_dummy}
        if op0.is_dummy and op0_dtype is not None:
            dtypes.add(op0_dtype)
        if res.is_dummy and res_dtype is not None:
            dtypes.add(res_dtype)
        dtypes.discard(DataType.none)
        compression = CompressionFlags.NO_COMPRESSION

        # the armed policy fills in compress_dtype for eligible calls the
        # caller left unset; mixed-dtype calls are never auto-compressed
        if compress_dtype is None and self._compress_policy is not None \
                and len(dtypes) == 1:
            compress_dtype = self._compress_policy.select(
                scenario, count, comm_id, next(iter(dtypes)))

        def flag_operands(compressed_dtype: DataType) -> CompressionFlags:
            flags = CompressionFlags.NO_COMPRESSION
            if not op0.is_dummy and op0.data_type == compressed_dtype:
                flags |= CompressionFlags.OP0_COMPRESSED
            if not op1.is_dummy and op1.data_type == compressed_dtype:
                flags |= CompressionFlags.OP1_COMPRESSED
            if not res.is_dummy and res.data_type == compressed_dtype:
                flags |= CompressionFlags.RES_COMPRESSED
            return flags

        if compress_dtype is None:
            if len(dtypes) <= 1:
                # homogeneous operands: identity pair (accl.cpp:1297-1307)
                dtype = dtypes.pop() if dtypes else DataType.float32
                pair = (dtype, dtype)
                if pair not in self._arith_ids and scenario not in (
                        Operation.config, Operation.nop, Operation.barrier):
                    raise ACCLError(f"unsupported dtype {dtype!r}")
                arithcfg = self._arith_ids.get(pair, 0)
            elif len(dtypes) == 2:
                # operand compression without wire compression: the
                # narrower dtype is the compressed form (accl.cpp:1310-1335)
                d1, d2 = sorted(dtypes, key=lambda d: DATA_TYPE_SIZE[d])
                pair = (d2, d1)
                if pair not in self._arith_ids:
                    raise ACCLError(f"no arithmetic config for dtype pair {pair}")
                arithcfg = self._arith_ids[pair]
                compression = flag_operands(d1)
            else:
                raise ACCLError(f"unsupported dtype combination: {dtypes}")
        else:
            # wire compression requested (accl.cpp:1338-1367)
            operand_dtypes = dtypes - {compress_dtype}
            if len(operand_dtypes) > 1:
                raise ACCLError(f"unsupported dtype combination: {dtypes}")
            uncompressed = (operand_dtypes.pop() if operand_dtypes
                            else compress_dtype)
            if uncompressed == compress_dtype:
                pair = (uncompressed, uncompressed)
                if pair not in self._arith_ids:
                    raise ACCLError(f"unsupported dtype {uncompressed!r}")
                arithcfg = self._arith_ids[pair]
                compression = CompressionFlags.ETH_COMPRESSED
            elif compress_dtype == DataType.int8:
                # block-scaled lane: its wire form (int8, per-block fp32
                # scales) has no flat-buffer residence, so no operand may
                # be int8-typed and the ETH flag stands alone
                pair = (uncompressed, compress_dtype)
                if pair not in self._arith_ids:
                    raise ACCLError(f"no arithmetic config for dtype pair {pair}")
                if uncompressed != DataType.float32:
                    raise ACCLError(
                        f"int8 block-scaled wire lane supports float32 "
                        f"operands only (got {uncompressed.name})")
                if any(not b.is_dummy and b.data_type == DataType.int8
                       for b in (op0, op1, res)):
                    raise ACCLError(
                        "int8 block-scaled wire lane: operands must be "
                        "float32 — a flat int8 buffer cannot hold the "
                        "(int8, per-block scale) wire representation")
                use_ef = (self._compress_policy is not None
                          and self._compress_policy.wants_error_feedback(
                              comm_id))
                arithcfg = (self._arith_ids_ef[pair] if use_ef
                            else self._arith_ids[pair])
                compression = CompressionFlags.ETH_COMPRESSED
            else:
                pair = (uncompressed, compress_dtype)
                if pair not in self._arith_ids:
                    raise ACCLError(f"no arithmetic config for dtype pair {pair}")
                arithcfg = self._arith_ids[pair]
                compression = (CompressionFlags.ETH_COMPRESSED
                               | flag_operands(compress_dtype))

        call = CCLOCall(scenario=scenario, count=count, comm=comm_id,
                        root_src_dst=root_src_dst, function=function, tag=tag,
                        arithcfg=arithcfg, compression_flags=compression,
                        stream_flags=stream_flags, addr_0=op0.address,
                        addr_1=op1.address, addr_2=res.address, fused=fused)
        self._call_memo[memo_key] = call
        while len(self._call_memo) > self._call_memo_cap:
            self._call_memo.popitem(last=False)
        return call

    def _config_call(self, func: CfgFunc, value: int = 0) -> None:
        call = CCLOCall(scenario=Operation.config, count=value,
                        function=int(func))
        req = Request(f"config({func.name})")
        self._queue.submit(req, lambda r: self._device.start(call, r))
        if not req.wait(timeout=30.0):
            raise ACCLError(f"config({func.name}) timed out")
        req.check()

    def _execute(self, call: CCLOCall, sync_in: list, sync_out: list,
                 run_async: bool, desc: str):
        """Sync inputs, submit, and either return the request or wait,
        sync outputs and check the retcode (reference call_async /
        call_sync, accl.cpp:1395-1413)."""
        for buf, count in (*sync_in, *sync_out):
            if not buf.is_dummy and count > buf.length:
                raise ACCLError(f"{desc}: count {count} exceeds buffer "
                                f"length {buf.length}")
        for buf, count in sync_in:
            if not buf.is_dummy:
                buf.slice(0, count).sync_to_device()
        req = Request(desc, sync=not run_async)
        if sync_out:
            def finish(r: Request) -> None:
                if r.retcode == 0:
                    for buf, count in sync_out:
                        if not buf.is_dummy:
                            buf.slice(0, count).sync_from_device()

            req.on_complete = finish
        self._queue.submit(req, lambda r: self._device.start(call, r))
        self._last_request = req
        if run_async:
            import weakref

            self._async_pending.append(weakref.ref(req))
            if len(self._async_pending) > 256:
                self._async_pending = [ref for ref in self._async_pending
                                       if (r := ref()) is not None
                                       and not r.done]
            return req
        if not req.wait(timeout=self.call_timeout_s):
            req.on_complete = None
            raise ACCLError(f"{desc} timed out waiting for engine completion")
        req.check()
        return req

    def dump_communicator(self, comm_id: int = GLOBAL_COMM) -> str:
        return self.communicator(comm_id).dump()

    def deinit(self) -> None:
        """Tear down the backend; async requests still in flight are
        named in the log first."""
        pending = [r for ref in self._async_pending
                   if (r := ref()) is not None and not r.done]
        if pending:
            rank = (self._communicators[GLOBAL_COMM].local_rank
                     if self._communicators else None)
            log = get_logger(rank=rank)
            log.warning("deinit with %d async request(s) still pending",
                        len(pending))
            for r in pending:
                log.warning("  pending: %s (id %d)", r.description, r.id)
        self._async_pending.clear()
        self._device.close()

    def __enter__(self) -> "ACCL":
        return self

    def __exit__(self, *exc) -> None:
        self.deinit()
