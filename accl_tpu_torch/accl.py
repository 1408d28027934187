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

Observability (accl_tpu/accl.py:308-342, 1652-1672, 1765-1830): each
rank registers an always-on flight recorder at initialize, which also
starts the OpenMetrics exporter when ``ACCL_METRICS_PORT`` is set, the
regression sentinel when ``ACCL_SENTINEL`` is set and the per-tenant SLO
tracker when ``ACCL_SLO`` is set (unset, neither is constructed); every
call attaches its flight record, metrics signature and (under
``ACCL_TRACE``) trace span, each carrying the tenant label of the
issuing communicator (``create_communicator(tenant=)``, ``set_tenant``);
``metrics()``, ``dump_metrics()`` and ``dump_flight_recorder()`` read
them back.

Persistent plans (accl_tpu/accl.py:697-870; plans.py): ``capture_plan``
records a function's calls, validates them with the sanitizer's
checkers and arms them on the engine's plan ring; ``ACCL_PLAN_AUTO``
arms a one-step ring after N identical resident sync gang calls.  The
collective sanitizer (``ACCL_SANITIZE``, analysis/sanitizer.py) checks
each call before dispatch.  Each lane costs ``_execute`` one falsy read
when off.

Left out of this port, and refused where a call asks for them: kernel
streams (``stream_flags``).  Tuning tables (and the table route that
arms ``fused``) and resilience (so no abort, shrink, grow or reset fence
events reach the flight recorder, and no plan is fenced by one) are not
part of it either.
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from . import plans as _plans
from .analysis import sanitizer as _san
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
    GANG_OPERATIONS,
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
    ErrorCode,
    Operation,
    ReduceFunction,
    StreamFlags,
    TuningKey,
    unknown_tuning_key_error,
)
from .observability import flight as _flight
from .observability import health as _health
from .observability import metrics as _metrics
from .observability import sentinel as _sentinel
from .observability import slo as _slo
from .observability import trace as _trace
from .request import Request, RequestQueue
from .utils.logging import get_logger

GLOBAL_COMM = 0  # id of the world communicator

#: a tenant name: it becomes a metric label value and a trace track name
_TENANT_NAME = re.compile(r"[A-Za-z0-9_.\-]{1,64}")


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
        #: arithcfg id -> (uncompressed, compressed) pair: the dtype of a
        #: call's metrics signature
        self._arith_pairs: dict[int, tuple[DataType, DataType]] = {}
        #: always-on per-rank flight recorder, created at initialize;
        #: None under ACCL_FLIGHT=0
        self.flight_recorder: Optional[_flight.FlightRecorder] = None
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
        #: the sanitizer's per-comm gang instance counters (its
        #: cross-rank fingerprint exchange pairs on them)
        self._sanitize_seq: dict = {}
        #: persistent plans (plans.py): weak refs to live plans (a fence
        #: invalidates them), the recorder capture_plan installs while
        #: the captured function runs, and the per-(domain, member-set)
        #: capture counters pooled validation pairs on
        self._plans: list = []
        self._plan_recorder = None
        self._plan_group_seq: dict = {}
        #: ACCL_PLAN_AUTO state (armed at initialize): the streak
        #: threshold, call id -> (call, adopted ring), and the streak
        #: (None = the auto lane is off)
        self._plan_auto = 0
        self._auto_rings: Optional[dict] = None
        self._auto_last = None
        self._auto_streak = 0

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
        self._arith_pairs = {i: pair for pair, i in (
            *self._arith_ids.items(), *self._arith_ids_ef.items())}
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
        # plan auto-capture (ACCL_PLAN_AUTO=N; honors ACCL_PLAN=0), read
        # here so worlds made after an env change see it
        self._plan_auto = _plans.auto_threshold()
        self._auto_rings = {} if self._plan_auto else None
        # observability bring-up: the flight recorder (the rank is known
        # now), with the engine's link rows, stats and gang-assembly
        # table as its receive-timeout forensics, and the OpenMetrics
        # endpoint when ACCL_METRICS_PORT is set
        if _flight.enabled():
            self.flight_recorder = _flight.register(
                _flight.FlightRecorder(local_rank))
            sources = {}
            for attr, key in (("link_stats", "link_rows"),
                              ("engine_stats", "engine_stats"),
                              ("gang_assembly_snapshot", "gang_assembly")):
                fn = getattr(self._device, attr, None)
                if callable(fn):
                    sources[key] = fn
            if sources:
                self.flight_recorder.set_forensics_sources(sources)
        _health.ensure_exporter_from_env()
        _sentinel.ensure_sentinel_from_env()
        _slo.ensure_slo_from_env()

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

    def create_communicator(self, indices: Sequence[int],
                            tenant: Optional[str] = None) -> int:
        """Sub-communicator from global-rank indices; returns its id
        (reference accl.cpp:971-978).  Every member creates its
        sub-communicators in the same order, so ids align across ranks.

        ``tenant`` labels the communicator's traffic for the per-tenant
        observability plane: flight records, ``tenant/<name>`` metric
        families, trace tracks and ``link_matrix(tenant=...)`` slices
        key off it.  The engine never sees it."""
        size = self.comm.size
        bad = [i for i in indices if not 0 <= i < size]
        if bad:
            raise ACCLError(f"create_communicator: rank indices {bad} outside "
                            f"the world (size {size})")
        new_id = len(self._communicators)
        sub = self.comm.split(indices, new_id)
        self._device.upload_communicator(sub)
        self._communicators.append(sub)
        if tenant is not None:
            self.set_tenant(new_id, tenant)
        return new_id

    def set_tenant(self, comm_id: int, tenant: Optional[str]) -> None:
        """Label (or with ``None`` unlabel) a communicator's traffic
        with a tenant name (accl_tpu/accl.py:445-462).  Names are bounded
        and shell-safe (``[A-Za-z0-9_.-]{1,64}``) because they become
        metric label values and trace track names; the registry's
        ACCL_METRICS_MAX_SERIES guard bounds how many distinct names can
        mint series."""
        comm = self.communicator(comm_id)
        if tenant is not None and (
                not isinstance(tenant, str)
                or not _TENANT_NAME.fullmatch(tenant)):
            raise ACCLError(
                f"set_tenant: invalid tenant name {tenant!r} — "
                f"need 1-64 chars of [A-Za-z0-9_.-] (it becomes a "
                f"metric label and trace track name)")
        comm.tenant = tenant

    def tenant_comm_ids(self, tenant: str) -> list:
        """Ids of this rank's communicators labelled ``tenant``: the
        slice ``link_matrix(tenant=...)`` folds over (a tenant's traffic
        is the union of its communicators' link rows)."""
        return [c.id for c in self._communicators
                if not c.is_placeholder and c.tenant == tenant]

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

    # ------------------------------------------------------------------
    # persistent collective plans (plans.py; accl_tpu/accl.py:697-870)
    # ------------------------------------------------------------------
    def capture_plan(self, fn, *args, validate: bool = True,
                     timeout_s: Optional[float] = None):
        """Capture ``fn(self, *args)``'s collective calls into a
        persistent plan: recorded once (the calls still execute, so the
        capture iteration's results are real), validated once (the
        sanitizer's checker suite; an error finding fails the capture
        naming it), armed once on the engine's plan ring, then replayed
        with ``plan.replay()``.  Every gang/p2p peer of the program must
        capture it too.  Under ``ACCL_PLAN=0`` returns an eager plan whose
        replay re-runs ``fn`` through the per-call path."""
        if not _plans.enabled():
            fn(self, *args)  # the capture iteration still executes
            return _plans.EagerPlan(self, fn, args)
        if self._plan_recorder is not None:
            raise ACCLError("capture_plan: a capture is already in "
                            "progress on this driver (no nesting)")
        recorder = _plans.PlanRecorder(self)
        self._plan_recorder = recorder
        try:
            fn(self, *args)
        finally:
            self._plan_recorder = None
        return _plans.build_plan(self, recorder, validate=validate,
                                 timeout_s=timeout_s)

    def _invalidate_plans(self, comm_id: Optional[int],
                          reason: str) -> None:
        """Fence live plans touching ``comm_id`` (None = all): a replay
        after it raises (or, on the auto lane, re-captures), never runs
        the fenced program.  Resilience's abort, reset and membership
        changes call it."""
        live = []
        for ref in self._plans:
            p = ref()
            if p is None:
                continue
            live.append(ref)
            if comm_id is None or comm_id in p.comms:
                p._invalidate(reason)
        self._plans = live
        if self._auto_rings:
            self._auto_rings.clear()
        self._auto_last = None
        self._auto_streak = 0

    def _replay_auto(self, entry, desc: str) -> Optional[Request]:
        """Route one auto-captured call through its plan ring; returns a
        completed Request, or None when the ring was fenced (the caller
        goes on to the eager path, which re-captures)."""
        call, ring = entry
        rec = None
        if self.flight_recorder is not None and _flight.enabled():
            rec = self.flight_recorder.new_record(
                next(_plans._replay_ids), "plan_replay", call.comm,
                call.tag, "plan", call.count, 0, self.comm.size, True,
                _trace.now_ns())
            rec.mark_dispatched("plan", _trace.now_ns())
        try:
            self._device.plan_replay(ring, run_async=False,
                                     timeout_s=self.call_timeout_s)
        except ACCLError as e:
            code = int(getattr(e, "code", 0))
            if rec is not None:
                rec.finish(code or int(ErrorCode.DMA_INTERNAL_ERROR),
                           _trace.now_ns())
            self._auto_rings.pop(id(call), None)
            if code & int(ErrorCode.COMM_ABORTED) \
                    or "invalidated" in str(e):
                return None
            raise
        if rec is not None:
            rec.finish(0, _trace.now_ns())
        if _metrics.enabled():
            _metrics.default_registry().inc("plans/replays")
        req = Request(desc, sync=True)
        req.complete(0, 0.0)
        self._last_request = req
        return req

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
        call_sync, accl.cpp:1395-1413).  ``t_submit`` marks user-call
        entry, so operand staging is inside the submit→queue window;
        the flight recorder is on by default, so the no-observer path
        exists only under ACCL_FLIGHT=0, ACCL_METRICS=0 and no trace.
        The plan and sanitizer lanes sit where accl_tpu/accl.py:1625-1740
        has them, each one falsy read when off."""
        # plan auto-replay (ACCL_PLAN_AUTO): a call whose gang agreed to
        # arm a one-step ring replays through it.  The identity check is
        # sound because _build memoizes: a steady loop passes the SAME
        # CCLOCall object every step
        if self._auto_rings is not None and not run_async:
            entry = self._auto_rings.get(id(call))
            if entry is not None and entry[0] is call \
                    and self._plan_recorder is None and not _san.active():
                replayed = self._replay_auto(entry, desc)
                if replayed is not None:
                    return replayed
        observe = (self.flight_recorder is not None or _metrics.enabled()
                   or _trace.enabled())
        t_submit = _trace.now_ns() if observe else 0
        for buf, count in (*sync_in, *sync_out):
            if not buf.is_dummy and count > buf.length:
                raise ACCLError(f"{desc}: count {count} exceeds buffer "
                                f"length {buf.length}")
        for buf, count in sync_in:
            if not buf.is_dummy:
                buf.slice(0, count).sync_to_device()
        req = Request(desc, sync=not run_async)
        if observe:
            self._observe_call(call, desc, req, t_submit)
        # the sanitizer lane: checks the call (and, in-process, its
        # gang's fingerprints) before dispatch, raising instead of
        # hanging; a shadow CaptureSession records it
        if _san.active():
            _san.on_call(self, call, desc, req, run_async)
        # plan capture in progress: record the descriptor and its
        # staging; the call still executes below
        if self._plan_recorder is not None:
            self._plan_recorder.on_call(call, sync_in, sync_out,
                                        run_async, desc, req)
        # plan auto-capture intent: after N identical resident sync gang
        # calls, mark intent; the engine arms a ring only when EVERY
        # member of the same gang instance carries it
        if self._auto_rings is not None and not run_async \
                and not sync_in and not sync_out \
                and self._plan_recorder is None and not _san.active() \
                and call.scenario in GANG_OPERATIONS:
            if call is self._auto_last:
                self._auto_streak += 1
                if self._auto_streak >= self._plan_auto:
                    req.plan_intent = True
            else:
                self._auto_last = call
                self._auto_streak = 1
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
            # disarm the result sync; the flight record says where the
            # call wedged
            req.on_complete = None
            raise ACCLError(f"{desc} timed out waiting for engine "
                            f"completion{req.flight_info()}")
        req.check()
        # auto-capture adoption: the engine published a ring on this
        # request (every gang member carried intent)
        if self._auto_rings is not None and req.plan_ring is not None:
            self._auto_rings[id(call)] = (call, req.plan_ring)
        return req

    def resolve_call_signature(self, call: CCLOCall) -> tuple:
        """(op, nranks, rank, dtype_name, nbytes) of one descriptor: the
        metrics signature (accl_tpu/accl.py:1740), nbytes the per-rank
        payload in the nccl-tests convention."""
        op = Operation(call.scenario)
        comm = (self._communicators[call.comm]
                if call.comm < len(self._communicators) else None)
        nranks = comm.size if comm else 1
        rank = comm.local_rank if comm else -1
        pair = self._arith_pairs.get(call.arithcfg)
        dtype_name = pair[0].name if pair else "none"
        # DATA_TYPE_SIZE is in bits (reference constants.hpp:268-272)
        elem_bytes = (DATA_TYPE_SIZE.get(pair[0], 0) // 8) if pair else 0
        nbytes = (call.count * elem_bytes
                  * _metrics.payload_factor(op.name, nranks))
        return op, nranks, rank, dtype_name, nbytes

    def _observe_call(self, call: CCLOCall, desc: str, req: Request,
                      t_submit: int) -> None:
        """Attach the call's observability records to its request: the
        flight record, the metrics signature (published by
        Request.complete) and, under tracing, the span with its submit
        stamp and gang id.  The gang-id key is the engine's FIFO pairing
        key (scenario, comm, tag), so rank R's Nth instance gets the id
        of the gang the engine assembles."""
        op, nranks, rank, dtype_name, nbytes = \
            self.resolve_call_signature(call)
        gang = op in GANG_OPERATIONS
        # the issuing communicator's tenant: one attribute read (the
        # class-level None when unlabelled)
        tenant = (self._communicators[call.comm].tenant
                  if call.comm < len(self._communicators) else None)
        if self.flight_recorder is not None and _flight.enabled():
            req.flight = self.flight_recorder.new_record(
                req.id, op.name, call.comm, call.tag, dtype_name,
                call.count, nbytes, nranks, gang, t_submit, tenant)
        if _metrics.enabled():
            req.metric = (_metrics.default_registry(), op.name, dtype_name,
                          nbytes, nranks, t_submit, tenant)
        if _trace.enabled():
            span = _trace.new_span(op.name, desc, rank, call.count,
                                   dtype_name, nbytes, nranks)
            span.t_submit = t_submit
            span.tenant = tenant
            if gang:
                span.gang_id = _trace.collector().gang_id_for(
                    (int(op), call.comm, call.tag), rank)
            req.trace = span

    # ------------------------------------------------------------------
    # observability (accl_tpu/accl.py:1797-1830)
    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        """Snapshot of the process registry every rank publishes into
        (per-(collective, dtype, size-bucket) calls, latency histograms,
        algbw and busbw), with the engine's dispatch-lane counters
        merged under ``engine/`` keys.  Ranks of one world share the
        registry, so the snapshot aggregates them."""
        snap = _metrics.default_registry().snapshot()
        eng = getattr(self._device, "engine_metrics", None)
        if eng is not None:
            for k, v in eng.counters().items():
                snap["counters"][f"engine/{k}"] = v
        return snap

    def dump_metrics(self, as_json: bool = False) -> str:
        """Text (default) or JSON rendering of the registry side of
        :meth:`metrics`."""
        return _metrics.dump_metrics(as_json=as_json)

    def dump_flight_recorder(self, path: Optional[str] = None,
                             merged: bool = False) -> dict:
        """This rank's flight ring (its last N calls with state, lane and
        stamps); with ``merged=True`` every live rank's ring through
        ``merge_flight_dumps`` (desync, hang and straggler analysis);
        with ``path`` the JSON is also written there."""
        if self.flight_recorder is None and not merged:
            raise ACCLError(
                "flight recorder is off (ACCL_FLIGHT=0) or the driver "
                "is not initialized")
        doc = (_flight.dump_all() if merged
               else self.flight_recorder.dump())
        if path:
            import json

            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        return doc

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
                log.warning("  pending: %s%s", r.description or "call",
                            r.flight_info() or f" (id {r.id})")
        self._async_pending.clear()
        self._device.close()

    def __enter__(self) -> "ACCL":
        return self

    def __exit__(self, *exc) -> None:
        self.deinit()
