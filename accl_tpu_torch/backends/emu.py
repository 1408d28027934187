"""Emulator backend: the native C++ collective engine over ctypes.

The port's twin of ``accl_tpu/backends/emu.py``.  The reference's
``SimDevice`` forwards call descriptors and buffer syncs to its
``cclo_emu`` emulator process (driver/xrt/src/simdevice.cpp:38-64); here
the emulator is the in-process native library ``native/libacclemu.so``,
the one the JAX package loads (built by ``native/Makefile``): a per-rank
engine thread runs the collective algorithms against a CPU dataplane and
an inproc, datagram, RDMA-modelled or TCP transport.  It runs on the host
by design and is never a stand-in for a missing card: ``CudaWorld``
stays the default world.

:class:`EmuWorld` is the test harness of the reference's
one-emulator-per-MPI-rank bring-up (test/host/xrt/src/utility.cpp:26-70):
N ranks in one process, per-rank driver code on a thread pool.  It is
the world of the resilience layer (resilience/): retransmission, seeded
chaos, abort with epoch fencing, kill, liveness probes, shrink and the
elastic join (:meth:`EmuWorld.spawn_replacement`, :class:`EmuJoiner`).
:class:`EmuRankTcp` is one rank over the TCP transport.

Teardown order matters (accl_tpu/backends/emu.py:302-318, 1160-1211):
``accl_world_shutdown`` first makes every waiter's FFI wait return, the
device handles are nulled under each device's ``_lifecycle`` lock, the
waiter threads are joined, and only then is the world destroyed.  A
world still open at interpreter exit is closed by an ``atexit`` hook
before the library's static destructors run.
"""
from __future__ import annotations

import atexit
import ctypes
import glob
import os
import subprocess
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

from ..accl import ACCL, default_timeout
from ..arithconfig import ArithConfig
from ..buffer import BaseBuffer, EmuBuffer, EmuBufferP2P
from ..communicator import Communicator, Rank
from ..constants import (
    EMU_TUNING_KEYS,
    ACCLError,
    CCLOCall,
    ErrorCode,
    error_code_to_str,
    unknown_tuning_key_error,
)
from ..observability import flight as _flight
from ..observability import health as _health
from ..observability import metrics as _metrics
from ..observability import telemetry as _telemetry
from ..observability import trace as _trace
from ..request import Request
from ..resilience.chaos import ChaosPlan
from ..resilience.elastic import MembershipBoard, join_grown_world
from ..resilience.retry import RetryPolicy
from ..utils.logging import get_logger
from .base import CCLODevice

#: the native engine's directory, shared with the JAX package
NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native")

_lib = None
_lib_lock = threading.Lock()


def lib_path() -> str:
    """The library to load: ``ACCL_NATIVE_LIB`` when set (a prebuilt
    artifact), else ``native/libacclemu.so``, or its sanitizer twin
    ``libacclemu_<lane>.so`` under ``ACCL_SANITIZER=asan|ubsan|tsan``."""
    lane = os.environ.get("ACCL_SANITIZER", "").strip()
    name = f"libacclemu_{lane}.so" if lane else "libacclemu.so"
    return os.environ.get("ACCL_NATIVE_LIB") or os.path.join(NATIVE_DIR,
                                                             name)


def _build_lib_if_stale(path: str) -> None:
    """Run ``make -C native`` when the library is missing or older than a
    source (accl_tpu/backends/emu.py:54-98).  A build from either package
    takes the same lock file, ``native/.build.lock``, so two ``make`` runs
    never write one .so at once; ``ACCL_NATIVE_LIB`` is never rebuilt."""
    if os.environ.get("ACCL_NATIVE_LIB"):
        return
    sources = (glob.glob(os.path.join(NATIVE_DIR, "src", "*.cpp"))
               + glob.glob(os.path.join(NATIVE_DIR, "src", "*.hpp"))
               + [os.path.join(NATIVE_DIR, "Makefile")])

    def fresh() -> bool:
        if not os.path.exists(path):
            return False
        mtime = os.path.getmtime(path)
        return all(os.path.getmtime(s) <= mtime for s in sources)

    if fresh():
        return
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        try:
            import fcntl

            fcntl.flock(lock, fcntl.LOCK_EX)
        except ImportError:  # non-POSIX: no lock
            pass
        if fresh():  # another process built it while we waited
            return
        # the build must not inherit a sanitizer runtime (under the ASan
        # lane LD_PRELOAD would make LeakSanitizer fail the compiler)
        env = dict(os.environ)
        env.pop("LD_PRELOAD", None)
        env["ASAN_OPTIONS"] = "detect_leaks=0"
        try:
            proc = subprocess.run(["make", "-C", NATIVE_DIR, "-j",
                                   str(os.cpu_count() or 1)],
                                  capture_output=True, text=True, env=env)
        except FileNotFoundError as e:
            raise ACCLError(f"native engine not built and `make` "
                            f"unavailable: {e} (build {path} manually)") from e
        if proc.returncode != 0:
            raise ACCLError(f"native engine build failed:\n{proc.stdout}\n"
                            f"{proc.stderr}")


def _declare(lib: ctypes.CDLL) -> None:
    """The ctypes signatures of every entry point this module calls
    (native/src/capi.cpp)."""
    u64, u32, i32, i64 = (ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int,
                          ctypes.c_longlong)
    p, cp, dbl = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double
    P = ctypes.POINTER
    sigs = {
        "accl_world_create": (p, [i32, u64]),
        "accl_world_create_tcp": (p, [i32, i32, i32, u64]),
        "accl_world_create_dgram": (p, [i32, u64, u32, u32]),
        "accl_world_create_rdma": (p, [i32, u64]),
        "accl_dgram_fault": (i32, [p, u32]),
        "accl_dump_qps": (i32, [p, i32, cp, i32]),
        "accl_world_destroy": (None, [p]),
        "accl_world_shutdown": (None, [p]),
        "accl_cfg_rx": (i32, [p, i32, i32, u64]),
        "accl_set_comm": (i32, [p, i32, P(u32), i32]),
        "accl_set_arithcfg": (i32, [p, i32, P(u32), i32]),
        "accl_set_tuning": (i32, [p, i32, u32, u32]),
        "accl_alloc": (u64, [p, i32, u64, u64]),
        "accl_alloc_host": (u64, [p, i32, u64, u64]),
        "accl_alloc_p2p": (u64, [p, i32, u64, u64]),
        "accl_free": (None, [p, i32, u64]),
        "accl_free_p2p": (None, [p, i32, u64]),
        "accl_mem_ptr": (p, [p, i32, u64, u64]),
        "accl_read_mem": (i32, [p, i32, u64, p, u64]),
        "accl_write_mem": (i32, [p, i32, u64, p, u64]),
        "accl_tx_stats": (None, [p, i32, P(u64), P(u64)]),
        "accl_open_port": (i32, [p, i32]),
        "accl_open_con": (i32, [p, i32, i32]),
        "accl_close_con": (i32, [p, i32, i32]),
        "accl_start_call": (u64, [p, i32, P(u32)]),
        "accl_wait_call": (i32, [p, i32, u64, i32, P(u32), P(dbl)]),
        "accl_push_krnl": (None, [p, i32, p, u64]),
        "accl_pop_stream": (i32, [p, i32, u32, p, u64, P(u64), i32]),
        "accl_dump_rx": (i32, [p, i32, cp, i32]),
        "accl_inject_fault": (i32, [p, i32, u32]),
        # resilience control plane
        "accl_set_resilience": (i32, [p, i32, u32, u32]),
        "accl_abort": (i32, [p, i32, i32, u32]),
        "accl_reset_errors": (i32, [p, i32]),
        "accl_set_chaos": (i32, [p, i32, u64, u32, u32, u32, u32, u32, u32]),
        "accl_chaos_kill": (i32, [p, i32]),
        "accl_probe_liveness": (i32, [p, i32, i32, u32, P(u64)]),
        "accl_resilience_stats": (None, [p, i32, P(u64), P(u64), P(u64),
                                         P(u64)]),
        # elastic membership: the live join
        "accl_world_add_rank": (i32, [p]),
        "accl_join_sync": (i32, [p, i32, u32, i32]),
        "accl_comm_count": (i32, [p, i32]),
        "accl_comm_epoch": (u32, [p, i32, i32]),
        "accl_join_stats": (None, [p, i32, P(u64), P(u64)]),
        # persistent plans: the engine's descriptor ring
        "accl_plan_create": (i32, [p, i32, P(u32), i32]),
        "accl_plan_replay": (i64, [p, i32, i32]),
        "accl_plan_wait": (i32, [p, i32, i64, i32, P(u32), P(dbl)]),
        "accl_plan_invalidate": (i32, [p, i32, i32]),
        "accl_plan_count": (i32, [p, i32]),
        "accl_plan_release": (i32, [p, i32, i32]),
        # wire protocol: raw frames, frame counters, the egress tap
        "accl_engine_ingest_bytes": (i32, [p, i32, cp, u64]),
        "accl_frame_stats": (None, [p, i32, P(u64), P(u64)]),
        "accl_frame_tap": (i32, [p, i32, i32]),
        "accl_frame_tap_drain": (i32, [p, i32, p, i32]),
        # telemetry: the engine stats and the per-link rows
        "accl_engine_stats_version": (i32, []),
        "accl_engine_stats": (i32, [p, i32, P(u64), i32]),
        "accl_engine_link_stats_stride": (i32, []),
        "accl_engine_link_stats": (i32, [p, i32, P(u64), i32]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def load_lib() -> ctypes.CDLL:
    """Build the native engine if it is stale, load it once and declare
    its signatures; a failed build or load raises an ACCLError."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path = lib_path()
            _build_lib_if_stale(path)
            if not os.path.exists(path):
                raise ACCLError(f"native engine not built: {path} missing "
                                f"(run `make -C native`)")
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
    return _lib


def _words(vals: Sequence[int]):
    return (ctypes.c_uint32 * len(vals))(*[v & 0xFFFFFFFF for v in vals])


def _join_waiters(devices, timeout_s: float = 10.0) -> int:
    """Join every waiter thread of ``devices`` (bounded); returns how
    many are still alive.  Called between the world's shutdown (which
    makes their FFI waits return) and its destroy."""
    deadline = time.monotonic() + timeout_s
    stuck = 0
    for d in devices:
        for t in list(d._waiters):
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                stuck += 1
    return stuck


#: worlds still open: closed at interpreter exit, before the library's
#: static destructors run under live engine threads (registered at
#: import, so it runs before concurrent.futures joins its workers)
_live_worlds: "weakref.WeakSet" = weakref.WeakSet()


def _close_live_worlds() -> None:
    for w in list(_live_worlds):
        try:
            w.close()
        except Exception:  # noqa: BLE001 — cleanup at exit never raises
            pass


atexit.register(_close_live_worlds)


class EmuDevice(CCLODevice):
    """One rank's handle on the native engine."""

    #: one-shot egress faults for inject_fault
    FAULT_DROP = 1
    FAULT_DUPLICATE = 2
    FAULT_CORRUPT_SEQ = 3
    FAULT_DELAY = 4

    def __init__(self, world_handle, rank: int, lib: ctypes.CDLL,
                 call_timeout_s: float = 60.0):
        self._w = world_handle
        self._rank = rank
        self._lib = lib
        self._timeout_ms = int(call_timeout_s * 1000)
        # the NACK retransmission lane from ACCL_RETRY_MAX /
        # ACCL_RETRY_BASE_US (a world may override)
        pol = RetryPolicy.from_env()
        self.set_resilience(pol.max_retries, pol.base_us)
        #: True while every rank of the world lives in this process;
        #: EmuRankTcp clears it (the in-process sanitizer exchange cannot
        #: pair its peers)
        self.shares_process_world = True
        #: frame counters already published to the registry
        self._frames_published: dict = {}
        #: live waiter threads, one per call in flight: the world's close
        #: joins them after shutdown and before destroy
        self._waiters: set = set()
        #: serializes submission against close(): start() snapshots the
        #: handle, submits and registers its waiter under it; close()
        #: nulls the handle under it, so no stale handle outlives the world
        self._lifecycle = threading.Lock()

    def sanitizer_domain(self):
        """The native world handle: one EmuWorld is one sanitizer domain."""
        if self.shares_process_world and self._w:
            return ("emu", int(self._w))
        return None

    # -- call path -------------------------------------------------------
    def start(self, call: CCLOCall, request: Request) -> None:
        # the engine owns everything below this point, so the span's
        # device window is descriptor post -> engine completion
        span = request.trace
        rec = request.flight
        if rec is not None:
            rec.mark_dispatched("emu", _trace.now_ns())
        if span is not None:
            span.lane = "emu"
            span.t_dispatch = span.t_device_begin = _trace.now_ns()

        def waiter():
            try:
                ret = ctypes.c_uint32(0)
                dur = ctypes.c_double(0.0)
                ok = self._lib.accl_wait_call(world, self._rank, call_id,
                                              self._timeout_ms,
                                              ctypes.byref(ret),
                                              ctypes.byref(dur))
                if span is not None:
                    span.t_device_end = _trace.now_ns()
                if ok:
                    request.complete(ret.value, dur.value)
                else:
                    get_logger("accl_tpu_torch.emu", rank=self._rank).warning(
                        "engine wait timed out after %d ms: %s%s",
                        self._timeout_ms, request.description,
                        request.flight_info())
                    request.complete(int(ErrorCode.DMA_TIMEOUT_ERROR), 0.0)
            finally:
                self._waiters.discard(threading.current_thread())

        with self._lifecycle:
            world = self._w
            if world is None:
                request.complete(int(ErrorCode.COMM_ABORTED
                                     | ErrorCode.RANK_FAILED), 0.0)
                return
            call_id = self._lib.accl_start_call(world, self._rank,
                                                _words(call.to_words()))
            # started under the lock, so close() never finds a waiter it
            # cannot join yet
            t = threading.Thread(target=waiter, daemon=True)
            self._waiters.add(t)
            t.start()

    # -- device memory ---------------------------------------------------
    def alloc_mem(self, nbytes: int, alignment: int = 64) -> int:
        addr = self._lib.accl_alloc(self._w, self._rank, nbytes, alignment)
        if addr == 0:
            raise ACCLError("emulator device memory exhausted")
        return addr

    def free_mem(self, address: int) -> None:
        self._lib.accl_free(self._w, self._rank, address)

    def free_mem_p2p(self, address: int) -> None:
        self._lib.accl_free_p2p(self._w, self._rank, address)

    def read_mem(self, address: int, nbytes: int) -> bytes:
        buf = ctypes.create_string_buffer(nbytes)
        if self._lib.accl_read_mem(self._w, self._rank, address, buf,
                                   nbytes) != 0:
            raise ACCLError(f"read_mem({address:#x}, {nbytes}) out of range")
        return buf.raw

    def write_mem(self, address: int, data: bytes) -> None:
        if self._lib.accl_write_mem(self._w, self._rank, address, data,
                                    len(data)) != 0:
            raise ACCLError(f"write_mem({address:#x}, {len(data)}) out of "
                            f"range")

    # -- buffers ---------------------------------------------------------
    def create_buffer(self, length: int, dtype: np.dtype,
                      host_only: bool = False) -> BaseBuffer:
        host = np.zeros(length, dtype=dtype)
        if host_only:
            addr = self._lib.accl_alloc_host(self._w, self._rank,
                                             max(host.nbytes, 64), 64)
            if addr == 0:
                raise ACCLError("emulator host-buffer region exhausted")
            return EmuBuffer(host, self, addr, host_only=True)
        return EmuBuffer(host, self, self.alloc_mem(max(host.nbytes, 64)))

    def create_buffer_p2p(self, length: int, dtype: np.dtype) -> BaseBuffer:
        """A peer-addressable buffer (reference FPGABufferP2P): its host
        array maps the engine's memory, and an in-process peer's
        rendezvous write lands in it by a direct copy."""
        nbytes = max(int(np.dtype(dtype).itemsize) * length, 64)
        addr = self._lib.accl_alloc_p2p(self._w, self._rank, nbytes, 64)
        if addr == 0:
            raise ACCLError("emulator device memory exhausted (p2p)")
        ptr = self._lib.accl_mem_ptr(self._w, self._rank, addr, nbytes)
        if not ptr:
            raise ACCLError("p2p mapping failed")
        raw = (ctypes.c_uint8 * nbytes).from_address(ptr)
        return EmuBufferP2P(np.frombuffer(raw, dtype=dtype, count=length),
                            self, addr)

    # -- sessions (reference open_port/open_con/close_con): TCP worlds
    # connect and tear down, the other transports succeed as no-ops ------
    def open_port(self) -> int:
        return int(self._lib.accl_open_port(self._w, self._rank))

    def open_con(self, comm_id: int) -> int:
        return int(self._lib.accl_open_con(self._w, self._rank, comm_id))

    def close_con(self, comm_id: int) -> int:
        return int(self._lib.accl_close_con(self._w, self._rank, comm_id))

    def tx_stats(self) -> tuple:
        """Egress (messages, payload bytes) handed to the transport."""
        msgs, pay = ctypes.c_uint64(0), ctypes.c_uint64(0)
        self._lib.accl_tx_stats(self._w, self._rank, ctypes.byref(msgs),
                                ctypes.byref(pay))
        return int(msgs.value), int(pay.value)

    # -- configuration ---------------------------------------------------
    def setup_rx_buffers(self, n_bufs: int, buf_size: int) -> None:
        self._lib.accl_cfg_rx(self._w, self._rank, n_bufs, buf_size)

    def upload_communicator(self, comm: Communicator) -> int:
        w = comm.to_words()
        return self._lib.accl_set_comm(self._w, self._rank, _words(w), len(w))

    def upload_arithconfig(self, cfg: ArithConfig) -> int:
        w = cfg.to_words()
        return self._lib.accl_set_arithcfg(self._w, self._rank, _words(w),
                                           len(w))

    def set_tuning(self, key: int, value: int) -> None:
        """Write a flat-tree tuning register; the engine refuses a key it
        does not implement (RING_THRESHOLD_BYTES) and so does this."""
        rc = self._lib.accl_set_tuning(self._w, self._rank, key, value)
        if rc == -2 or (rc != 0 and key not in EMU_TUNING_KEYS):
            raise unknown_tuning_key_error(key, EMU_TUNING_KEYS, "emu")
        if rc != 0:
            raise ACCLError(f"set_tuning({key}, {value}) failed (rc={rc})")

    # -- kernel streams (the device side of the stream calls) ------------
    def push_krnl(self, data: np.ndarray) -> None:
        """Feed operand bytes into the engine's kernel input stream."""
        b = np.ascontiguousarray(data).tobytes()
        self._lib.accl_push_krnl(self._w, self._rank, b, len(b))

    def pop_stream(self, strm: int, nbytes: int,
                   timeout_s: float = 10.0) -> Optional[bytes]:
        """Pull one message from a compute stream, or None on timeout."""
        buf = ctypes.create_string_buffer(nbytes)
        got = ctypes.c_uint64(0)
        ok = self._lib.accl_pop_stream(self._w, self._rank, strm, buf,
                                       nbytes, ctypes.byref(got),
                                       int(timeout_s * 1000))
        return buf.raw[:got.value] if ok else None

    def dump_rx_buffers(self) -> str:
        out = ctypes.create_string_buffer(65536)
        self._lib.accl_dump_rx(self._w, self._rank, out, 65536)
        return out.value.decode()

    def inject_fault(self, kind: int) -> None:
        """Arm a one-shot egress fault (drop, duplicate, corrupt seqn,
        delay): it forces the next draw of the chaos funnel."""
        if self._lib.accl_inject_fault(self._w, self._rank, kind) != 0:
            raise ACCLError(f"inject_fault({kind}) failed for rank "
                            f"{self._rank}")

    # -- resilience ------------------------------------------------------
    def set_resilience(self, retry_max: int, retry_base_us: int) -> None:
        """Configure the NACK retransmission lane (0 retries = off)."""
        self._lib.accl_set_resilience(self._w, self._rank,
                                      max(0, int(retry_max)),
                                      max(1, int(retry_base_us)))

    def abort_comm(self, comm_id: int, err_bits: int) -> bool:
        """Epoch-tagged abort, propagated to every peer by the control
        plane; the engine finalizes the pending calls (True)."""
        if self._lib.accl_abort(self._w, self._rank, comm_id,
                                err_bits & 0xFFFFFFFF) != 0:
            raise ACCLError(f"abort(comm {comm_id}) failed for rank "
                            f"{self._rank}")
        return True

    def reset_errors(self) -> None:
        """Seqn resync and transient-state drain after a classified fault
        (every rank of a quiesced world calls it)."""
        self._lib.accl_reset_errors(self._w, self._rank)

    def set_chaos(self, seed: int, drop_ppm: int, dup_ppm: int,
                  delay_ppm: int, delay_us: int, corrupt_ppm: int,
                  slow_us: int) -> None:
        """Arm the seeded probabilistic chaos plan on this rank."""
        self._lib.accl_set_chaos(self._w, self._rank, seed, drop_ppm,
                                 dup_ppm, delay_ppm, delay_us, corrupt_ppm,
                                 slow_us)

    def kill(self) -> None:
        """Kill-rank chaos: the engine goes silent and aborts its local
        comms with RANK_FAILED."""
        self._lib.accl_chaos_kill(self._w, self._rank)

    def probe_liveness(self, comm_id: int, size: int,
                       window_s: float = 1.0) -> list:
        """Heartbeat-probe every peer of a communicator: one alive flag a
        comm-local rank (the local rank is alive)."""
        bm = ctypes.c_uint64(0)
        if self._lib.accl_probe_liveness(self._w, self._rank, comm_id,
                                         int(window_s * 1e6),
                                         ctypes.byref(bm)) != 0:
            raise ACCLError(f"probe_liveness(comm {comm_id}) failed")
        return [bool(bm.value >> i & 1) for i in range(size)]

    def resilience_stats(self) -> dict:
        """Retransmitted segments, NACKs sent and received, and
        epoch-fenced ingress drops."""
        vals = [ctypes.c_uint64(0) for _ in range(4)]
        self._lib.accl_resilience_stats(self._w, self._rank,
                                        *[ctypes.byref(v) for v in vals])
        return dict(zip(("retrans_sent", "nacks_tx", "nacks_rx",
                         "fenced_drops"), (int(v.value) for v in vals)))

    # -- telemetry -------------------------------------------------------
    def engine_stats(self) -> dict:
        """The engine's telemetry snapshot in one FFI, decoded by the
        versioned field table (a newer engine's extra fields come out as
        ``unknown_field_<i>``)."""
        if not self._w:
            raise ACCLError("engine_stats: world is closed")
        cap = max(64, len(_telemetry.ENGINE_STATS_FIELDS_V1))
        buf = (ctypes.c_uint64 * cap)()
        total = int(self._lib.accl_engine_stats(self._w, self._rank, buf,
                                                cap))
        if total < 0:
            raise ACCLError(f"engine_stats failed for rank {self._rank}")
        version = int(self._lib.accl_engine_stats_version())
        return _telemetry.decode_engine_stats(
            buf[:min(total, cap)], version=version, total_fields=total)

    def link_stats(self) -> list:
        """The per-(comm, peer) wire counter rows in one FFI, decoded by
        the stride-checked link schema."""
        if not self._w:
            raise ACCLError("link_stats: world is closed")
        stride = int(self._lib.accl_engine_link_stats_stride())
        expect = len(_telemetry.LINK_STATS_FIELDS_V2)
        if stride != expect:
            raise ACCLError(
                f"link_stats: engine row stride {stride} != this "
                f"build's schema ({expect} fields) — mixed-version "
                f"world; refusing to mis-slice")
        total = int(self._lib.accl_engine_link_stats(self._w, self._rank,
                                                     None, 0))
        if total < 0:
            raise ACCLError(f"link_stats failed for rank {self._rank}")
        if total == 0:
            return []
        cap = total + 16 * stride  # rows minted since the size probe
        buf = (ctypes.c_uint64 * cap)()
        got = int(self._lib.accl_engine_link_stats(self._w, self._rank,
                                                   buf, cap))
        if got < 0:
            raise ACCLError(f"link_stats failed for rank {self._rank}")
        return _telemetry.decode_link_stats(buf[:min(got, cap)])

    # -- persistent plans: the engine's descriptor ring ------------------
    def arm_plan(self, calls, expected=None, timeout_s: float = 30.0) -> int:
        """Parse a captured descriptor stream once into the engine's plan
        storage; a replay is one FFI for the whole batch."""
        words: list = []
        for call in calls:
            words.extend(call.to_words())
        pid = int(self._lib.accl_plan_create(self._w, self._rank,
                                             _words(words), len(calls)))
        if pid < 0:
            raise ACCLError(
                "arm_plan: engine rejected the descriptor batch (a "
                "referenced communicator is aborted, or the batch is "
                "empty) — recover the world, then capture")
        return pid

    def plan_replay(self, plan_id: int, run_async: bool = False,
                    timeout_s: float = 60.0):
        """One replay: synchronous by default, else the token for
        :meth:`plan_wait`."""
        token = int(self._lib.accl_plan_replay(self._w, self._rank, plan_id))
        if token == -2:
            raise ACCLError(
                "plan replay: plan invalidated by an abort/epoch "
                "fence/reset — re-capture on the recovered communicator",
                int(ErrorCode.COMM_ABORTED))
        if token < 0:
            raise ACCLError(f"plan replay: unknown plan id {plan_id}")
        if run_async:
            return token
        if not self.plan_wait(plan_id, token, timeout_s):
            raise ACCLError(f"plan replay timed out after {timeout_s:.0f}s")
        return None

    def plan_wait(self, plan_id: int, token: int, timeout_s: float) -> bool:
        """Block until a replay token completes (False on timeout); a
        non-zero retcode raises decoded."""
        ret, dur = ctypes.c_uint32(0), ctypes.c_double(0.0)
        rc = int(self._lib.accl_plan_wait(self._w, self._rank, token,
                                          int(timeout_s * 1000),
                                          ctypes.byref(ret),
                                          ctypes.byref(dur)))
        if rc == 0:
            return False
        if rc < 0:
            raise ACCLError(f"plan replay: unknown token {token}")
        if ret.value != 0:
            raise ACCLError(
                f"plan replay failed: {error_code_to_str(ret.value)}",
                int(ret.value))
        return True

    def invalidate_plans(self, comm_id: int = -1) -> None:
        """Fence the engine's plans on a comm (-1: all); abort and
        reset_errors fence inside the engine on their own."""
        self._lib.accl_plan_invalidate(self._w, self._rank, comm_id)

    def plan_count(self) -> int:
        """Live engine-side plans."""
        return int(self._lib.accl_plan_count(self._w, self._rank))

    def plan_release(self, plan_id: int) -> None:
        """Release a dead plan's storage; a no-op once the world closed
        (the finalizer may outlive it)."""
        if self._w:
            self._lib.accl_plan_release(self._w, self._rank, plan_id)

    # -- wire protocol ---------------------------------------------------
    def ingest_bytes(self, frame: bytes) -> int:
        """Feed one raw wire frame through the engine's ingress
        classification: 0 consumed (or dropped at the kill/epoch gate),
        1 rejected as malformed."""
        rc = int(self._lib.accl_engine_ingest_bytes(self._w, self._rank,
                                                    frame, len(frame)))
        if rc < 0:
            raise ACCLError(f"ingest_bytes failed for rank {self._rank}")
        return rc

    def frame_stats(self, publish: bool = True) -> dict:
        """Frames accepted and rejected as malformed; with ``publish`` the
        deltas go to the registry's ``wire/*`` counters."""
        acc, rej = ctypes.c_uint64(0), ctypes.c_uint64(0)
        self._lib.accl_frame_stats(self._w, self._rank, ctypes.byref(acc),
                                   ctypes.byref(rej))
        stats = {"accepted_frames": int(acc.value),
                 "rejected_frames": int(rej.value)}
        if publish:
            reg = _metrics.default_registry()
            for key, val in stats.items():
                delta = val - self._frames_published.get(key, 0)
                if delta > 0:
                    reg.inc(f"wire/{key}", delta)
                    self._frames_published[key] = val
        return stats

    def frame_tap(self, on: bool = True) -> None:
        """Toggle the egress frame tap (the last 256 staged frames)."""
        self._lib.accl_frame_tap(self._w, self._rank, 1 if on else 0)

    def tap_frames(self) -> list:
        """Drain the tapped egress frames, oldest first; the tap is left
        empty."""
        out: list = []
        buf = ctypes.create_string_buffer(1 << 20)
        while True:
            n = int(self._lib.accl_frame_tap_drain(self._w, self._rank, buf,
                                                   len(buf)))
            if n <= 0:
                return out
            raw, off = buf.raw[:n], 0
            while off + 4 <= n:
                ln = int.from_bytes(raw[off:off + 4], "little")
                out.append(raw[off + 4:off + 4 + ln])
                off += 4 + ln

    # -- elastic membership: the join control plane ----------------------
    def join_sync(self, sponsor_session: int, timeout_s: float = 10.0) -> int:
        """The joiner's Join/Welcome/StateSync exchange with a live
        sponsor (epochs, abort fences, comm-slot count): 0, or -1 when
        the sponsor never answered."""
        return int(self._lib.accl_join_sync(self._w, self._rank,
                                            sponsor_session,
                                            int(timeout_s * 1000)))

    def comm_count(self) -> int:
        """Comm slots (real and placeholder) this engine knows."""
        return int(self._lib.accl_comm_count(self._w, self._rank))

    def comm_epoch(self, comm_id: int) -> int:
        """A comm slot's epoch (abort-fence introspection)."""
        return int(self._lib.accl_comm_epoch(self._w, self._rank, comm_id))

    def join_stats(self) -> dict:
        """Joins answered as sponsor and completed as joiner."""
        sponsored, joined = ctypes.c_uint64(0), ctypes.c_uint64(0)
        self._lib.accl_join_stats(self._w, self._rank,
                                  ctypes.byref(sponsored),
                                  ctypes.byref(joined))
        return {"sponsored": int(sponsored.value),
                "joined": int(joined.value)}

    def close(self) -> None:
        pass  # the world owns the native handle


def _teardown(lib, handle, devices, accls) -> None:
    """Close one native world in the order the waiters need: mark the
    teardown, shut the engines down (every waiter's wait returns), null
    the handles under each device's lifecycle lock, join the waiters,
    then destroy; a waiter that refuses to die leaks the world rather
    than free memory under it."""
    for a in accls:
        _flight.mark_event(a.flight_recorder, _flight.TEARDOWN_EVENT, -1,
                           lane="lifecycle")
    lib.accl_world_shutdown(handle)
    for d in devices:
        with d._lifecycle:
            d._w = None
    stuck = _join_waiters(devices)
    if stuck:
        get_logger("accl_tpu_torch.emu").warning(
            "world close: %d waiter thread(s) still alive after shutdown — "
            "leaking the native world rather than freeing memory under a "
            "live thread", stuck)
    else:
        lib.accl_world_destroy(handle)


class EmuRankTcp:
    """One rank over the TCP transport (one process or thread a rank):
    the reference's emulator-per-MPI-rank rung with length-prefixed TCP
    frames for ZMQ."""

    def __init__(self, rank: int, nranks: int, base_port: int,
                 devmem_bytes: int = 64 << 20, n_egr_rx_bufs: int = 16,
                 egr_rx_buf_size: int = 1024,
                 max_eager_size: Optional[int] = None,
                 call_timeout_s: float = 60.0):
        self._lib = load_lib()
        self.rank = rank
        self.nranks = nranks
        self.telemetry = None
        self._handle = self._lib.accl_world_create_tcp(rank, nranks,
                                                       base_port,
                                                       devmem_bytes)
        if not self._handle:
            raise ACCLError(f"TCP emulator rank {rank} failed to start "
                            f"(port {base_port + rank} busy?)")
        # the engine's receive budget must fire before the driver's wait,
        # so a stall surfaces as a decodable RECEIVE_TIMEOUT_ERROR
        call_timeout_s = max(call_timeout_s, default_timeout() / 1e6 + 5.0)
        self.device = EmuDevice(self._handle, rank, self._lib,
                                call_timeout_s=call_timeout_s)
        self.device.shares_process_world = False
        self.accl = ACCL(self.device)
        self.accl.call_timeout_s = call_timeout_s
        ranks = [Rank(ip="127.0.0.1", port=base_port + r, session=r,
                      max_segment_size=egr_rx_buf_size)
                 for r in range(nranks)]
        kwargs = {}
        if max_eager_size is not None:
            kwargs["max_eager_size"] = max_eager_size
        self.accl.initialize(ranks, rank, n_egr_rx_bufs=n_egr_rx_bufs,
                             egr_rx_buf_size=egr_rx_buf_size, **kwargs)
        self.telemetry = _telemetry.sampler_from_env(
            [self.device.engine_stats], name=f"accl-tcp-r{rank}")
        _live_worlds.add(self)

    def close(self) -> None:
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None
        if self._handle:
            _teardown(self._lib, self._handle, [self.device], [self.accl])
            self._handle = None

    def __enter__(self) -> "EmuRankTcp":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class EmuWorld:
    """N emulated ranks in one process; ``run(fn)`` calls ``fn(accl,
    rank)`` on every rank at once.

    ``transport``: "inproc" (FIFO through a synchronous hub), "dgram"
    (MTU fragmentation with deterministic reordering, native/src/
    dgram.hpp) or "rdma" (queue pairs with a one-sided memory plane,
    native/src/rdma.hpp).  ``retry_max`` / ``retry_base_us`` override
    ``ACCL_RETRY_*``; ``chaos`` (a :class:`ChaosPlan` or its grammar,
    default ``ACCL_CHAOS``) arms the seeded fault plan."""

    #: datagram faults for inject_dgram_fault
    DGRAM_DROP_NEXT = 1
    DGRAM_DUP_NEXT = 2

    def __init__(self, nranks: int, devmem_bytes: int = 64 << 20,
                 n_egr_rx_bufs: int = 16, egr_rx_buf_size: int = 1024,
                 max_eager_size: Optional[int] = None,
                 max_rendezvous_size: Optional[int] = None,
                 initialize: bool = True, transport: str = "inproc",
                 mtu: int = 256, reorder_window: int = 8,
                 retry_max: Optional[int] = None,
                 retry_base_us: Optional[int] = None, chaos=None):
        self._lib = load_lib()
        self.nranks = nranks
        self._n_egr_rx_bufs = n_egr_rx_bufs
        self._egr_rx_buf_size = egr_rx_buf_size
        self.telemetry = None
        self.watchdog = None
        self.online_tuner = None
        self.joiners: list = []
        if transport == "dgram":
            self._handle = self._lib.accl_world_create_dgram(
                nranks, devmem_bytes, mtu, reorder_window)
        elif transport == "rdma":
            self._handle = self._lib.accl_world_create_rdma(nranks,
                                                            devmem_bytes)
        elif transport == "inproc":
            self._handle = self._lib.accl_world_create(nranks, devmem_bytes)
        else:
            raise ACCLError(f"unknown transport {transport!r}")
        self.devices = [EmuDevice(self._handle, r, self._lib)
                        for r in range(nranks)]
        # explicit arguments over ACCL_RETRY_* (applied by each device)
        if retry_max is not None or retry_base_us is not None:
            env = RetryPolicy.from_env()
            for d in self.devices:
                d.set_resilience(
                    env.max_retries if retry_max is None else retry_max,
                    env.base_us if retry_base_us is None else retry_base_us)
        if isinstance(chaos, str):
            chaos = ChaosPlan.parse(chaos)
        self.chaos_plan = chaos if chaos is not None else ChaosPlan.from_env()
        if self.chaos_plan is not None:
            for r, d in enumerate(self.devices):
                self.chaos_plan.apply(d, r)
        self.accls = [ACCL(d) for d in self.devices]
        self._pool = ThreadPoolExecutor(max_workers=nranks)
        _live_worlds.add(self)
        if initialize:
            ranks = [Rank(ip="127.0.0.1", port=0, session=r,
                          max_segment_size=egr_rx_buf_size)
                     for r in range(nranks)]
            kwargs = {}
            if max_eager_size is not None:
                kwargs["max_eager_size"] = max_eager_size
            if max_rendezvous_size is not None:
                kwargs["max_rendezvous_size"] = max_rendezvous_size
            for r, a in enumerate(self.accls):
                a.initialize(ranks, r, n_egr_rx_bufs=n_egr_rx_bufs,
                             egr_rx_buf_size=egr_rx_buf_size, **kwargs)
        # the hang watchdog over the flight recorders (the engine keeps
        # its own gang state, so diagnosis is flight-ring based); under
        # ACCL_WATCHDOG_ACTION=abort a fire aborts the hung comm
        self.watchdog = _health.Watchdog(
            [a.flight_recorder for a in self.accls
             if a.flight_recorder is not None], name="accl-emu",
            abort_hook=self._watchdog_abort).start()
        #: the in-process join rendezvous (resilience/elastic.py)
        self.board = MembershipBoard()
        # the engine telemetry sampler (none unless
        # ACCL_TELEMETRY_INTERVAL_MS > 0)
        self.telemetry = _telemetry.sampler_from_env(
            [d.engine_stats for d in self.devices], name="accl-emu",
            link_sources=[(r, d.link_stats)
                          for r, d in enumerate(self.devices)])
        # the online tuner (ACCL_TUNE_ONLINE=1, tuning/online.py): unset
        # constructs nothing and dispatch stays bit-identical
        from ..tuning import online as _online

        self.online_tuner = _online.ensure_online_tuner_from_env(self)

    def start_watchdog(self, **kwargs) -> _health.Watchdog:
        """Re-arm the watchdog with explicit settings (tests shorten
        ``timeout_s``)."""
        self.watchdog.stop()
        kwargs.setdefault("abort_hook", self._watchdog_abort)
        self.watchdog = _health.Watchdog(
            [a.flight_recorder for a in self.accls
             if a.flight_recorder is not None], name="accl-emu",
            **kwargs).start()
        return self.watchdog

    def _watchdog_abort(self, comm_id: int, report: dict) -> None:
        """The ``ACCL_WATCHDOG_ACTION=abort`` hook: abort the hung comm
        with RANK_FAILED from a rank that arrived at its stuck gang (the
        missing rank may be dead and unable to propagate anything)."""
        hangs = report.get("analysis", {}).get("hangs", [])
        arrived = next((h["arrived"] for h in hangs
                        if h.get("comm") == comm_id), [])
        for r in list(arrived) or list(range(self.nranks)):
            try:
                self.accls[r].abort(comm_id, error=int(ErrorCode.RANK_FAILED))
                return
            except Exception:  # noqa: BLE001 — try the next survivor
                continue

    def kill_rank(self, rank: int) -> None:
        """Kill-rank chaos: the rank's engine goes silent mid-run."""
        self.devices[rank].kill()

    def spawn_replacement(self, announce: bool = True) -> "EmuJoiner":
        """Spawn a replacement rank: a fresh engine on the live world's
        hub at the next session id, its driver brought up on a
        self-world, announced on :attr:`board` (unless ``announce`` is
        False) for a grow-policy supervisor to admit.  The joiner then
        completes the handshake with :meth:`EmuJoiner.join`."""
        new_rank = int(self._lib.accl_world_add_rank(self._handle))
        if new_rank < 0:
            raise ACCLError(
                "spawn_replacement: this world's transport cannot grow "
                "(only inproc worlds support live join) or the join "
                "headroom is exhausted")
        device = EmuDevice(self._handle, new_rank, self._lib)
        accl = ACCL(device)
        row = Rank(ip="127.0.0.1", port=0, session=new_rank,
                   max_segment_size=self._egr_rx_buf_size)
        # a 1-rank comm 0; the join sync pads the id space to the
        # survivors'
        accl.initialize([row], 0, n_egr_rx_bufs=self._n_egr_rx_bufs,
                        egr_rx_buf_size=self._egr_rx_buf_size)
        joiner = EmuJoiner(self, accl, device, new_rank, row)
        if announce:
            joiner.offer = self.board.announce(new_rank, row)
        self.joiners.append(joiner)
        if accl.flight_recorder is not None:
            self.watchdog.add_recorder(accl.flight_recorder)
        return joiner

    def reset_errors(self) -> None:
        """Collective seqn resync after a classified fault: every rank's
        driver and engine state is cleared."""
        for a in self.accls:
            a.reset_errors()

    def resilience_stats(self) -> list:
        """Per-rank retransmission counters."""
        return [d.resilience_stats() for d in self.devices]

    def engine_stats(self) -> list:
        """Per-rank engine telemetry snapshots."""
        return [d.engine_stats() for d in self.devices]

    def link_stats(self) -> dict:
        """Global rank -> its (comm, peer) wire-counter rows."""
        return {r: d.link_stats() for r, d in enumerate(self.devices)}

    def link_matrix(self, comm: int = 0,
                    tenant: Optional[str] = None) -> dict:
        """The world's P x P link traffic matrix of one communicator, or
        with ``tenant`` of every communicator the drivers label so."""
        if tenant is not None:
            comms = set()
            for a in self.accls:
                comms.update(a.tenant_comm_ids(tenant))
            doc = _telemetry.link_matrix(self.link_stats(),
                                         nranks=self.nranks, comms=comms)
            doc["tenant"] = tenant
            return doc
        return _telemetry.link_matrix(self.link_stats(), nranks=self.nranks,
                                      comm=comm)

    def run(self, fn: Callable, *args, timeout: Optional[float] = 120) -> list:
        """``fn(accl, rank, *args)`` on every rank at once; the per-rank
        results, or the first exception."""
        futures = [self._pool.submit(fn, self.accls[r], r, *args)
                   for r in range(self.nranks)]
        return [f.result(timeout=timeout) for f in futures]

    def dump_qps(self, rank: int) -> str:
        """One rank's queue-pair counters (the RDMA transport only)."""
        out = ctypes.create_string_buffer(8192)
        if self._lib.accl_dump_qps(self._handle, rank, out, 8192) < 0:
            raise ACCLError("world has no RDMA transport")
        return out.value.decode()

    def inject_dgram_fault(self, kind: int) -> None:
        """Drop or duplicate the next datagram fragment of any rank (the
        "dgram" transport only)."""
        if self._lib.accl_dgram_fault(self._handle, kind) != 0:
            raise ACCLError("world has no datagram transport")

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.online_tuner is not None:
            from ..tuning import online as _online

            # before the engines die: no A/B on a dying world
            _online.stop_world_tuner(self)
        if self.telemetry is not None:
            self.telemetry.stop()  # no poll of a dying world
            self.telemetry = None
        self._pool.shutdown(wait=False)
        if self._handle:
            _teardown(self._lib, self._handle,
                      self.devices + [j.device for j in self.joiners],
                      self.accls + [j.accl for j in self.joiners])
            self._handle = None

    def __enter__(self) -> "EmuWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class EmuJoiner:
    """A replacement rank spawned into a live :class:`EmuWorld`: its own
    engine, driver and board offer.  The world owns the native handle."""

    def __init__(self, world: EmuWorld, accl: ACCL, device: EmuDevice,
                 rank: int, row: Rank):
        self.world = world
        self.accl = accl
        self.device = device
        self.rank = rank  # session id == the engine's global index
        self.row = row
        self.offer = None

    def join(self, timeout_s: float = 30.0) -> int:
        """Complete the join (blocks until a survivor's admission claims
        the offer): state sync from the sponsor, comm-id padding, the
        grown communicator adopted.  Returns its id."""
        if self.offer is None:
            self.offer = self.world.board.announce(self.rank, self.row)
        return join_grown_world(self.accl, self.offer, timeout_s)
