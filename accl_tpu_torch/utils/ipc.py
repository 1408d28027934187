"""The transport between the processes of one host.

After :func:`accl_tpu_torch.utils.bringup.initialize_multihost` the
processes of one host reach each other's memory through this module: on
the card through CUDA IPC handles (``ops/csrc/ring.cu`` ``accl_ipc_*``),
on the CPU through shared files under ``/dev/shm``, its stand-in for an
IPC handle as ``devices=["cpu"] * P`` stands in for cards.  Names travel
through the rendezvous store, keyed by purpose, the pair of processes
and a sequence number, so the k-th message from process p to process q
is the k-th that q receives from p: every process must make the same
calls in the same order (SPMD), as with any collective library.

Three services:

- messages (:meth:`Transport.send`, :meth:`Transport.recv`): a tensor
  from one process to another.  A send never waits for its receiver; a
  receive waits for its message.  On the CPU the sender writes the
  tensor's bytes into a file of its own under ``/dev/shm`` and the
  receiver reads and unlinks it; on the card the sender copies it into a
  staging buffer of its own ``cudaMalloc`` (exported once) and the
  receiver copies it out of its mapping of that buffer, then
  acknowledges, after which the sender may reuse the buffer;
- exchanges of small values (:meth:`Transport.exchange`): the IPC
  handles of the ring kernels' tables, each process's resident blocks;
- the launch barrier of the ring kernels' cross-process mode
  (:meth:`Transport.arrive`, :meth:`Transport.enqueued`), over a board
  of words each process keeps in a shared file: a process posts the
  launch's number, its signature and whether its pointers are aligned,
  and waits until every process has posted the same.

Every wait checks its peers: a peer that died (its pid gone, or a
zombie), that gave up, or that waits for a message this process has not
sent while this process waits for one from it (the two run different
programs: an SPMD mismatch) makes it raise ``ACCLError`` naming the
peer at once, and a peer silent for ``ACCL_IPC_TIMEOUT`` seconds (120
by default) makes it raise naming the peer.  Raising sets this
process's give-up word, the one process-wide word every peer's waits
read, so that they raise too.  :meth:`Transport.close` closes what it
opened, frees what it made and unlinks its files; after a peer was lost
it also unlinks every file of the session the peer left behind.
"""
from __future__ import annotations

import atexit
import ctypes
import glob
import json
import mmap
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..constants import ACCLError
from . import bringup

SHM_DIR = "/dev/shm"
#: board words (int64): the last launch the process arrived at, that
#: launch's signature and alignment, the last launch it enqueued, its
#: give-up word, the message it waits for (one word, so that a reader
#: sees the peer and the index of one wait: (peer + 1) << 40 | index, 0
#: for none), and whether it closed
B_ARRIVED, B_SIG, B_ALIGNED, B_ENQUEUED, B_GIVEN_UP, B_WAITS, \
    B_CLOSED = range(7)
BOARD_WORDS = 16
#: seconds two processes must be seen waiting on each other for messages
#: neither sent before a receive calls it a mismatch
MISMATCH_S = 1.0
#: a card's staging buffers are whole multiples of this
STAGE_MIN = 4 << 20


def _timeout() -> float:
    return float(os.environ.get("ACCL_IPC_TIMEOUT", "120"))


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def store_wait(store, key: str, peer: int, what: str,
               timeout_s: Optional[float] = None) -> None:
    """Wait until ``key`` is in ``store``, set by process ``peer``; raise
    ``ACCLError`` naming it after ``timeout_s`` (or when the store's host,
    process 0, is gone)."""
    deadline = time.monotonic() + (_timeout() if timeout_s is None
                                   else timeout_s)
    while True:
        try:
            if store.check([key]):
                return
        except (RuntimeError, OSError) as e:
            raise ACCLError(f"{what}: the rendezvous store (process 0) is "
                            f"gone: {e}") from e
        if time.monotonic() > deadline:
            raise ACCLError(f"{what}: process {peer} did not answer "
                            f"({key!r} never set)")
        time.sleep(1e-3)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.split(".")[-1])


def _lib():
    from ..ops import _build

    return _build.load("ring")


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().accl_ring_error_string(rc).decode()
        raise ACCLError(f"{what}: CUDA error {rc} ({msg})")


class _Stage:
    """A staging buffer of a card's sends: its own ``cudaMalloc``, its
    handle, and the key of the acknowledgement it waits for (None: free)."""

    __slots__ = ("ptr", "nbytes", "device", "handle", "ack")

    def __init__(self, ptr, nbytes, device, handle):
        self.ptr, self.nbytes, self.device = ptr, nbytes, device
        self.handle, self.ack = handle, None


class Transport:
    """This process's end of the transport (module docstring); made at
    first use by :func:`transport`, which every process must call."""

    def __init__(self, store, process: int, count: int):
        self.store, self.process, self.count = store, process, count
        self.lost = False
        self._closed = False
        self._lock = threading.RLock()
        self._sent: dict = {}
        self._received: dict = {}
        self._stages: list = []
        self._opened: dict = {}
        self._allocs: list = []
        #: crossings between processes this process took part in
        self.crossings = 0
        if process == 0:
            port = (bringup._PROCESS["address"] or ":0").rpartition(":")[2]
            store.set("accl/ipc/session", f"accl-{port}-{os.getpid()}")
        store_wait(store, "accl/ipc/session", 0, "ipc transport")
        self.session = store.get("accl/ipc/session").decode()
        self._board_path = self._path(f"board-{process}")
        fd = os.open(self._board_path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, 8 * BOARD_WORDS)
            self._mm = mmap.mmap(fd, 8 * BOARD_WORDS)
        finally:
            os.close(fd)
        self.board = (ctypes.c_int64 * BOARD_WORDS).from_buffer(self._mm)
        got = self.exchange("boards", str(os.getpid()).encode())
        self.pids = [int(v) for v in got]
        self._peer_mm, self.boards = {}, {}
        for q in range(count):
            if q == process:
                self.boards[q] = self.board
                continue
            fd = os.open(self._path(f"board-{q}"), os.O_RDWR)
            try:
                self._peer_mm[q] = mmap.mmap(fd, 8 * BOARD_WORDS)
            finally:
                os.close(fd)
            self.boards[q] = (ctypes.c_int64 * BOARD_WORDS).from_buffer(
                self._peer_mm[q])

    # -- names and liveness ---------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(SHM_DIR, f"{self.session}-{name}")

    def give_up(self) -> None:
        """Set this process's give-up word: every peer's waits raise."""
        self.lost = True
        self.board[B_GIVEN_UP] = 1

    def _fail(self, msg: str) -> None:
        self.give_up()
        raise ACCLError(msg)

    def _check_peers(self, what: str, peers, waiting=None,
                     suspect=None) -> None:
        """Raise naming a peer of ``peers`` that gave up, died, closed, or
        waits on this process for a message it will not send while this
        one waits on it (``waiting``: (peer, index) of this process's
        receive).  The store may hold a message back for a moment after
        its sender has gone on, so the verdicts on a peer that closed or
        waits need it seen so for ``MISMATCH_S`` (``suspect``: a dict that
        keeps the first sightings)."""
        for q in peers:
            b = self.boards[q]
            if b[B_GIVEN_UP]:
                self._fail(f"{what}: process {q} gave up (an error there; "
                           f"see its output)")
            if not _alive(self.pids[q]):
                self._fail(f"{what}: process {q} (pid {self.pids[q]}) died")
            if b[B_CLOSED] and (suspect is None or time.monotonic()
                                - suspect.setdefault(("closed", q),
                                                     time.monotonic())
                                > MISMATCH_S):
                self._fail(f"{what}: process {q} closed its transport (it "
                           f"left the collective calls)")
            if waiting is not None and q == waiting[0]:
                w = b[B_WAITS]
                if (w >> 40 != self.process + 1
                        or w & ((1 << 40) - 1) < self._sent.get(q, 0)):
                    suspect.pop(w, None)
                    continue
                first = suspect.setdefault(w, time.monotonic())
                if time.monotonic() - first > MISMATCH_S:
                    self._fail(
                        f"{what}: process {q} waits for message "
                        f"{w & ((1 << 40) - 1)} from process {self.process}, "
                        f"which "
                        f"waits for message {waiting[1]} from process {q}: "
                        f"the processes made different calls (every process "
                        f"must make the same collective calls in the same "
                        f"order)")

    def _wait(self, what: str, ready: Callable[[], bool], peers,
              waiting=None) -> None:
        deadline = time.monotonic() + _timeout()
        spins, suspect = 0, {}
        while True:
            try:
                if ready():
                    return
            except (RuntimeError, OSError) as e:
                self._fail(f"{what}: process 0, the rendezvous store's host, "
                           f"is gone: {e}")
            self._check_peers(what, peers, waiting, suspect)
            if time.monotonic() > deadline:
                self._fail(f"{what}: process(es) {list(peers)} did not answer "
                           f"in {_timeout():.0f}s")
            spins += 1
            time.sleep(0 if spins < 200 else 2e-4)

    # -- small values -----------------------------------------------------------
    def exchange(self, key: str, value: bytes) -> list:
        """Every process's ``value`` under ``key`` (one call a key in
        every process), in process order."""
        base = f"accl/ipc/x/{key}"
        self.store.set(f"{base}/{self.process}", value)
        out = []
        for q in range(self.count):
            k = f"{base}/{q}"
            if q != self.process and getattr(self, "boards", None):
                self._wait(f"exchange {key!r}",
                           lambda k=k: self.store.check([k]), [q])
            else:
                store_wait(self.store, k, q, f"exchange {key!r}")
            out.append(self.store.get(k))
        return out

    # -- messages -----------------------------------------------------------------
    def send(self, t: torch.Tensor, dst: int, what: str = "move") -> None:
        """``t`` to process ``dst``; returns without waiting for it."""
        with self._lock:
            k = self._sent.get(dst, 0)
            key = f"accl/ipc/m/{self.process}-{dst}/{k}"
            t = t.detach().contiguous()
            nbytes = t.numel() * t.element_size()
            meta = {"shape": list(t.shape), "dtype": str(t.dtype),
                    "nbytes": nbytes, "what": what}
            if nbytes and t.device.type == "cpu":
                path = self._path(f"m-{self.process}-{dst}-{k}")
                t.reshape(-1).view(torch.uint8).numpy().tofile(path)
                meta["file"] = path
            elif nbytes:
                dev = t.device.index
                st = self._stage(nbytes, dev)
                stream = torch.cuda.current_stream(t.device)
                _check_rc(_lib().accl_ipc_copy(
                    st.ptr, t.data_ptr(), nbytes, dev, stream.cuda_stream),
                    "ipc send")
                stream.synchronize()
                st.ack = key + "/ack"
                meta.update(handle=st.handle.hex(), ack=st.ack)
            self.store.set(key, json.dumps(meta))
            self._sent[dst] = k + 1
            self.crossings += 1

    def recv(self, src: int, device, what: str = "move") -> torch.Tensor:
        """The next tensor process ``src`` sent to this one, on
        ``device``."""
        with self._lock:
            k = self._received.get(src, 0)
            key = f"accl/ipc/m/{src}-{self.process}/{k}"
            self.board[B_WAITS] = (src + 1) << 40 | k
            try:
                self._wait(f"{what}: receive from process {src}",
                           lambda: self.store.check([key]), [src],
                           waiting=(src, k))
            finally:
                self.board[B_WAITS] = 0
            meta = json.loads(self.store.get(key))
            self.store.delete_key(key)
            if meta["what"] != what:
                self._fail(f"{what}: message {k} from process {src} is of "
                           f"{meta['what']!r}: the processes made different "
                           f"calls")
            self._received[src] = k + 1
            self.crossings += 1
            dt, shape = _dtype(meta["dtype"]), meta["shape"]
            device = torch.device(device)
            if not meta["nbytes"]:
                return torch.empty(shape, dtype=dt, device=device)
            if "file" in meta:
                raw = np.fromfile(meta["file"], dtype=np.uint8)
                os.unlink(meta["file"])
                return torch.from_numpy(raw).view(dt).reshape(shape).to(
                    device)
            if device.type != "cuda":
                raise ACCLError(f"{what}: a message from a card received on "
                                f"{device}")
            out = torch.empty(shape, dtype=dt, device=device)
            stream = torch.cuda.current_stream(device)
            try:
                ptr = self.open(bytes.fromhex(meta["handle"]), device.index)
                _check_rc(_lib().accl_ipc_copy(
                    out.data_ptr(), ptr, meta["nbytes"], device.index,
                    stream.cuda_stream), "ipc recv")
                stream.synchronize()
            except ACCLError as e:  # the sender's buffer went with it?
                self._check_peers(f"{what}: receive from process {src}",
                                  [src])
                raise e
            self.store.set(meta["ack"], "1")
            return out

    def _stage(self, nbytes: int, device: int) -> _Stage:
        for st in self._stages:
            if st.device != device or st.nbytes < nbytes:
                continue
            if st.ack is not None and self.store.check([st.ack]):
                self.store.delete_key(st.ack)
                st.ack = None
            if st.ack is None:
                return st
        size = -(-nbytes // STAGE_MIN) * STAGE_MIN
        ptr = self.malloc(size, device)
        st = _Stage(ptr, size, device, self.export(ptr, device))
        self._stages.append(st)
        return st

    # -- device memory ------------------------------------------------------------
    def malloc(self, nbytes: int, device: int) -> int:
        """``nbytes`` of zeroed memory of its own ``cudaMalloc`` on card
        ``device``, freed by :meth:`close`."""
        ptr = ctypes.c_void_p()
        _check_rc(_lib().accl_ipc_malloc(nbytes, device, ctypes.byref(ptr)),
                  "accl_ipc_malloc")
        self._allocs.append((ptr.value, device))
        return ptr.value

    def export(self, ptr: int, device: int) -> bytes:
        """The IPC handle of a :meth:`malloc` buffer."""
        lib = _lib()
        buf = ctypes.create_string_buffer(lib.accl_ipc_handle_bytes())
        _check_rc(lib.accl_ipc_export(ptr, device, buf), "accl_ipc_export")
        return buf.raw

    def open(self, handle: bytes, device: int) -> int:
        """Another process's buffer, mapped on card ``device`` (once a
        handle and card)."""
        got = self._opened.get((handle, device))
        if got is None:
            ptr = ctypes.c_void_p()
            _check_rc(_lib().accl_ipc_open(handle, device, ctypes.byref(ptr)),
                      "accl_ipc_open")
            got = self._opened[(handle, device)] = ptr.value
        return got

    def unmap(self, handle: bytes, device: int) -> None:
        ptr = self._opened.pop((handle, device), None)
        if ptr is not None:
            _check_rc(_lib().accl_ipc_close(ptr, device), "accl_ipc_close")

    # -- the ring kernels' launch barrier -------------------------------------------
    def arrive(self, seq: int, sig: int, aligned: bool,
               what: str) -> bool:
        """Post launch ``seq`` with its signature and alignment and wait
        until every process has; raise naming a process whose signature
        differs.  Returns whether every process's pointers are aligned."""
        b = self.board
        b[B_SIG], b[B_ALIGNED], b[B_ARRIVED] = sig, int(aligned), seq
        peers = [q for q in range(self.count) if q != self.process]
        self._wait(f"{what}: launch {seq}", lambda: all(
            self.boards[q][B_ARRIVED] >= seq for q in peers), peers)
        for q in peers:
            if self.boards[q][B_ARRIVED] == seq and \
                    self.boards[q][B_SIG] != sig:
                self._fail(f"{what}: process {q} made another call at launch "
                           f"{seq} (signature {self.boards[q][B_SIG]:#x}, "
                           f"this process {sig:#x}): every process must make "
                           f"the same collective calls in the same order")
        return all(self.boards[q][B_ALIGNED] for q in range(self.count))

    def enqueued(self, seq: int, what: str) -> None:
        """Post that launch ``seq`` is enqueued here and wait until every
        process has (raising, with the give-up word set, when one gave up
        instead)."""
        self.board[B_ENQUEUED] = seq
        peers = [q for q in range(self.count) if q != self.process]
        self._wait(f"{what}: launch {seq}", lambda: all(
            self.boards[q][B_ENQUEUED] >= seq for q in peers), peers)

    # -- the end ----------------------------------------------------------------------
    def close(self) -> None:
        """Close the mappings this process opened, then (after every live
        peer has closed its own) free its buffers and unlink its files;
        after a lost peer, every file of the session."""
        if self._closed:
            return
        self._closed = True
        lib = _lib() if (self._opened or self._allocs) else None
        for (_h, dev), ptr in list(self._opened.items()):
            lib.accl_ipc_close(ptr, dev)
        self._opened.clear()
        self.board[B_CLOSED] = 1
        deadline = time.monotonic() + min(_timeout(), 30.0)
        for q in range(self.count):
            while (q != self.process and not self.lost
                   and not self.boards[q][B_CLOSED]
                   and not self.boards[q][B_GIVEN_UP]
                   and _alive(self.pids[q])
                   and time.monotonic() < deadline):
                time.sleep(1e-3)
        for ptr, dev in self._allocs:
            lib.accl_ipc_free(ptr, dev)
        self._allocs.clear()
        lost = self.lost or any(self.boards[q][B_GIVEN_UP]
                                or not _alive(self.pids[q])
                                for q in range(self.count))
        pattern = (f"{self.session}-*" if lost else
                   f"{self.session}-m-{self.process}-*")
        names = glob.glob(os.path.join(SHM_DIR, pattern))
        if not lost:
            names.append(self._board_path)
        for name in names:
            try:
                os.unlink(name)
            except FileNotFoundError:
                pass


_transport: Optional[Transport] = None
_transport_lock = threading.Lock()


def transport() -> Transport:
    """This process's :class:`Transport` over the store of
    ``initialize_multihost`` (made at first use: every process must call
    it, as every process makes the collective calls that use it)."""
    global _transport
    with _transport_lock:
        if _transport is None:
            st = bringup.store()
            if st is None or bringup.process_count() < 2:
                raise ACCLError("ipc transport: no other process joined "
                                "(initialize_multihost)")
            _transport = Transport(st, bringup.process_index(),
                                   bringup.process_count())
            atexit.register(close)
        return _transport


def close() -> None:
    """Close this process's transport, if it was made."""
    global _transport
    with _transport_lock:
        if _transport is not None:
            _transport.close()
            _transport = None


def is_remote(device) -> bool:
    """Whether ``device`` (a torch.device, a device string, or a
    :class:`~accl_tpu_torch.utils.bringup.ProcessDevice`) belongs to
    another process."""
    return (isinstance(device, bringup.ProcessDevice)
            and device.process_index != bringup.process_index())


def process_of(device) -> int:
    """The process that holds ``device``: its own for a local one."""
    if isinstance(device, bringup.ProcessDevice):
        return device.process_index
    return bringup.process_index()


def local(device) -> torch.device:
    """A local ``device`` as a torch.device."""
    if isinstance(device, bringup.ProcessDevice):
        return device.device
    return torch.device(device)
