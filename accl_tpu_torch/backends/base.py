"""Abstract device backend ("CCLO") interface (reference
driver/xrt/include/accl/cclo.hpp:35-160): start a call descriptor
asynchronously, create buffers, install tables; and the defaults of
accl_tpu/backends/base.py:33-101 for device memory, kernel streams and
resilience, which a backend without them inherits."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import numpy as np

from ..arithconfig import ArithConfig
from ..buffer import BaseBuffer
from ..communicator import Communicator
from ..constants import CCLOCall
from ..request import Request


class CCLODevice(ABC):
    """One rank's view of the collective engine."""

    @abstractmethod
    def start(self, call: CCLOCall, request: Request) -> None:
        """Begin executing a call descriptor; ``request`` completes
        asynchronously with the engine retcode and duration."""

    @abstractmethod
    def create_buffer(self, length: int, dtype: np.dtype) -> BaseBuffer:
        ...

    @abstractmethod
    def setup_rx_buffers(self, n_bufs: int, buf_size: int) -> None:
        """Provision the eager rx pool (reference accl.cpp:1147-1212)."""

    @abstractmethod
    def upload_communicator(self, comm: Communicator) -> int:
        """Install a communicator table; returns the id used in word 2."""

    @abstractmethod
    def upload_arithconfig(self, cfg: ArithConfig) -> int:
        """Install an arithmetic config; returns its table id."""

    def set_tuning(self, key: int, value: int) -> None:
        """Write one runtime tuning register (constants.TuningKey)."""

    # -- device memory: only the native emulator has a flat memory -----
    def alloc_mem(self, nbytes: int, alignment: int = 64) -> int:
        raise NotImplementedError(f"{type(self).__name__} has no flat "
                                  f"device memory")

    def free_mem(self, address: int) -> None:
        raise NotImplementedError(f"{type(self).__name__} has no flat "
                                  f"device memory")

    def read_mem(self, address: int, nbytes: int) -> bytes:
        raise NotImplementedError(f"{type(self).__name__} has no flat "
                                  f"device memory")

    def write_mem(self, address: int, data: bytes) -> None:
        raise NotImplementedError(f"{type(self).__name__} has no flat "
                                  f"device memory")

    # -- kernel streams (reference data_to_cclo/data_from_cclo) ---------
    def push_krnl(self, data: np.ndarray) -> None:
        """Feed operand bytes into the compute-kernel input stream."""
        raise NotImplementedError(f"{type(self).__name__} has no kernel "
                                  f"streams")

    def pop_stream(self, strm: int, nbytes: int,
                   timeout_s: float = 10.0) -> Optional[bytes]:
        """Pull one message from a compute output stream."""
        raise NotImplementedError(f"{type(self).__name__} has no kernel "
                                  f"streams")

    # -- resilience (resilience/) ----------------------------------------
    def set_resilience(self, retry_max: int, retry_base_us: int) -> None:
        """Configure the NACK retransmission lane (0 retries = off); a
        backend with no wire has nothing to retransmit."""

    def abort_comm(self, comm_id: int, err_bits: int) -> bool:
        """Abort a communicator: finalize its pending calls with
        ``err_bits``.  True when the backend did so itself; False makes
        the driver fail its own pending requests on the comm."""
        return False

    def reset_errors(self) -> None:
        """Resynchronize after a classified fault (collective: every rank
        of a quiesced world calls it)."""

    def probe_liveness(self, comm_id: int, size: int,
                       window_s: float = 1.0) -> Optional[list]:
        """Per-comm-local-rank liveness, or None when the backend has no
        liveness plane (shrink then counts every rank alive)."""
        return None

    def sanitizer_domain(self):
        """Identity of the in-process world this device's ranks share,
        or None (accl_tpu/backends/base.py:104).  The collective sanitizer
        (``ACCL_SANITIZE=1``, analysis/sanitizer.py) keys its cross-rank
        call-fingerprint exchange on it, and ``capture_plan`` pools its
        cross-rank validation on it: every rank of one gang must return
        the same hashable value within one process.  None applies
        single-rank checks only."""
        return None

    def close(self) -> None:
        """Tear down the backend."""
