"""Abstract device backend ("CCLO") interface (reference
driver/xrt/include/accl/cclo.hpp:35-160): start a call descriptor
asynchronously, create buffers, install tables."""
from __future__ import annotations

from abc import ABC, abstractmethod

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

    def close(self) -> None:
        """Tear down the backend."""
