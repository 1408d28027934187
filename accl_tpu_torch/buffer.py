"""Buffer hierarchy: paired host/device storage with sync and slicing
(reference driver/xrt/include/accl/buffer.hpp:32-226).  The port's own
copy of ``accl_tpu/buffer.py:27-142``; the device-backed buffer lives in
backends/cuda.py."""
from __future__ import annotations

import numpy as np

from .arithconfig import NUMPY_TO_DATATYPE
from .constants import DataType


class BaseBuffer:
    """A typed span of host memory paired with a device residence;
    ``address`` is the opaque handle carried in descriptor words 9-14."""

    def __init__(self, host: np.ndarray, address: int = 0):
        if host.ndim != 1:
            host = host.reshape(-1)
        self._host = host
        self._address = address

    @property
    def host(self) -> np.ndarray:
        return self._host

    @property
    def address(self) -> int:
        return self._address

    @property
    def length(self) -> int:
        """Element count."""
        return int(self._host.size)

    @property
    def size(self) -> int:
        """Byte count."""
        return int(self._host.nbytes)

    @property
    def dtype(self) -> np.dtype:
        return self._host.dtype

    @property
    def data_type(self) -> DataType:
        return NUMPY_TO_DATATYPE[self._host.dtype]

    @property
    def is_dummy(self) -> bool:
        return False

    @property
    def is_host_only(self) -> bool:
        return False

    def sync_to_device(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def sync_from_device(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def slice(self, start: int, end: int) -> "BaseBuffer":
        """A sub-span sharing host storage, its address advanced by the
        byte offset (reference buffer.hpp slice())."""
        raise NotImplementedError

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx):
        return self._host[idx]

    def __setitem__(self, idx, val):
        self._host[idx] = val

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(len={self.length}, dtype={self.dtype}, "
                f"addr={self._address:#x})")


class DummyBuffer(BaseBuffer):
    """Placeholder for an absent operand: address 0, no data movement
    (reference dummybuffer.hpp)."""

    def __init__(self, dtype=np.float32):
        super().__init__(np.zeros(0, dtype=dtype), address=0)

    @property
    def is_dummy(self) -> bool:
        return True

    def sync_to_device(self) -> None:
        pass

    def sync_from_device(self) -> None:
        pass

    def slice(self, start: int, end: int) -> "DummyBuffer":
        return self
