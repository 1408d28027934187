"""Utilities of the port: logging, timing and profiling, checkpoints,
bring-up, the wire codec, the kernel build cache, trees, devices and
the ring topology.  Port of ``accl_tpu/utils``; its JAX shims
(``compat.py``, ``platform.py``) have no counterpart here."""
from .logging import get_logger  # noqa: F401
from .timing import Timer, timed  # noqa: F401
