"""Device backends implementing the CCLO interface.

Port of ``accl_tpu/backends``.  Reference analog: the abstract `CCLO`
class with FPGADevice / SimDevice / CoyoteDevice implementations
(driver/xrt/include/accl/cclo.hpp:35).  The port's backends:

- ``CudaDeviceView`` (cuda.py) — the in-process gang engine on one card,
                                 the ranks regions of its memory, with
                                 the hand-written ring kernels (the JAX
                                 package's ``TpuDevice``, tpu.py).
- ``EmuDevice``      (emu.py)  — the native C++ collective engine
                                 (``native/libacclemu.so``, shared with
                                 the JAX package) over inproc/TCP
                                 transport (SimDevice analog).
"""

from .base import CCLODevice  # noqa: F401
