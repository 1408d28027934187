"""Benchmark and convergence lanes of the port (``accl_tpu/bench``):
``ef_convergence``, the int8 error-feedback convergence gate; ``timing``,
the chained CUDA-event harness and the device/host split of launches; ``flash_sweep``, the flash schedule sweep;
``kernel_tune``, the flash and compression tuning sweeps; ``ring_split``
and ``matmul_split``, a tree's ring kernels and matmul kernels timed with
that split, to set two trees side by side; ``sweep``, busbw against size
per collective and per wire lane; ``callrate``, the driver's calls a
second by dispatch lane against the raw rate; ``driver_split``, the
driver call's microseconds, to set two trees side by side; ``selfring``,
the ring kernels' self-ring mode checked against its closed forms and
its GB/s."""

from .sweep import SweepConfig, run_sweep  # noqa: F401
