"""Benchmark and convergence lanes of the port (``accl_tpu/bench``):
``ef_convergence``, the int8 error-feedback convergence gate; ``timing``,
the chained CUDA-event harness; ``flash_sweep``, the flash schedule sweep;
``kernel_tune``, the flash and compression tuning sweeps."""
