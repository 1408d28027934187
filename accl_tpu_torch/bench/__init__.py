"""Benchmark and convergence lanes of the port (``accl_tpu/bench``):
``ef_convergence``, the int8 error-feedback convergence gate."""
