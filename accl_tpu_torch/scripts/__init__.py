"""The command-line tools of the port, run as ``python -m
accl_tpu_torch.scripts.<name>`` from the repo's root: the twins of the
JAX package's ``scripts/`` of the same file names (``perf_doctor``,
``retune_smoke``, ``accl_lint``, ``slo_soak``) and ``graft_entry``, the
CUDA twin of ``__graft_entry__.py``."""
