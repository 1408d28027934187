"""Topology-aware algorithm selection and persistent autotuning.

Port of the offline half of ``accl_tpu/tuning`` (HiCCL, arxiv
2408.05962; ACCL+ crossover points, arxiv 2312.11742):

- :mod:`~accl_tpu_torch.tuning.topology` — :class:`Fabric`, the axis
  model over :mod:`accl_tpu_torch.utils.topology`: a row-major grid
  (``ACCL_FABRIC=AxB`` or the near-square default), and
  ``from_link_matrix`` ingestion of a world's measured per-link traffic,
  so a slow link demotes its axis out of the heavy-traffic role.  On one
  card the fabric is logical: every link is a copy within the card.
- :mod:`~accl_tpu_torch.tuning.compose` — :class:`HierarchicalComm`,
  two-level collectives assembled from the driver primitives
  (reduce_scatter-within → allreduce-across → allgather-within and the
  scatter/gather/bcast analogues); ordinary driver calls, so a
  composition is capturable with ``ACCL.capture_plan``.
- :mod:`~accl_tpu_torch.tuning.autotune` — the persistent autotuner:
  sweeps (collective, dtype, size-bucket, world-shape, algorithm)
  through the bench sweep harness, persists a versioned JSON
  :class:`SelectionTable`, and a :class:`SelectionPolicy` the driver
  consults in ``_execute``.  Knobs: ``ACCL_TUNE_TABLE=path`` arms it,
  ``ACCL_TUNE=0`` restores the static thresholds bit for bit.
- :mod:`~accl_tpu_torch.tuning.cli` — the command line that writes a
  table (``python -m accl_tpu_torch.tuning.cli``).

The online tuner of the JAX package (``tuning/online.py``,
``ACCL_TUNE_ONLINE``) is not part of this port yet: a world refuses
``ACCL_TUNE_ONLINE`` instead of ignoring it.
"""
from .autotune import (  # noqa: F401
    SelectionPolicy,
    SelectionTable,
    TuneConfig,
    policy_from_env,
    tune,
)
from .compose import HierarchicalComm  # noqa: F401
from .topology import Fabric  # noqa: F401
