"""Retransmission policy: the driver-side knobs of the NACK lane (the
port's own copy of ``accl_tpu/resilience/retry.py``).

The mechanism lives in the native engine (native/src/engine.cpp
``seek_recover`` / ``handle_nack``): a sender keeps a bounded store of
sent eager segments; a receiver whose seek misses NACKs the sender and
re-seeks with exponential backoff and deterministic jitter.  This module
resolves the policy from the environment and mirrors the backoff math.

- ``ACCL_RETRY_MAX``: NACK rounds per seek (default 4; 0 turns the lane
  off, the pure detect-and-classify behavior);
- ``ACCL_RETRY_BASE_US``: backoff base in µs (default 200); round k
  waits ``base * 2**k + jitter`` with ``jitter < base/2 + 1``.

The receive budget is unchanged: retransmission slices the same
``ACCL_DEFAULT_TIMEOUT`` window, so a loss that cannot heal classifies
on the same clock.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..constants import env_int

DEFAULT_RETRY_MAX = 4
DEFAULT_RETRY_BASE_US = 200


@dataclass(frozen=True)
class RetryPolicy:
    """The resolved retransmission policy; backends take it through
    ``device.set_resilience``."""

    max_retries: int = DEFAULT_RETRY_MAX
    base_us: int = DEFAULT_RETRY_BASE_US

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        # a negative knob is a typo: the naming ACCLError, not a clamp
        return cls(max_retries=env_int("ACCL_RETRY_MAX", DEFAULT_RETRY_MAX,
                                       minimum=0),
                   base_us=env_int("ACCL_RETRY_BASE_US",
                                   DEFAULT_RETRY_BASE_US, minimum=1))

    @property
    def enabled(self) -> bool:
        return self.max_retries > 0

    def backoff_us(self, attempt: int, rank: int = 0, seqn: int = 0) -> int:
        """The engine's backoff, bit for bit (engine.cpp seek_recover):
        exponential in the attempt, with a jitter keyed by (rank, seqn,
        attempt)."""
        base = self.base_us
        j = ((rank + 1) * 2654435761) ^ ((seqn + 1) * 40503) ^ attempt
        return (base << attempt) + (j & 0xFFFFFFFFFFFFFFFF) % (base // 2 + 1)

    def worst_case_recovery_us(self) -> int:
        """The backoff part of a recovery that exhausts every round."""
        return sum(self.backoff_us(a) for a in range(self.max_retries))
