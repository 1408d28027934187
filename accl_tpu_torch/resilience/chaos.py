"""Seeded chaos plans: the fault injector of the native emulator (the
port's own copy of ``accl_tpu/resilience/chaos.py``).

A :class:`ChaosPlan` arms the engine's egress funnel with a seeded,
probabilistic fault schedule: every eager data segment draws drop,
duplicate, delay or corrupt-seqn from a deterministic xorshift stream,
so a run replays bit for bit from its seed.  Slow-rank and kill-rank
complete the failure modes.

Grammar (``ACCL_CHAOS`` or :meth:`ChaosPlan.parse`)::

    seed=42,drop=0.01,dup=0.01,delay=0.02,delay_us=2000,corrupt=0.005,
    drop_rank=1:0.05,slow_rank=2:500,kill_rank=3,join_rank=3

- ``seed``: the RNG seed (per-rank streams decorrelate off it);
- ``drop``/``dup``/``delay``/``corrupt``: per-segment probabilities in
  [0, 1), eager data segments only (the control plane is never a
  target, so recovery stays deterministic);
- ``delay_us``: how long a delayed segment is held (default 2000); a
  delayed segment is reordered past its siblings;
- ``drop_rank=R:P``: rank R's egress alone drops with probability P;
- ``slow_rank=R:US``: rank R stalls its egress US µs a message;
- ``kill_rank=R``: rank R is marked for a kill (``EmuWorld.kill_rank``
  says when);
- ``join_rank=R``: rank R's death is healed by a replacement join
  (``EmuWorld.spawn_replacement``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from ..constants import ACCLError

_PROB_KEYS = ("drop", "dup", "delay", "corrupt")


def _ppm(p: float) -> int:
    """Probability -> parts per million (the engine's integer domain)."""
    return max(0, min(1_000_000, int(round(p * 1_000_000))))


@dataclass
class ChaosPlan:
    """One parsed chaos plan; ``apply(device, rank)`` arms a rank."""

    seed: int = 1
    drop: float = 0.0
    dup: float = 0.0
    delay: float = 0.0
    delay_us: int = 2000
    corrupt: float = 0.0
    #: rank -> its own egress drop probability (drop_rank=R:P)
    drop_ranks: dict = field(default_factory=dict)
    #: rank -> egress stall per message in µs (slow_rank)
    slow: dict = field(default_factory=dict)
    #: ranks marked for a kill (the harness chooses when)
    kills: list = field(default_factory=list)
    #: ranks whose death a replacement join heals
    joins: list = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        """Parse the ``k=v,...`` grammar of the module docstring."""
        plan = cls()
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ACCLError(f"ACCL_CHAOS item {item!r}: expected k=v")
            key, val = (s.strip() for s in item.split("=", 1))
            try:
                if key == "seed":
                    plan.seed = int(val, 0)
                elif key in _PROB_KEYS:
                    p = float(val)
                    if not 0.0 <= p < 1.0:
                        raise ValueError("probability must be in [0, 1)")
                    setattr(plan, key, p)
                elif key == "delay_us":
                    plan.delay_us = int(val)
                elif key == "drop_rank":
                    rank_s, _, p_s = val.partition(":")
                    p = float(p_s) if p_s else 0.05
                    if not 0.0 <= p < 1.0:
                        raise ValueError("probability must be in [0, 1)")
                    plan.drop_ranks[int(rank_s)] = p
                elif key == "slow_rank":
                    rank_s, _, us_s = val.partition(":")
                    plan.slow[int(rank_s)] = int(us_s) if us_s else 500
                elif key == "kill_rank":
                    plan.kills.append(int(val))
                elif key == "join_rank":
                    plan.joins.append(int(val))
                else:
                    raise ValueError("unknown key")
            except ValueError as e:
                raise ACCLError(
                    f"ACCL_CHAOS item {item!r}: {e} (grammar: seed=N,"
                    f"drop=P,dup=P,delay=P,delay_us=N,corrupt=P,"
                    f"drop_rank=R:P,slow_rank=R:US,kill_rank=R,"
                    f"join_rank=R)") from e
        return plan

    @classmethod
    def from_env(cls) -> Optional["ChaosPlan"]:
        """The ``ACCL_CHAOS`` plan, or None when it is unset or empty."""
        spec = os.environ.get("ACCL_CHAOS", "").strip()
        return cls.parse(spec) if spec else None

    @property
    def probabilistic(self) -> bool:
        return any(getattr(self, k) > 0 for k in _PROB_KEYS) \
            or any(p > 0 for p in self.drop_ranks.values())

    def apply(self, device, rank: int) -> None:
        """Arm one rank's engine (kills excluded: the harness triggers
        them)."""
        set_chaos = getattr(device, "set_chaos", None)
        if set_chaos is None:
            raise ACCLError(f"{type(device).__name__} has no chaos injector "
                            f"(chaos plans drive the native emulator)")
        set_chaos(seed=self.seed,
                  drop_ppm=_ppm(self.drop_ranks.get(rank, self.drop)),
                  dup_ppm=_ppm(self.dup), delay_ppm=_ppm(self.delay),
                  delay_us=self.delay_us, corrupt_ppm=_ppm(self.corrupt),
                  slow_us=int(self.slow.get(rank, 0)))

    def spec(self) -> str:
        """The plan as grammar (``parse(spec())`` equals it)."""
        parts = [f"seed={self.seed}"]
        parts += [f"{k}={getattr(self, k):g}" for k in _PROB_KEYS
                  if getattr(self, k) > 0]
        if self.delay > 0 or self.delay_us != 2000:
            parts.append(f"delay_us={self.delay_us}")
        parts += [f"drop_rank={r}:{p:g}"
                  for r, p in sorted(self.drop_ranks.items())]
        parts += [f"slow_rank={r}:{us}" for r, us in sorted(self.slow.items())]
        parts += [f"kill_rank={r}" for r in self.kills]
        parts += [f"join_rank={r}" for r in self.joins]
        return ",".join(parts)
