"""Finding model shared by the static checkers and the lint CLI.

Port of ``accl_tpu/analysis/findings.py``, whole."""
from __future__ import annotations

from dataclasses import dataclass, field

#: severity order, most severe first (the CLI prints in this order and
#: exits nonzero iff any ERROR survived)
ERROR = "error"
WARNING = "warning"
INFO = "info"
_SEVERITY_RANK = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclass
class Finding:
    """One checker verdict: what is wrong, where, and how to fix it."""

    severity: str        # ERROR / WARNING / INFO
    code: str            # stable machine id, e.g. "desync-order"
    message: str         # one-sentence statement of the defect
    hint: str = ""       # concrete fix suggestion
    comm: int = -1       # communicator, -1 when not comm-scoped
    ranks: list = field(default_factory=list)  # implicated global ranks
    index: int = -1      # program/gang position, -1 when not positional

    def render(self) -> str:
        loc = []
        if self.comm >= 0:
            loc.append(f"comm {self.comm}")
        if self.index >= 0:
            loc.append(f"call #{self.index}")
        if self.ranks:
            loc.append(f"ranks {self.ranks}")
        where = f" [{', '.join(loc)}]" if loc else ""
        out = f"{self.severity.upper()} {self.code}{where}: {self.message}"
        if self.hint:
            out += f"\n    fix: {self.hint}"
        return out

    def to_dict(self) -> dict:
        return {
            "severity": self.severity, "code": self.code,
            "message": self.message, "hint": self.hint,
            "comm": self.comm, "ranks": self.ranks, "index": self.index,
        }


def sort_findings(findings: list) -> list:
    """Severity-ranked, then comm/position for stable output."""
    return sorted(findings, key=lambda f: (
        _SEVERITY_RANK.get(f.severity, 3), f.comm, f.index, f.code))


def has_errors(findings: list) -> bool:
    return any(f.severity == ERROR for f in findings)
