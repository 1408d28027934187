"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""
from __future__ import annotations

import torch

from ..constants import ACCLError


def resolve_device(device, what: str) -> torch.device:
    """``device`` as a torch.device: "cuda" (the default of every entry
    point) raises without a card; "cpu" runs the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ACCLError(f"{what}: no CUDA device is available (pass "
                        f"device='cpu' to run the plain versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ACCLError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
