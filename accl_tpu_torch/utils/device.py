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


def resolve_devices(devices, nranks: int, what: str) -> list:
    """Rank r's device, ``devices[r]``, for ranks 0..nranks-1, the twin of
    ``TpuEngine(devices=)`` (accl_tpu/backends/tpu.py:231-241): at least
    ``nranks`` entries (the first ``nranks`` are used; fewer raise), one
    card may stand for several ranks, every entry is a card or every one
    is ``cpu``.  A card entry raises without a card, or naming a card
    this process does not have."""
    devs = list(devices)
    if len(devs) < nranks:
        raise ACCLError(f"{what}: need {nranks} devices, found {len(devs)}")
    devs = [torch.device(d) for d in devs[:nranks]]
    types = {d.type for d in devs}
    if types - {"cuda", "cpu"}:
        raise ACCLError(f"{what}: unsupported devices "
                        f"{sorted(str(d) for d in devs)}")
    if len(types) > 1:
        raise ACCLError(f"{what}: every rank's device must be a card, or "
                        f"every one the CPU; got {[str(d) for d in devs]}")
    if types == {"cpu"}:
        return devs
    if not torch.cuda.is_available():
        raise ACCLError(f"{what}: no CUDA device is available (pass "
                        f"devices=['cpu'] * {nranks} to run the plain "
                        f"versions on the CPU)")
    count = torch.cuda.device_count()
    out = []
    for d in devs:
        index = torch.cuda.current_device() if d.index is None else d.index
        if index >= count:
            raise ACCLError(f"{what}: no device cuda:{index} (this process "
                            f"has {count})")
        out.append(torch.device("cuda", index))
    return out
