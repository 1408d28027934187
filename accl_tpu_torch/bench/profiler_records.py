"""How many of a window's kernels a torch.profiler capture keeps, by the
time since the process's first capture.

Each window launches one kind of work on the card, synchronizes, and is
captured by ``torch.profiler`` (CPU and CUDA activity); the exported
Chrome trace's host launches are matched with its device records
(``profiling.unrecorded_launches``).  Windows run right after the first
capture, after IDLE_S seconds idle and after BUSY_S seconds of matmuls
and allreduces, each plain, with a 0.3 s sleep before the work, with a
sleep of each of PADS_S before the window closes, and with
``acc_events=True``.
The work is a 64 MiB allreduce on ``CudaWorld(8)`` (two ring kernel
launches) or four ``torch.matmul`` of 2048 x 2048.  One JSON line per
window: its ``launched`` and ``missing`` counts, the process age and
``time.time_ns() - time.monotonic_ns()`` (a step of the host clock would
show there).  Environment knobs of the profiler (``TEARDOWN_CUPTI=0``,
``KINETO_LOG_LEVEL=1``, whose log counts the dropped records as
``Out-of-range``) are the caller's.

Usage (on the card):
  python -m accl_tpu_torch.bench.profiler_records
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

IDLE_S = 40.0
BUSY_S = 30.0
PADS_S = (0.3, 1.0, 3.0)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profiler_records: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .. import CudaWorld, ReduceFunction
    from ..utils.profiling import unrecorded_launches

    count = 64 * 2**20 // 4
    world = CudaWorld(8)
    sends = [a.create_buffer(count, np.float32) for a in world.accls]
    recvs = [a.create_buffer(count, np.float32) for a in world.accls]
    for b in sends:
        b.dev.normal_()
    x = torch.randn(2048, 2048, device="cuda")

    def ring():
        world.run(lambda a, r: a.allreduce(
            sends[r], recvs[r], count, function=ReduceFunction.SUM,
            from_fpga=True, to_fpga=True))

    def mm():
        for _ in range(4):
            (x @ x).sum()

    t0 = time.monotonic()
    tmp = tempfile.mkdtemp()

    def window(stage, kind, pre=0.0, post=0.0, acc=False):
        path = os.path.join(tmp, f"{time.time_ns()}.json")
        skew = (time.time_ns() - time.monotonic_ns()) / 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     **({"acc_events": True} if acc else {})) as prof:
            time.sleep(pre)
            (ring if kind == "ring" else mm)()
            torch.cuda.synchronize()
            time.sleep(post)
        prof.export_chrome_trace(path)
        with open(path) as f:
            missing, launched = unrecorded_launches(json.load(f))
        os.remove(path)
        print(json.dumps({
            "stage": stage, "work": kind, "pre_s": pre, "post_s": post,
            "acc_events": acc, "age_s": round(time.monotonic() - t0, 1),
            "launched": launched, "missing": missing,
            "wall_minus_monotonic_us": skew}), flush=True)

    def windows(stage):
        for kind in ("ring", "mm"):
            window(stage, kind)
            window(stage, kind, pre=0.3)
            for pad in PADS_S:
                window(stage, kind, post=pad)
            window(stage, kind, acc=True)

    ring()
    mm()
    torch.cuda.synchronize()
    try:
        windows("first")
        time.sleep(IDLE_S)
        windows(f"after {IDLE_S:g} s idle")
        t = time.monotonic()
        while time.monotonic() - t < BUSY_S:
            mm()
            ring()
        torch.cuda.synchronize()
        windows(f"after {BUSY_S:g} s busy")
    finally:
        for b in sends + recvs:
            b.free()
        world.close()
        os.rmdir(tmp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
