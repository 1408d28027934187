"""The ring kernels' allreduce across processes, one process a card,
beside the same allreduce from one process over the same cards.

    python -m accl_tpu_torch.bench.multiprocess --out FILE

For each size (``--mib``, MiB a rank, one rank a card over every card the
machine shows): the one-process cross-card mode (``ring.ring_all_reduce``
over per-card tensors) timed here, then one child process a card running
``accl_tpu_torch/scripts/run_multihost_rank.py --mode ring`` (its
allreduce across the processes, each bitwise that process's one-process
per-rank-table form, then timed), and each kernel alone at [P, n] a rank
(``--kernel-n``).  Rows: ms a call (host, each ending in a synchronize;
the slowest process's for the children), algbw = bytes a rank / s and
busbw = algbw 2 (P - 1) / P, as chip_smoke.py's driver rows count them.
Card only.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

MIB = 1 << 20


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_process_ms(cards: list, mib: int, reps: int) -> float:
    """Host ms of one cross-card allreduce from this process, one rank a
    card (median of ``reps`` after a warm-up, each synchronizing every
    card)."""
    from accl_tpu_torch.ops import ring

    xs = [torch.randn(mib * MIB // 4, device=f"cuda:{c}") for c in cards]

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    ring.ring_all_reduce(xs)
    sync()
    got = []
    for _ in range(reps):
        t = time.perf_counter()
        ring.ring_all_reduce(xs)
        sync()
        got.append((time.perf_counter() - t) * 1e3)
    del xs
    torch.cuda.empty_cache()
    return statistics.median(got)


def children(n: int, args: list, timeout: float) -> list:
    """The MULTIHOST_RESULT objects of ``n`` children of
    ``scripts/run_multihost_rank.py`` with ``args``, each given ``timeout``
    seconds.  A child that fails raises RuntimeError with the end of every
    failed child's output."""
    port = _free_port()
    cmd = [sys.executable, "-m", "accl_tpu_torch.scripts.run_multihost_rank",
           *args]
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"p{p}.log"), "w+") for p in range(n)]
        procs = [subprocess.Popen(
            cmd, stdout=logs[p], stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "ACCL_COORDINATOR": f"127.0.0.1:{port}",
                 "ACCL_NUM_PROCESSES": str(n), "ACCL_PROCESS_ID": str(p)})
            for p in range(n)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    results, failed = [], []
    for p, (proc, out) in enumerate(zip(procs, outs)):
        got = [json.loads(ln.split(" ", 1)[1]) for ln in out.splitlines()
               if ln.startswith("MULTIHOST_RESULT ")]
        if proc.returncode != 0 or not got or \
                f"MULTIHOST_OK process={p}" not in out:
            failed.append(f"--- child {p} exited {proc.returncode} ---\n"
                          f"{out[-8000:]}")
        else:
            results.append(got[-1])
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", default="4,64,256")
    ap.add_argument("--kernel-n", type=int, default=1 << 21,
                    help="each kernel's chunk a rank (default 8 MiB fp32)")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("multiprocess bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from accl_tpu_torch.ops import _build

    _build.build_all()
    sizes = [int(v) for v in args.mib.split(",")]
    C = torch.cuda.device_count()
    cards = list(range(C))
    info = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    rows = []
    one = {mib: one_process_ms(cards, mib, 5) if C > 1 else None
           for mib in sizes}
    got = children(C, ["--device", "cuda:{process}", "--ranks", "1",
                       "--mode", "ring", "--mib", args.mib,
                       "--kernel-n", str(args.kernel_n)], args.timeout)
    for i, mib in enumerate(sizes):
        ms = max(r["ring"]["sizes"][i]["host_ms"] for r in got)
        row = {"mib_per_rank": mib, "ranks": C, "processes": C,
               "procs_ms": ms,
               "procs_device_ms": max(r["ring"]["sizes"][i]["device_ms"]
                                      for r in got),
               "one_process_ms": one[mib]}
        for form in ("procs", "one_process"):
            if row[f"{form}_ms"] is not None:
                algbw = mib * MIB / (row[f"{form}_ms"] / 1e3) / 1e9
                row[f"{form}_busbw_GBps"] = algbw * 2 * (C - 1) / C
        rows.append(row)
        print(json.dumps(row), flush=True)
    kernels = [k for r in got for k in r["ring"].get("kernels", [])]
    for name in ("ring_reduce_scatter", "ring_all_gather"):
        ks = [k for k in kernels if k["name"] == name]
        row = {"kernel": name, "ranks": C, "n": args.kernel_n,
               "ms": max(k["ms"] for k in ks),
               "host_ms": max(k["host_ms"] for k in ks),
               "plain_ms": max(k["plain_ms"] for k in ks),
               "bitwise": all(k["bitwise"] for k in ks),
               "launches_procs": [r["ring"]["launches_procs"][name]
                                  for r in got]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"cards": info, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"cards": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
