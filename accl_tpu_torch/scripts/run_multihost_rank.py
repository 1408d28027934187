"""One host process of a run over several processes, on the port.

The twin of ``scripts/run_multihost_rank.py``: each process joins the
others through ``utils.bringup.initialize_multihost`` (the ``ACCL_*``
environment: ``ACCL_COORDINATOR``, ``ACCL_NUM_PROCESSES``,
``ACCL_PROCESS_ID``), builds the hybrid dcn x ici mesh over its own
devices (``make_hybrid_mesh({"ici": R}, {"dcn": N}, devices=[dev] * R)``,
the dcn axis over the processes) and runs what ``--mode`` names, one or
more of, comma-separated:

- ``collectives`` (the default): ``hierarchical_all_reduce`` and a flat
  ``all_reduce`` as the JAX script does, then ``ring_all_reduce``,
  ``all_gather``, ``reduce_scatter``, ``ppermute``, ``all_to_all``,
  ``broadcast``, ``scatter`` and ``barrier``, on integer-valued
  float32 data from a numpy seed (every member's row drawn in every
  process, each keeping its own), checked against numpy on its own
  members; the crossings between processes each function makes are
  counted (``collectives.process_moves``);
- ``ring`` (the card only): the ring kernels' allreduce across the
  processes at ``--mib`` MiB a rank, each bitwise this process's
  one-process per-rank-table form of every rank (``ring.rank_tables()``),
  counted, then timed (ms a call, host and device);
  ``hierarchical_all_reduce`` on N(0, 1) rows bitwise the one-process
  call; and, with ``--kernel-n``, each kernel alone at [P, n] a rank
  with its ms a launch and its plain version's (every hop between the
  processes an IPC message);
- ``step``: the dp 2 x tp 2 train step, dp over the processes (two of
  them), ``--config`` tiny or llama3-8b (Llama-3-8B width, ``--layers``
  deep), SGD and AdamW (``--opts``), ``--steps`` steps each; the losses
  and each updated leaf are written out (tiny: the leaves; llama3-8b: a
  fingerprint of each);
- ``die``: process 1 kills itself just after its first send inside an
  ``all_reduce``; the others must raise ``ACCLError`` naming it.

It runs on the card unless ``--device cpu`` is given: ``--device`` is a
card (``cuda:{process}`` takes the process's id), and every rank of a
process sits on it.  Results go to ``--out``/``proc<id>.npz`` and, as
one JSON object, to the line ``MULTIHOST_RESULT ...``; the last line is
``MULTIHOST_OK process=<id>``.

    ACCL_COORDINATOR=127.0.0.1:29500 ACCL_NUM_PROCESSES=2 ACCL_PROCESS_ID=0 \\
        python -m accl_tpu_torch.scripts.run_multihost_rank --device cpu &
    ACCL_COORDINATOR=127.0.0.1:29500 ACCL_NUM_PROCESSES=2 ACCL_PROCESS_ID=1 \\
        python -m accl_tpu_torch.scripts.run_multihost_rank --device cpu
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys
import time

import numpy as np
import torch

SEED = 7
#: the elements of a member's row in mode collectives, and the roots of
#: its broadcast and scatter
ROW = 64
BCAST_ROOT, SCATTER_ROOT = 5, 6
#: the tiny step's model: 2 layers, narrow widths
TINY = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=64,
            attn="dense")
#: Meta's config.json for meta-llama/Meta-Llama-3-8B (chip_smoke.LLAMA3_8B)
LLAMA3_8B = dict(vocab=128256, d_model=4096, n_heads=32, n_kv_heads=8,
                 d_head=128, d_ff=14336, mlp="swiglu", rope=True,
                 rope_theta=500000.0, attn="flash", dtype="float32")
#: the step's tokens: each dp member's rows and their length
STEP_TOKENS = {"tiny": (2, 16), "llama3-8b": (2, 1024)}
LR = {"sgd": 0.1, "adamw": 1e-3}
MIB = 1 << 20


def emit(obj: dict) -> None:
    print("MULTIHOST_RESULT " + json.dumps(obj), flush=True)


def fingerprint(t: torch.Tensor) -> list:
    """Two 64-bit sums of ``t``'s 32-bit words (plain, and each word times
    its position mod 2^31 - 1, plus 1), computed on its device a slice at
    a time: equal for equal bits."""
    words = t.detach().contiguous().reshape(-1).view(torch.int32)
    plain = weighted = 0
    step = 1 << 24
    for i in range(0, words.numel(), step):
        w = words[i:i + step].to(torch.int64)
        pos = torch.arange(i, i + w.numel(), device=w.device) % 2147483647 + 1
        plain += int(w.sum())
        weighted += int((w * pos).sum())
    return [plain, weighted]


def step_config(M, name: str, layers: int):
    if name == "tiny":
        return M.ModelConfig(**TINY)
    return M.ModelConfig(**{**LLAMA3_8B, "n_layers": layers})


def step_inputs(M, cfg, name: str, device):
    """The step's full parameters and tokens, the same in every process
    and in a one-process reference: numpy draws for the tiny model, a
    card generator's for Llama-3-8B width."""
    rows, T = STEP_TOKENS[name]
    if name == "tiny":
        rng = np.random.default_rng(SEED)
        params = M.init_params(rng, cfg, tp=1, device=device)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2 * rows, T)))
        return params, tokens.to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = M.init_params(gen, cfg, tp=1, device=device)
    tokens = torch.randint(0, cfg.vocab, (2 * rows, T), generator=gen,
                           device=device)
    return params, tokens


def run_steps(M, mesh, cfg, params, tokens, steps: int,
              opts=("sgd", "adamw")) -> dict:
    """SGD and AdamW steps (``opts``) of the dp x tp mesh from ``params``
    (placed anew for each): every process's own trees (``None`` for
    another's), their AdamW states, the losses and the seconds a step."""
    from accl_tpu_torch.optim import adamw

    out = {}
    for opt in opts:
        reps = M.place_params(params, cfg, mesh)
        if opt == "sgd":
            step, _ = M.make_train_step(mesh, cfg, lr=LR["sgd"])
            state = None
        else:
            step, _s, init = M.make_train_step(
                mesh, cfg, optimizer=adamw(LR["adamw"]), params=reps)
            state = init(reps)
        losses, secs = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            if opt == "sgd":
                reps, loss = step(reps, tokens)
            else:
                reps, state, loss = step(reps, state, tokens)
            float(loss)
            secs.append(time.perf_counter() - t0)
            losses.append(loss.detach().cpu())
        out[opt] = {"trees": M.placed_trees(reps), "losses": losses,
                    "state": state, "s_per_step": secs}
        del reps, state
    return out


def step_leaves(M, cfg, tree, state) -> dict:
    """name -> tensor of a tree's leaves (split over tp as placed) and,
    with an AdamW state, its moments."""
    from accl_tpu_torch.utils.tree import tree_leaves

    out = {f"p{i}": t for i, t in enumerate(tree_leaves(dict(tree)))}
    if state is not None:
        for name in ("mu", "nu"):
            for i, t in enumerate(tree_leaves(dict(getattr(state, name)))):
                out[f"{name}{i}"] = t
    return out


def mode_collectives(S, mesh, P, R, arrays) -> dict:
    C = S.collectives
    devs = list(mesh.devices)
    glob = np.random.default_rng(SEED).integers(
        -64, 64, size=(P, ROW)).astype(np.float32)
    xs = [torch.from_numpy(glob[s]).to(devs[s]) if mesh.is_local(s)
          else None for s in range(P)]
    D = P // R
    grid = [xs[d * R:(d + 1) * R] for d in range(D)]
    gdevs = [devs[d * R:(d + 1) * R] for d in range(D)]
    perm = [(s, (s + 1) % P) for s in range(P)]
    calls = {
        "hierarchical_all_reduce": lambda: [
            x for row in S.hierarchical_all_reduce(grid, devices=gdevs)
            for x in row],
        "all_reduce": lambda: S.all_reduce(xs, devices=devs),
        "ring_all_reduce": lambda: S.ring_all_reduce(xs, devices=devs),
        "all_gather": lambda: S.all_gather(xs, devices=devs),
        "reduce_scatter": lambda: S.reduce_scatter(xs, devices=devs),
        "ppermute": lambda: S.ppermute(xs, perm, devices=devs),
        "all_to_all": lambda: S.all_to_all(xs, devices=devs),
        "broadcast": lambda: S.broadcast(xs, BCAST_ROOT % P, devices=devs),
        "scatter": lambda: S.scatter(
            [None if x is None else x.view(P, -1) for x in xs],
            SCATTER_ROOT % P, devices=devs),
        "barrier": lambda: S.barrier(xs, devices=devs),
    }
    total = glob.sum(axis=0)
    blocks = glob.reshape(P, P, -1)
    want = {"hierarchical_all_reduce": lambda s: total,
            "all_reduce": lambda s: total, "ring_all_reduce": lambda s: total,
            "all_gather": lambda s: glob.reshape(-1),
            "reduce_scatter": lambda s: total.reshape(P, -1)[s],
            "ppermute": lambda s: glob[(s - 1) % P],
            "all_to_all": lambda s: blocks[:, s].reshape(-1),
            "broadcast": lambda s: glob[BCAST_ROOT % P],
            "scatter": lambda s: blocks[SCATTER_ROOT % P, s],
            "barrier": lambda s: np.array(P, dtype=np.int32)}
    counts = {}
    for name, call in calls.items():
        C.reset_moves()
        got = call()
        counts[name] = {"moves": C.moves(),
                        "process_moves": C.process_moves()}
        for s in range(P):
            if (got[s] is None) == mesh.is_local(s):
                raise AssertionError(f"{name}: member {s}'s result "
                                     f"{'missing' if got[s] is None else 'given'}")
            if got[s] is None:
                continue
            a = got[s].cpu().numpy()
            if not np.array_equal(a, want[name](s)):
                raise AssertionError(f"{name}: member {s} differs")
            arrays[f"{name}/{s}"] = a
    return {"moves": counts}


def mode_ring(ring, S, mesh, P, sizes, kernel_n) -> dict:
    """Mode ring (the card only): module docstring.  The ring kernels'
    counts are set to 0 just before the counted calls (one allreduce a
    size) and read just after; the timed calls and the kernel rows come
    after them."""
    devs = list(mesh.devices)
    local = mesh.local_slots
    dev = devs[local[0]]
    out = {"sizes": []}
    counters = (ring.ring_reduce_scatter, ring.ring_all_gather)
    inputs = {}
    for fn in counters:
        fn.launches = fn.launches_cross = fn.launches_procs = 0
    for mib in sizes:
        count = mib * MIB // 4
        gen = torch.Generator(device=dev).manual_seed(SEED + mib)
        every = [torch.randn(count, generator=gen, device=dev)
                 for _ in range(P)]
        xs = [every[s] if s in local else None for s in range(P)]
        got = ring.ring_all_reduce(xs, devices=devs)
        with ring.rank_tables():
            want = ring.ring_all_reduce(every)
        if not all(torch.equal(got[s], want[s]) for s in local):
            raise AssertionError(f"ring allreduce at {mib} MiB: not bitwise "
                                 f"the one-process per-rank-table form")
        inputs[mib] = xs
        del every, got, want
    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    out["launches_cross"] = {fn.__name__: fn.launches_cross
                             for fn in counters}
    out["launches_procs"] = {fn.__name__: fn.launches_procs
                             for fn in counters}
    out["hierarchical_all_reduce"] = hierarchical_check(S, mesh, P, dev)
    for mib, xs in inputs.items():
        row = {"mib_per_rank": mib, "ranks": P, "bitwise": True}
        call = lambda: ring.ring_all_reduce(xs, devices=devs)  # noqa: E731
        call()
        torch.cuda.synchronize(dev)
        host, device_ms = [], []
        for _ in range(5 if mib <= 16 else 3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            call()
            b.record()
            torch.cuda.synchronize(dev)
            host.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(a.elapsed_time(b))
        row["host_ms"] = float(np.median(host))
        row["device_ms"] = float(np.median(device_ms))
        out["sizes"].append(row)
    del inputs
    torch.cuda.empty_cache()
    if kernel_n:
        out["kernels"] = kernel_rows(ring, devs, local, P, kernel_n)
    return out


def hierarchical_check(S, mesh, P, dev) -> dict:
    """``hierarchical_all_reduce`` across the processes on N(0, 1) rows
    (1 MiB a member), bitwise the same call with every member in this
    process."""
    devs = list(mesh.devices)
    R = len(mesh.local_slots)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    every = [torch.randn(MIB // 4, generator=gen, device=dev)
             for _ in range(P)]
    xs = [every[s] if mesh.is_local(s) else None for s in range(P)]
    D = P // R
    got = S.hierarchical_all_reduce(
        [xs[d * R:(d + 1) * R] for d in range(D)],
        devices=[devs[d * R:(d + 1) * R] for d in range(D)])
    want = S.hierarchical_all_reduce(
        [every[d * R:(d + 1) * R] for d in range(D)],
        devices=[[dev] * R] * D)
    bitwise = all(torch.equal(got[d][i], want[d][i]) for d in range(D)
                  for i in range(R) if got[d][i] is not None)
    if not bitwise:
        raise AssertionError("hierarchical_all_reduce: not bitwise the "
                             "one-process call")
    return {"bitwise": bitwise, "members": P}


def kernel_rows(ring, devs, local, P, n) -> list:
    """ms per launch of each ring kernel across the processes at [P, n]
    fp32 a rank, beside its plain version across them (every hop between
    processes an IPC message) and the bitwise check."""
    dev = devs[local[0]]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    every = [torch.randn(P, n, generator=gen, device=dev) for _ in range(P)]
    xs = [every[s] if s in local else None for s in range(P)]
    rs_out = [torch.empty(n, device=dev) if s in local else None
              for s in range(P)]
    ag_in = [None if x is None else x[0].contiguous() for x in xs]
    ag_out = [torch.empty(P, n, device=dev) if s in local else None
              for s in range(P)]
    rows = []
    for name, kern, plain in (
            ("ring_reduce_scatter",
             lambda: ring.ring_reduce_scatter(xs, out=rs_out, devices=devs),
             lambda: ring.ring_reduce_scatter_plain(xs, devices=devs)),
            ("ring_all_gather",
             lambda: ring.ring_all_gather(ag_in, out=ag_out, devices=devs),
             lambda: ring.ring_all_gather_plain(ag_in, devices=devs))):
        got = [None if t is None else t.clone() for t in kern()]
        want = plain()
        err = max(float((got[s].double() - want[s].double()).abs().max())
                  for s in local)
        bitwise = all(torch.equal(got[s], want[s]) for s in local)
        timed = {}
        for form, call, iters in (("kernel", kern, 20), ("plain", plain, 3)):
            call()
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            for _ in range(iters):
                call()
            b.record()
            torch.cuda.synchronize(dev)
            timed[form] = a.elapsed_time(b) / iters
            timed[form + "_host"] = (time.perf_counter() - t0) * 1e3 / iters
        rows.append({"name": name, "ranks": P, "n": n, "bitwise": bitwise,
                     "max_abs_err": err, "ms": timed["kernel"],
                     "host_ms": timed["kernel_host"],
                     "plain_ms": timed["plain"],
                     "plain_host_ms": timed["plain_host"]})
    return rows


def mode_step(M, S, args, dev, arrays) -> dict:
    from accl_tpu_torch.utils import bringup

    if bringup.process_count() != 2:
        raise SystemExit("mode step: dp 2 x tp 2 needs two processes")
    cfg = step_config(M, args.config, args.layers)
    params, tokens = step_inputs(M, cfg, args.config, dev)
    mesh = S.make_mesh(dp=2, tp=2, devices=[dev] * 2)
    got = run_steps(M, mesh, cfg, params, tokens, args.steps,
                    args.opts.split(","))
    del params
    out = {}
    for opt, res in got.items():
        (d,) = [d for d, t in enumerate(res["trees"]) if t is not None]
        tree = res["trees"][d]
        state = res["state"][d] if res["state"] is not None else None
        leaves = step_leaves(M, cfg, tree, state)
        out[opt] = {"member": d,
                    "losses": [float(v) for v in res["losses"]],
                    "loss_bits": [int(v.view(torch.int32))
                                  for v in res["losses"]],
                    "s_per_step": res["s_per_step"]}
        if args.config == "tiny":
            for k, t in leaves.items():
                arrays[f"step/{opt}/{k}"] = t.detach().cpu().numpy()
        else:
            out[opt]["fingerprints"] = {k: fingerprint(t)
                                        for k, t in leaves.items()}
    return out


def mode_die(S, mesh, P) -> None:
    """Process 1 kills itself after its first send inside an all_reduce;
    every other process must raise naming it."""
    from accl_tpu_torch.constants import ACCLError
    from accl_tpu_torch.utils import bringup, ipc

    devs = list(mesh.devices)
    xs = [torch.ones(ROW, device=devs[s]) if mesh.is_local(s) else None
          for s in range(P)]
    if bringup.process_index() == 1:
        tr = ipc.transport()
        send = tr.send

        def send_then_die(*a, **kw):
            send(*a, **kw)
            os.kill(os.getpid(), signal.SIGKILL)

        tr.send = send_then_die
    t0 = time.perf_counter()
    try:
        S.all_reduce(xs, devices=devs)
    except ACCLError as e:
        emit({"died": str(e), "seconds": time.perf_counter() - t0,
              "session": ipc.transport().session})
        ipc.close()
        print(f"MULTIHOST_PEER_LOST process={bringup.process_index()}",
              flush=True)
        sys.exit(3)
    raise AssertionError("all_reduce finished without its peer")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cpu, or the card of this process's ranks "
                         "('cuda:{process}': one card a process)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks (mesh slots) a process")
    ap.add_argument("--mode", default="collectives")
    ap.add_argument("--mib", default="4,64",
                    help="mode ring: MiB a rank, comma-separated")
    ap.add_argument("--kernel-n", type=int, default=0,
                    help="mode ring: time each kernel at [P, n] a rank")
    ap.add_argument("--config", default="tiny",
                    choices=sorted(STEP_TOKENS))
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--opts", default="sgd,adamw",
                    help="mode step: the optimizers, comma-separated")
    ap.add_argument("--out", default=None, help="a directory for the npz")
    args = ap.parse_args(argv)

    from accl_tpu_torch import models as M
    from accl_tpu_torch import parallel as S
    from accl_tpu_torch.ops import ring
    from accl_tpu_torch.utils import bringup, ipc

    torch.backends.cuda.matmul.allow_tf32 = False
    kwargs = bringup.initialize_multihost()
    me, N = bringup.process_index(), bringup.process_count()
    dev = torch.device(args.device.format(process=me))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", 0)
        # the process's card is its current one: its events and streams
        torch.cuda.set_device(dev)
    R = args.ranks
    mesh = S.make_hybrid_mesh({"ici": R}, {"dcn": N}, devices=[dev] * R)
    assert mesh.shape == ({"dcn": N, "ici": R} if R > 1 else {"dcn": N}), \
        mesh.shape
    result = {"process": me, "session": ipc.transport().session,
              "devices": [str(d) for d in bringup.devices()],
              "local_devices": [str(d) for d in bringup.local_devices()],
              "local_slots": list(mesh.local_slots),
              "device_grid": [str(d) for d in mesh.device_grid.reshape(-1)]}
    arrays = {}
    modes = args.mode.split(",")
    for mode in modes:
        if mode == "collectives":
            result["collectives"] = mode_collectives(S, mesh, N * R, R,
                                                     arrays)
        elif mode == "ring":
            result["ring"] = mode_ring(
                ring, S, mesh, N * R, [int(v) for v in args.mib.split(",")],
                args.kernel_n)
        elif mode == "step":
            result["step"] = mode_step(M, S, args, dev, arrays)
        elif mode == "die":
            mode_die(S, mesh, N * R)
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    result["process_crossings"] = ipc.transport().crossings
    if args.out:
        np.savez(os.path.join(args.out, f"proc{me}.npz"), **arrays)
    emit(result)
    S.barrier([torch.zeros(()) if mesh.is_local(s) else None
               for s in range(mesh.size)], devices=list(mesh.devices))
    ipc.close()
    digest = hashlib.sha256(json.dumps(result, sort_keys=True).encode())
    print(f"MULTIHOST_OK process={kwargs.get('process_id')} "
          f"digest={digest.hexdigest()[:12]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
