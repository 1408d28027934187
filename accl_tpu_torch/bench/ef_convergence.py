"""EF-convergence lane: does error feedback close the int8 wire gap?

Port of ``accl_tpu/bench/ef_convergence.py``.  Three lanes train the
flagship transformer LM under data parallelism with identical init, data
order and learning rate; only the gradient all-reduce differs:

* ``fp32``    - the exact mean over the dp members (the reference
  trajectory);
* ``int8``    - the quantized ring, no error carry;
* ``int8_ef`` - the quantized ring with per-hop error feedback.

Everything is deterministic (no stochastic rounding, fixed seeds), so
the recorded divergence is quantization arithmetic, not noise.  The gate:
every quantized lane's mean |loss - fp32| over the run stays under
``TRACK_TOL``.  Parameters and tokens come from the same numpy seed as
the JAX package's lane, so the two packages train the same model on the
same bytes.
"""
from __future__ import annotations

import csv
from typing import Optional, Sequence

import numpy as np
import torch

#: lane -> (compress, error_feedback) for sync_gradients
LANES = {
    "fp32": (None, False),
    "int8": ("int8", False),
    "int8_ef": ("int8", True),
}

#: gate: a quantized lane's mean |loss - fp32| over the run must stay
#: under this (the JAX package's bound)
TRACK_TOL = 5e-3


def _make_step(cfg, lane: str, lr: float, dp: int):
    """One SGD step of a lane over ``dp`` data-parallel members.  The
    parameters are held once (every member would hold the same copy);
    ``tokens`` [dp, batch, seq] gives member d its slice.  Each member's
    gradient of its local mean loss goes through ``sync_gradients`` over
    the dp list; the returned loss is the members' mean.  The update is
    applied in place."""
    from ..models.transformer import loss_fn
    from ..parallel.strategies import sync_gradients
    from ..utils.tree import tree_leaves

    compress, ef = LANES[lane]

    def step(params, tokens):
        leaves = tree_leaves(params)
        grads, losses = [], []
        for d in range(dp):
            for p in leaves:
                p.requires_grad_(True)
            s, c = loss_fn(params, tokens[d], cfg)
            loss = s / c
            grads.append(list(torch.autograd.grad(loss, leaves)))
            losses.append(loss.detach())
            for p in leaves:
                p.requires_grad_(False)
        synced = sync_gradients(grads, compress=compress, mean=True,
                                error_feedback=ef)[0]
        with torch.no_grad():
            for p, g in zip(leaves, synced):
                p.sub_(g.to(p.dtype) * lr)
        return params, torch.stack(losses).mean()

    return step


def make_tokens(rng: np.random.Generator, vocab: int, steps: int, dp: int,
                batch: int, seq: int) -> np.ndarray:
    """The whole run's token stream [steps, dp, batch, seq], the JAX lane's
    draws: a noisy successor chain (next = prev + 1 mod vocab, 10%
    resets), so the trajectories descend."""
    tokens = np.empty((steps, dp, batch, seq), np.int32)
    tokens[..., 0] = rng.integers(0, vocab, size=(steps, dp, batch))
    for t in range(1, seq):
        succ = (tokens[..., t - 1] + 1) % vocab
        noise = rng.integers(0, vocab, size=(steps, dp, batch))
        keep = rng.random(size=(steps, dp, batch)) < 0.9
        tokens[..., t] = np.where(keep, succ, noise)
    return tokens


def run_ef_convergence(writer, steps: int = 40, dp: int = 4,
                       batch: int = 4, seq: int = 32, lr: float = 0.2,
                       seed: int = 0,
                       lanes: Sequence[str] = ("fp32", "int8", "int8_ef"),
                       log=lambda s: None, device="cuda") -> dict:
    """Train one small LM per lane on identical data; write the wide
    per-step loss CSV (step, <lane>...) to ``writer`` and return the
    summary dict (final losses, deviations vs fp32).  The dp members are
    rank slots of ``device`` (the card by default)."""
    from ..models.transformer import ModelConfig, init_params
    from ..utils.device import resolve_device
    from ..utils.tree import tree_map

    dev = resolve_device(device, "run_ef_convergence")
    cfg = ModelConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                      d_head=16, d_ff=256)
    rng = np.random.default_rng(seed)
    params0 = init_params(rng, cfg, device=dev)
    tokens = torch.from_numpy(
        make_tokens(rng, cfg.vocab, steps, dp, batch, seq)).to(dev)

    traj: dict = {}
    for lane in lanes:
        step = _make_step(cfg, lane, lr, dp)
        params = tree_map(torch.clone, params0)
        losses = []
        for i in range(steps):
            params, loss = step(params, tokens[i])
            losses.append(float(loss))
        traj[lane] = losses
        log(f"[ef] lane {lane:8s} loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} over {steps} steps")

    w = csv.writer(writer)
    w.writerow(["step"] + list(lanes))
    for i in range(steps):
        w.writerow([i] + [f"{traj[lane][i]:.6f}" for lane in lanes])

    summary = {"steps": steps, "dp": dp, "batch": batch, "seq": seq,
               "lr": lr, "seed": seed, "device": str(dev),
               "final": {lane: traj[lane][-1] for lane in lanes},
               "trajectories": traj}
    if "fp32" in traj:
        ref = np.asarray(traj["fp32"])
        for lane in lanes:
            if lane == "fp32":
                continue
            d = np.abs(np.asarray(traj[lane]) - ref)
            summary[f"{lane}_mean_abs_dev"] = float(d.mean())
            summary[f"{lane}_max_abs_dev"] = float(d.max())
            log(f"[ef] {lane} vs fp32: mean |dloss| {d.mean():.3e}, "
                f"max {d.max():.3e}")
    return summary


def write_summary_md(path: str, summary: dict,
                     csv_name: Optional[str] = None) -> None:
    """The .md companion of a run's CSV: run shape, final losses, and the
    deviation verdict against ``TRACK_TOL``."""
    final = summary["final"]
    lines = [
        "# int8 error-feedback convergence record",
        "",
        f"- run: {summary['dp']} dp ranks x {summary['batch']} "
        f"batch x {summary['seq']} seq, {summary['steps']} SGD steps, "
        f"lr {summary['lr']}, seed {summary['seed']} (deterministic — "
        f"no stochastic rounding), on {summary.get('device', 'cuda')}",
    ]
    if csv_name:
        lines.append(f"- trajectory: {csv_name} (per-step loss, one "
                     f"column per lane)")
    lines += [
        "",
        "| lane | final loss | mean \\|loss - fp32\\| | "
        "max \\|loss - fp32\\| |",
        "|---|---|---|---|",
    ]
    for lane in final:
        mean_d = summary.get(f"{lane}_mean_abs_dev")
        max_d = summary.get(f"{lane}_max_abs_dev")
        fmt = (lambda v: "—" if v is None else f"{v:.3e}")
        lines.append(f"| {lane} | {final[lane]:.6f} | {fmt(mean_d)} | "
                     f"{fmt(max_d)} |")
    devs = {k[:-len("_mean_abs_dev")]: v for k, v in summary.items()
            if k.endswith("_mean_abs_dev")}
    if devs:
        worst = max(devs.values())
        verdict = "PASS" if worst <= TRACK_TOL else "FAIL"
        lines += [
            "",
            f"- gate ({verdict}): every quantized lane must track the "
            f"fp32 trajectory within mean |dloss| <= {TRACK_TOL:g} "
            f"(worst lane: {worst:.3e})",
            "- EF vs raw int8 is reported, not gated: with "
            "round-to-nearest the per-hop error carry redistributes "
            "requantization error rather than strictly shrinking it",
        ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
