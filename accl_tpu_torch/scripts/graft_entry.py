"""Driver entry points on one card: a forward check and a multi-rank dry
run.

The CUDA twin of ``__graft_entry__.py``:

- :func:`entry`: the flagship transformer's forward on one card (dense
  attention, no mesh), with example args.
- :func:`dryrun_multichip`: ``n`` ranks as regions of one card's memory
  with real dp/tp/sp axes (the same :func:`_pick_axes` factorisation of
  ``n``), ONE full parallel train step on tiny shapes
  (``make_train_step`` on ``make_mesh``: tensor-parallel combines, ring
  attention over sp on the flash kernels, the dp gradient mean), then the
  expert-parallel MoE step, a ``pipeline_apply`` schedule, the zigzag and
  windowed sp ring attention against dense attention, and the driver
  collectives on ``CudaWorld(n)`` with the ring threshold at 0, so the
  ring kernels carry every eligible call.

Both run on the card unless ``device="cpu"`` is passed.  Head sizes are
32 where the JAX dry run takes 8 and 16: the card's flash kernels take
heads of 32, 64 and 128, and the sp steps attend through them.

    python -m accl_tpu_torch.scripts.graft_entry            # entry()
    python -m accl_tpu_torch.scripts.graft_entry dryrun 8   # dry run
"""
from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """Return (fn, example_args): the forward step on one card."""
    from ..models import ModelConfig, forward, init_params

    cfg = ModelConfig(vocab=128, d_model=128, n_layers=2, n_heads=4,
                      d_head=32, d_ff=256)
    params = init_params(np.random.default_rng(0), cfg, device=device)
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 64),
                                          dtype=np.int32),
        dtype=torch.int64, device=params["embed"].device)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def _pick_axes(n: int) -> dict:
    """Factor n devices into dp x tp x sp, preferring balance."""
    axes = {"dp": 1, "tp": 1, "sp": 1}
    order = ["tp", "sp", "dp"]  # fastest-communicating axes first
    i = 0
    m = n
    for prime in (2, 3, 5, 7):
        while m % prime == 0:
            axes[order[i % 3]] *= prime
            m //= prime
            i += 1
    if m > 1:
        axes["dp"] *= m
    return {k: v for k, v in axes.items() if v > 1}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full parallel train step and the other parallel paths over
    ``n_devices`` ranks of one card.  Returns the losses; raises on any
    failed check."""
    from ..models import ModelConfig, init_params, make_train_step
    from ..parallel import make_mesh

    axes = _pick_axes(n_devices)
    sp = axes.get("sp", 1)
    tp = axes.get("tp", 1)
    # heads divisible by tp; sequence divisible by sp.  The config is
    # the full Llama-family stack — grouped K/V (GQA), rotary
    # positions, gated MLP — so the dry run certifies the grouped
    # projections, global-position rotation, and gate split under real
    # tp/sp splits
    cfg = ModelConfig(vocab=64, d_model=32, n_layers=2,
                      n_heads=max(2, tp) * 2,
                      n_kv_heads=max(1, tp), d_head=32, d_ff=64,
                      rope=True, mlp="swiglu")
    mesh = make_mesh(**axes, device=device)
    params = init_params(np.random.default_rng(0), cfg, tp=tp,
                         device=device)
    step, _ = make_train_step(mesh, cfg)
    B = 2 * axes.get("dp", 1)
    T = 8 * sp
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, T), dtype=np.int32), dtype=torch.int64)
    _, loss = step(params, tokens)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n_devices}): loss {loss}")
    print(f"dryrun_multichip({n_devices}): mesh={axes} loss={loss:.4f}")
    out = {"loss": loss}

    # expert-parallel path: MoE train step over dp x ep (the all-to-all
    # dispatch/combine collective pattern)
    ep = next((e for e in (8, 4, 2) if n_devices % e == 0), None)
    if ep is not None:
        from ..models import moe

        mcfg = moe.MoEConfig(vocab=64, d_model=32, n_layers=1, n_heads=2,
                             d_head=8, d_ff=64, n_experts=ep,
                             capacity_factor=4.0)
        mmesh = make_mesh(dp=n_devices // ep, ep=ep, device=device)
        mparams = moe.init_params(np.random.default_rng(2), mcfg, ep=ep,
                                  device=device)
        mstep, _ = moe.make_train_step(mmesh, mcfg)
        mtokens = torch.as_tensor(np.random.default_rng(3).integers(
            0, mcfg.vocab, size=(2 * n_devices, 16), dtype=np.int32),
            dtype=torch.int64)
        _, mloss = mstep(mparams, mtokens)
        mloss = float(mloss)
        if not np.isfinite(mloss):
            raise RuntimeError(f"dryrun_multichip({n_devices}): moe loss "
                               f"{mloss}")
        print(f"dryrun_multichip({n_devices}): moe dp={n_devices // ep} "
              f"ep={ep} loss={mloss:.4f}")
        out["moe_loss"] = mloss

    # pipeline-parallel path: GPipe schedule over a pp ring, one per dp
    # row
    if n_devices % 2 == 0:
        from ..parallel.strategies import pipeline_apply

        pp = 2
        dev = mesh.device
        D, M = 16, 4  # feature dim, microbatches
        stage_w = torch.as_tensor(
            np.random.default_rng(4).standard_normal((pp, D, D)) * 0.1,
            dtype=torch.float32, device=dev)
        xs = torch.as_tensor(np.random.default_rng(5).standard_normal(
            (n_devices // pp, M, 2, D)), dtype=torch.float32, device=dev)
        pout = torch.stack([
            pipeline_apply(lambda p, mb: torch.tanh(mb @ p),
                           list(stage_w), xs[d])[-1]
            for d in range(n_devices // pp)])
        if not bool(torch.isfinite(pout).all()):
            raise RuntimeError("pipeline output is not finite")
        print(f"dryrun_multichip({n_devices}): pipeline "
              f"dp={n_devices // pp} pp={pp} "
              f"out_shape={tuple(pout.shape)}")

    _dryrun_zigzag_sp(n_devices, mesh.device)
    _dryrun_driver_collectives(n_devices, mesh.device)
    return out


def _dryrun_zigzag_sp(n_devices: int, dev) -> None:
    """The load-balanced zigzag causal ring-attention schedule over sp =
    n_devices members, checked against global dense attention; then the
    sliding-window schedule against the banded dense reference."""
    import importlib

    RA = importlib.import_module("accl_tpu_torch.parallel.ring_attention")
    B, Tl, H, D = 2, 8, 2, 32
    T = n_devices * Tl
    rng = np.random.default_rng(21)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, T, H, D)),
                               dtype=torch.float32, device=dev)
               for _ in range(3))
    perm = RA.zigzag_indices(T, n_devices).to(dev)
    inv = RA.zigzag_indices_inverse(T, n_devices).to(dev)

    def shards(x):
        return list(x.chunk(n_devices, dim=1))

    got = torch.cat(RA.ring_attention(
        shards(q[:, perm]), shards(k[:, perm]), shards(v[:, perm]),
        causal=True, schedule="zigzag"), dim=1)[:, inv]
    want = RA._dense_attention(q, k, v, causal=True)
    if not bool(((got - want).abs() < 1e-3).all()):
        raise RuntimeError("zigzag SP ring attention differs from dense")
    print(f"dryrun_multichip({n_devices}): zigzag SP ring attention OK "
          f"(sp={n_devices}, balanced causal schedule)")

    W = max(2, Tl // 2)
    goth = torch.cat(RA.ring_attention(shards(q), shards(k), shards(v),
                                       causal=True, window=W), dim=1)
    wanth = RA._dense_attention(q, k, v, causal=True, window=W)
    if not bool(((goth - wanth).abs() < 1e-3).all()):
        raise RuntimeError("windowed SP attention differs from dense")
    print(f"dryrun_multichip({n_devices}): windowed SP attention OK "
          f"(window={W}, one-neighbor-hop schedule)")


def _dryrun_driver_collectives(n_devices: int, dev) -> None:
    """The driver's descriptor -> gang engine -> ring kernel path on
    ``CudaWorld(n_devices)`` with the ring threshold at 0, so the ring
    kernels carry every eligible call: allreduce, reduce_scatter,
    allgather, an fp16-compressed allreduce, bcast, gather, scatter,
    alltoall, stream_put, a sub-communicator allreduce and a barrier,
    each checked against numpy."""
    from .. import DataType, ReduceFunction
    from ..backends.cuda import CudaWorld

    n = 64
    with CudaWorld(n_devices, device=dev) as w:
        w.engine.ring_threshold_bytes = 0

        def fn(accl, rank):
            rng = np.random.default_rng(rank)
            d = rng.standard_normal(n).astype(np.float32)
            s = accl.create_buffer_like(d)
            r = accl.create_buffer(n, np.float32)
            accl.allreduce(s, r, n, ReduceFunction.SUM)
            rs_in = accl.create_buffer_like(
                np.tile(d, n_devices).astype(np.float32))
            rs_out = accl.create_buffer(n, np.float32)
            accl.reduce_scatter(rs_in, rs_out, n, ReduceFunction.SUM)
            ag_out = accl.create_buffer(n * n_devices, np.float32)
            accl.allgather(s, ag_out, n)
            # wire-compressed variant through the gang's quantize step
            rc = accl.create_buffer(n, np.float32)
            accl.allreduce(s, rc, n, ReduceFunction.SUM,
                           compress_dtype=DataType.float16)
            bb = accl.create_buffer(n, np.float32)
            if rank == 0:
                bb.host[:] = d
            accl.bcast(bb, n, 0)
            ga = accl.create_buffer(n * n_devices, np.float32)
            accl.gather(s, ga, n, root=0)
            sc_in = accl.create_buffer_like(
                np.tile(d, n_devices).astype(np.float32))
            sc_out = accl.create_buffer(n, np.float32)
            accl.scatter(sc_in, sc_out, n, root=1)
            a2a_in = accl.create_buffer_like(
                np.tile(d, n_devices).astype(np.float32))
            a2a_out = accl.create_buffer(n * n_devices, np.float32)
            accl.alltoall(a2a_in, a2a_out, n)
            # device-stream landing (stream_put -> peer kernel stream)
            if rank == 0:
                accl.stream_put(s, n, dst=1, stream_id=9)
            strm = None
            if rank == 1:
                raw = accl.device.pop_stream(9, n * 4, timeout_s=30)
                if raw is None:
                    raise RuntimeError("stream_put never landed on rank 1")
                strm = np.frombuffer(raw, dtype=np.float32).copy()
            # sub-communicator collective over the even ranks
            sub = list(range(0, n_devices, 2))
            sub_r = None
            if rank in sub and len(sub) > 1:
                cid = accl.create_communicator(sub)
                sr = accl.create_buffer(n, np.float32)
                accl.allreduce(s, sr, n, ReduceFunction.SUM, comm_id=cid)
                sub_r = sr.host.copy()
            accl.barrier()
            return r.host.copy(), bb.host.copy(), ga.host.copy(), \
                sc_out.host.copy(), a2a_out.host.copy(), strm, sub_r

        outs = w.run(fn)

    ds = [np.random.default_rng(k).standard_normal(n).astype(np.float32)
          for k in range(n_devices)]
    want = sum(ds)
    sub = list(range(0, n_devices, 2))
    want_sub = sum(ds[k] for k in sub)
    for rank, (r, bb, ga, sc, a2a, strm, sub_r) in enumerate(outs):
        np.testing.assert_allclose(r, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(bb, ds[0], rtol=1e-6)
        if rank == 0:  # gather root sees every rank's chunk in order
            np.testing.assert_allclose(ga, np.concatenate(ds), rtol=1e-6)
        np.testing.assert_allclose(sc, ds[1], rtol=1e-6)  # root 1's chunk
        # chunk i of every sender; inputs are tiled so every receiver
        # sees the senders' vectors in rank order
        np.testing.assert_allclose(a2a, np.concatenate(ds), rtol=1e-6)
        if rank == 1:
            np.testing.assert_allclose(strm, ds[0], rtol=1e-6)
        if rank in sub and len(sub) > 1:
            np.testing.assert_allclose(sub_r, want_sub, rtol=1e-4,
                                       atol=1e-4)
    print(f"dryrun_multichip({n_devices}): driver collectives over the "
          f"ring-kernel path OK (allreduce/reduce_scatter/allgather/"
          f"compressed/bcast/gather/scatter/alltoall/stream_put/"
          f"sub-comm/barrier x {n_devices} ranks)")


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        fn, args = entry()
        out = fn(*args)
        print("entry() forward:", tuple(out.shape), out.dtype)
