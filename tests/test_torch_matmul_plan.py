"""The launch plan of the port's matmul kernels (accl_tpu_torch/ops/fused.py
``matmul_plan``, ``stripe_tiles``, ``fused_stripes``; csrc/fused.cu), on
the CPU.

- The tile geometry the wrapper plans with is the one compiled into
  csrc/fused.cu.
- ``accl_matmul``'s plan, for many (m, n, k): every output element lies
  in exactly one tile and every k in exactly one range of the split; at
  a short m the grid fills the card without a second wave.
- The kernel emulated as it runs the plan: each block's zero-padded
  bm x 128 tile over its range of K, the split's partials summed in
  the fixed order 0, 1, ..., split-1, the ragged edges cut at the store.
  Bitwise against ``pallas_matmul_plain`` on integer-valued inputs
  (every product and partial sum exact in fp32), and within the fp32
  spread sqrt(K) 2^-24 (|x| @ |w|) of it on N(0, 1) inputs (the
  summation order differs from torch's).
- ``accl_fused_matmul_rs`` emulated block by block (rank, stripe) under
  a seeded random interleaving: per hop and tile the product, the wait
  for the landing at the hop's first epilogue, the fold ``product +
  landing`` stored into the right neighbour's next slot (the output on
  the last hop), the flags and the ACK windows of ring_sync.cuh, and
  each block zeroing its own flags at its end.  No slot is overwritten
  before it is read, no block deadlocks, every flag ends at 0, and the
  result is bitwise equal to ``fused_matmul_reduce_scatter_plain`` on
  integers, for P = 2..8.
"""
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from accl_tpu_torch.ops import fused as TF
from accl_tpu_torch.ops.ring import rs_signals_ack, rs_waits_ack

FUSED_CU = Path(TF.__file__).resolve().parent / "csrc" / "fused.cu"
#: Llama-3-8B at TP=8 and 4096 tokens (chip_smoke.py TP_SHAPES): (M, K, N)
#: of MLP-down and attention-out, and the chunked form's 128-row blocks
TP_SHAPES = [(4096, 1792, 4096), (4096, 512, 4096), (128, 1792, 4096),
             (128, 512, 4096), (512, 1792, 4096)]
SMS = 132


def _cdiv(a, b):
    return -(-a // b)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ints(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -3, 4, size=shape).astype(np.float32))


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_tile_geometry_matches_the_kernel_source():
    src = FUSED_CU.read_text()
    defs = dict(re.findall(r"^#define (\w+) (\d+)", src, re.M))
    assert int(defs["BN"]) == TF.TILE_N
    assert int(defs["BK"]) == TF.TILE_K
    assert int(defs["FUSED_BM"]) == TF.FUSED_TILE_M
    assert re.search(rf"__launch_bounds__\(MM_THREADS, {TF.BLOCKS_PER_SM}\)"
                     r"\s*matmul_kernel", src)
    built = sorted(int(b) for b in re.findall(
        r"matmul_kernel<(?:float|__nv_bfloat16), (\d+)>", src))
    assert set(built) == set(TF.TILE_MS)


# ---------------------------------------------------------------------------
# accl_matmul's plan
# ---------------------------------------------------------------------------
PLAN_SHAPES = [(m, n, k) for m in (1, 127, 128, 129, 4096)
               for n, k in ((4096, 1792), (777, 333), (129, 17), (128, 1000),
                            (1, 5))] + TP_SHAPES


@pytest.mark.parametrize("sms", [SMS, 114, 8])
@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_plan_covers_every_output_and_every_k_once(m, n, k, sms):
    plan = TF.matmul_plan(m, n, k, sms)
    assert plan.bm in TF.TILE_MS
    assert 1 <= plan.split <= TF.MAX_SPLIT
    assert plan.k_per_split % TF.TILE_K == 0
    # every row, column and k in exactly one tile or range; no range empty
    rows = np.zeros(m, int)
    for by in range(_cdiv(m, plan.bm)):
        rows[by * plan.bm:(by + 1) * plan.bm] += 1
    cols = np.zeros(n, int)
    for bx in range(_cdiv(n, TF.TILE_N)):
        cols[bx * TF.TILE_N:(bx + 1) * TF.TILE_N] += 1
    ks = np.zeros(k, int)
    for z in range(plan.split):
        k0, k1 = z * plan.k_per_split, min(k, (z + 1) * plan.k_per_split)
        assert k0 < k1
        ks[k0:k1] += 1
    assert (rows == 1).all() and (cols == 1).all() and (ks == 1).all()
    # a split never starts a second wave of blocks
    blocks = _cdiv(m, plan.bm) * _cdiv(n, TF.TILE_N) * plan.split
    if plan.split > 1:
        assert blocks <= sms * TF.BLOCKS_PER_SM
        assert plan.bm == min(TF.TILE_MS)


@pytest.mark.parametrize("m", [1, 128])
def test_plan_fills_the_card_at_short_m(m):
    """The chunked TP form's blocks: one block per 128 x 128 tile gave 32
    blocks on 132 SMs; the plan gives at least one per SM."""
    plan = TF.matmul_plan(m, 4096, 1792, SMS)
    blocks = _cdiv(m, plan.bm) * _cdiv(4096, TF.TILE_N) * plan.split
    assert SMS <= blocks <= SMS * TF.BLOCKS_PER_SM
    assert TF.matmul_plan(128, 4096, 1792, SMS) == TF.MatmulPlan(64, 4, 448)
    assert TF.matmul_plan(4096, 4096, 1792, SMS) == TF.MatmulPlan(128, 1,
                                                                  1792)


def _emulate_matmul(x, w, plan):
    """out = x @ w as accl_matmul computes it under ``plan``."""
    m, k = x.shape
    n = w.shape[1]
    bm, split, kps = plan
    tm, tn = _cdiv(m, bm), _cdiv(n, TF.TILE_N)
    # shared memory reads zeros past m, n and k
    xp = torch.zeros(tm * bm, split * kps)
    xp[:m, :k] = x.float()
    wp = torch.zeros(split * kps, tn * TF.TILE_N)
    wp[:k, :n] = w.float()
    out = torch.full((m, n), float("nan"))
    for by in range(tm):
        for bx in range(tn):
            r = slice(by * bm, (by + 1) * bm)
            c = slice(bx * TF.TILE_N, (bx + 1) * TF.TILE_N)
            parts = [xp[r, z * kps:(z + 1) * kps] @ wp[z * kps:(z + 1) * kps,
                                                        c]
                     for z in range(split)]
            acc = parts[0]
            for p in parts[1:]:  # the fixed order of the last block's sum
                acc = acc + p
            rows = min(m, (by + 1) * bm) - by * bm
            cols = min(n, (bx + 1) * TF.TILE_N) - bx * TF.TILE_N
            out[r.start:r.start + rows, c.start:c.start + cols] = \
                acc[:rows, :cols]
    return out


EMU_SHAPES = [(1, 4096, 1792), (127, 129, 17), (128, 777, 333),
              (129, 130, 1000), (128, 4096, 1792), (64, 256, 37),
              (300, 128, 200)]


@pytest.mark.parametrize("m,n,k", EMU_SHAPES)
def test_plan_emulation_bitwise_on_integers(m, n, k):
    x, w = _ints((m, k), 1), _ints((k, n), 2)
    plan = TF.matmul_plan(m, n, k, SMS)
    got = _emulate_matmul(x, w, plan)
    assert torch.equal(got, TF.pallas_matmul_plain(x, w))


@pytest.mark.parametrize("m,n,k", EMU_SHAPES)
def test_plan_emulation_within_fp32_spread(m, n, k):
    x, w = _normal((m, k), 3), _normal((k, n), 4)
    plan = TF.matmul_plan(m, n, k, SMS)
    got = _emulate_matmul(x, w, plan).double()
    plain = TF.pallas_matmul_plain(x, w).double()
    spread = np.sqrt(k) * 2.0 ** -24 * (x.double().abs() @ w.double().abs())
    assert bool(((got - plain).abs() <= spread).all())


# ---------------------------------------------------------------------------
# accl_fused_matmul_rs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P,tiles,resident", [(8, 128, 264), (8, 3, 264),
                                              (3, 7, 8), (2, 1, 2),
                                              (5, 20, 1000)])
def test_fused_stripes_hold_every_tile_once(P, tiles, resident):
    S = TF.fused_stripes(P, tiles, resident)
    assert 1 <= S <= min(tiles, resident // P)
    seen = np.zeros(tiles, int)
    for st in range(S):
        t0, t1 = TF.stripe_tiles(tiles, S, st)
        assert t0 < t1  # every stripe holds a tile, so every block waits
        seen[t0:t1] += 1
    assert (seen == 1).all()


def test_fused_stripes_refuse_too_many_ranks():
    with pytest.raises(RuntimeError, match="co-resident"):
        TF.fused_stripes(8, 128, 7)


def _emulate_fused(xs, ws, S, seed):
    """accl_fused_matmul_rs block by block under a seeded random
    interleaving.  Returns (outputs, flags left behind)."""
    P = len(xs)
    _, m, K = xs[0].shape
    N = ws[0].shape[1]
    bm, bn = TF.FUSED_TILE_M, TF.TILE_N
    tiles_n = _cdiv(N, bn)
    tiles = _cdiv(m, bm) * tiles_n
    landing = torch.full((P, 2, m, N), float("nan"))
    unread = np.zeros((P, 2, tiles), bool)  # a landing not yet folded
    outs = [torch.full((m, N), float("nan")) for _ in range(P)]
    filled = np.zeros((P, S, 2), int)
    ack = np.zeros((P, S, 2), int)

    def block(my, st):
        right, left = (my + 1) % P, (my - 1) % P
        t0, t1 = TF.stripe_tiles(tiles, S, st)
        for s in range(-1, P - 1):
            xc = xs[my][(my - 1) % P if s < 0 else (my - 2 - s) % P]
            last, slot, ns = s == P - 2, s & 1, s + 1

            def wait_hop():
                while filled[my, st, slot] < s // 2 + 1:
                    yield
                if not last and rs_waits_ack(ns, P):
                    while ack[my, st, ns & 1] < ns // 2:
                        yield

            waited = s < 0
            for t in range(t0, t1):
                r0, c0 = (t // tiles_n) * bm, (t % tiles_n) * bn
                r, c = slice(r0, r0 + bm), slice(c0, c0 + bn)
                acc = xc[r].float() @ ws[my][:, c].float()
                if not waited:  # the hop's first epilogue
                    yield from wait_hop()
                    waited = True
                if s >= 0:
                    assert unread[my, slot, t], "landing read twice"
                    acc = acc + landing[my, slot, r, c]
                    unread[my, slot, t] = False
                if last:
                    outs[my][r, c] = acc
                else:
                    dst = 0 if s < 0 else ns & 1
                    assert not unread[right, dst, t], "slot overwritten"
                    landing[right, dst, r, c] = acc
                    unread[right, dst, t] = True
                yield
            if not waited:
                yield from wait_hop()
            if s < 0:
                filled[right, st, 0] += 1
            else:
                if not last:
                    filled[right, st, ns & 1] += 1
                if rs_signals_ack(s, P):
                    ack[left, st, slot] += 1
        filled[my, st] = 0
        ack[my, st] = 0

    rng = random.Random(seed)
    live = [block(my, st) for my in range(P) for st in range(S)]
    while live:
        g = rng.choice(live)
        try:
            next(g)
        except StopIteration:
            live.remove(g)
    return outs, filled, ack


@pytest.mark.parametrize("P", range(2, 9))
@pytest.mark.parametrize("m,K,N,S", [(130, 20, 260, 3), (64, 9, 128, 1),
                                     (256, 16, 384, 4)])
def test_fused_epilogue_fold_emulation_bitwise(P, m, K, N, S):
    xs = [_ints((P, m, K), 10 + r) for r in range(P)]
    ws = [_ints((K, N), 30 + r) for r in range(P)]
    tiles = _cdiv(m, TF.FUSED_TILE_M) * _cdiv(N, TF.TILE_N)
    S = TF.fused_stripes(P, tiles, P * S)
    want = TF.fused_matmul_reduce_scatter_plain(xs, ws)
    for seed in range(3):
        outs, filled, ack = _emulate_fused(xs, ws, S, seed)
        for o, v in zip(outs, want):
            assert torch.equal(o, v)
        assert not filled.any() and not ack.any()  # left at 0 for the next
