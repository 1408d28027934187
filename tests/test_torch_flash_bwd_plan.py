"""The launch plan of the port's flash backward kernels
(accl_tpu_torch/ops/flash.py ``bwd_plan``; csrc/flash_bwd.cu), on the CPU.

- The tile rows the plan counts in are the ones compiled into
  csrc/flash_bwd.cu, and the plan's tables have the kernel's layout.
- For ~30 shapes (causal, windowed, cross-length non-causal, ragged
  T = 1200, MQA, GQA groups 1, 4 and 8) on 3 SM counts: the dK/dV items
  cover every live (q head, q tile, k tile) cell of the 64-row tiling
  exactly once (the cells holding a pair the masks keep, which at T a
  multiple of 64 is the Pallas schedule's ``_grid_live_masked`` set),
  each tile's items cut its walk into contiguous ranges with their own
  slots, they launch longest first, and the heaviest holds at most a
  BWD_ITEM_SHARE-th of an SM's average work (at least BWD_MIN_ITEM
  steps), BWD_ITEM_SHARE being 12 for the float32 MXU dtype and 6 for
  bfloat16.  At the training shape that is at most a third, with two
  waves' worth of items.
- The dK/dV kernel emulated item by item under a seeded random order of
  arrival: each item's fp32 partial over its steps, an integer counter
  per tile, the last item of a split tile summing the partials in slot
  order.  Every counter ends at zero; dk and dv are within BWD_BOUND of
  ``flash_bwd_dkv_plain`` (3e-5 of the largest value for the float32
  MXU dtype: the same fp32 products summed in another order; 1.6e-2 for
  bfloat16, two bf16 ulps, as chip_smoke.py) and bitwise the same under
  two arrival orders.
- At one small shape the emulation is held to the JAX package's
  ``_flash_backward`` (its Pallas dK/dV kernel in interpret mode) at the
  float32 bound of tests/test_torch_flash_bwd.py, 1e-5.
"""
import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accl_tpu.ops.flash as JF
from accl_tpu_torch.ops import flash as TF

FLASH_BWD_CU = Path(TF.__file__).resolve().parent / "csrc" / "flash_bwd.cu"
SMS = (132, 114, 16)
B = TF.BWD_TILE
#: (N, Nk, T, Tk, causal, window)
SHAPES = [
    (8, 2, 4096, 4096, True, None), (4, 1, 8192, 8192, True, None),
    (8, 8, 4096, 4096, True, None), (8, 1, 4096, 4096, True, None),
    (32, 8, 2048, 2048, True, None), (8, 2, 1200, 1200, True, None),
    (8, 2, 1200, 1200, False, None), (4, 1, 2048, 2048, True, 1000),
    (4, 1, 2048, 2048, True, 64), (4, 2, 2048, 2048, True, 1),
    (8, 2, 1200, 1200, True, 100), (8, 2, 1024, 1536, False, None),
    (4, 1, 200, 320, False, None), (8, 2, 320, 320, True, None),
    (8, 2, 320, 320, True, 100), (8, 1, 640, 640, True, None),
    (4, 4, 640, 640, True, None), (2, 1, 64, 64, True, None),
    (2, 2, 63, 63, True, None), (1, 1, 1, 1, True, None),
    (3, 3, 100, 700, False, None), (16, 2, 4096, 4096, True, 512),
    (8, 2, 4096, 4096, False, None), (8, 2, 4160, 4160, True, None),
    (4, 1, 96, 96, True, 5), (4, 2, 128, 128, True, 40),
    (6, 3, 513, 513, True, None), (12, 4, 1000, 1000, True, 300),
    (2, 1, 4096, 128, False, None), (2, 1, 128, 4096, False, None),
]


def _ids(shape):
    return "N{}_Nk{}_T{}_Tk{}_{}_w{}".format(*shape)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_tile_geometry_and_tables_match_the_kernel_source():
    src = FLASH_BWD_CU.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["BQ"]) == int(consts["BK"]) == TF.BWD_TILE
    assert re.search(r"struct Item \{\s*int tile, j0, j1, slot;\s*\};", src)
    assert re.search(r"struct TileInfo \{\s*int parts, first_slot;\s*\};",
                     src)
    # the kernel's walk is the plan's: kt * Nk + kv head, j // nlive heads
    assert "it.tile / p.Nk" in src and "j / nlive" in src


def _kept_cells(N, Nk, T, Tk, causal, window):
    """(q head, q tile, k tile) of the 64-row tiling holding a pair the
    masks keep."""
    rows, cols = np.arange(T)[:, None], np.arange(Tk)[None, :]
    keep = np.ones((T, Tk), bool)
    if causal:
        keep &= rows >= cols
    if window:
        keep &= rows - cols < window
    nqt, nkt = -(-T // B), -(-Tk // B)
    live = {(qt, kt) for qt in range(nqt) for kt in range(nkt)
            if keep[qt * B:(qt + 1) * B, kt * B:(kt + 1) * B].any()}
    return {(n, qt, kt) for n in range(N) for qt, kt in live}


def _item_cells(plan, N, Nk, T, Tk, causal, window):
    G = N // Nk
    cells = []
    for tile, j0, j1, _slot in plan.items:
        kt, kvn = divmod(tile, Nk)
        first, nlive = TF._live_q(kt, T, Tk, causal, window or 0)
        cells += [(kvn * G + j // nlive, first + j % nlive, kt)
                  for j in range(j0, j1)]
    return cells


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_covers_each_live_cell_once(shape, sms):
    N, Nk, T, Tk, causal, window = shape
    mxu = (torch.float32, torch.bfloat16)[SMS.index(sms) % 2]
    plan = TF.bwd_plan(N, Nk, T, Tk, causal, window or 0, sms, mxu)
    cells = _item_cells(plan, N, Nk, T, Tk, causal, window)
    assert len(cells) == len(set(cells)) == plan.steps
    want = _kept_cells(N, Nk, T, Tk, causal, window)
    assert set(cells) == want
    if T % B == 0 and Tk % B == 0:
        pallas = {(n, qt, kt) for n in range(N) for qt in range(T // B)
                  for kt in range(Tk // B)
                  if TF._grid_live_masked(qt, kt, B, B, causal, window)[0]}
        assert pallas == want
    # each tile's items: contiguous ranges over its whole walk, own slots
    nkt = -(-Tk // B)
    assert len(plan.tiles) == Nk * nkt
    slots = []
    for tile, (parts, first_slot) in enumerate(plan.tiles):
        mine = sorted((j0, j1, s) for t, j0, j1, s in plan.items if t == tile)
        assert len(mine) == parts
        L = (N // Nk) * TF._live_q(tile // Nk, T, Tk, causal,
                                   window or 0)[1]
        assert mine[0][0] == 0 and mine[-1][1] == L
        assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
        if parts == 1:
            assert mine[0][2] == -1
        else:
            assert [s for *_r, s in mine] == list(
                range(first_slot, first_slot + parts))
            slots += [s for *_r, s in mine]
    assert sorted(slots) == list(range(plan.slots))
    lens = [j1 - j0 for _t, j0, j1, _s in plan.items]
    assert lens == sorted(lens, reverse=True)
    assert plan.dq_ctas == N * -(-T // B)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_heaviest_item_within_its_share(shape, sms):
    N, Nk, T, Tk, causal, window = shape
    for mxu, share in TF.BWD_ITEM_SHARE.items():
        plan = TF.bwd_plan(N, Nk, T, Tk, causal, window or 0, sms, mxu)
        cap = max(TF.BWD_MIN_ITEM, -(-plan.steps // (sms * share)))
        assert plan.heaviest <= cap
        assert plan.per_sm == plan.steps / sms


@pytest.mark.parametrize("mxu,per_sm", [(torch.float32, 1),
                                        (torch.bfloat16, 2)])
def test_training_shape_fills_and_balances_the_card(mxu, per_sm):
    # chip_smoke.py FLASH_TRAIN on an H100's 132 SMs, with the mainloop's
    # CTAs per SM
    plan = TF.bwd_plan(8, 2, 4096, 4096, True, 0, 132, mxu)
    assert plan.heaviest <= plan.per_sm / 3
    assert len(plan.items) >= 2 * per_sm * 132
    # the old launch, one CTA per K/V tile: the heaviest 256 steps, twice
    # the 126 of the average SM
    assert plan.per_sm < 256 / 2


def _rnd(x, mxu):
    return x.to(mxu).float()


def emulate_dkv(q2, k, v, do, l2, dvec, causal, window, mxu, sms, seed):
    """The dK/dV kernel as it runs the plan, items arriving in a random
    order (``seed``): each item's fp32 partial over its steps (P and dS
    rounded to the MXU dtype before the products, as the plain version);
    an item alone on its tile stores; a split tile's last arrival sums
    the partials in slot order."""
    N, T, D = q2.shape
    Nk, Tk = k.shape[:2]
    G = N // Nk
    plan = TF.bwd_plan(N, Nk, T, Tk, causal, window or 0, sms, mxu)
    q2r, kr, vr, dor = (_rnd(x.float(), mxu) for x in (q2, k, v, do))

    def rows_of(x, r0, limit):
        out = torch.zeros((B,) + x.shape[1:])
        out[:max(0, min(B, limit - r0))] = x[r0:r0 + B]
        return out

    ws = torch.full((plan.slots, 2, B, D), float("nan"))
    counters = [0] * len(plan.tiles)
    dk = torch.full(k.shape, float("nan"))
    dv = torch.full(v.shape, float("nan"))
    order = list(range(len(plan.items)))
    random.Random(seed).shuffle(order)
    folds = 0
    for idx in order:
        tile, j0, j1, slot = plan.items[idx]
        kt, kvn = divmod(tile, Nk)
        k0 = kt * B
        first, nlive = TF._live_q(kt, T, Tk, causal, window or 0)
        kb, vb = rows_of(kr[kvn], k0, Tk), rows_of(vr[kvn], k0, Tk)
        pk, pv = torch.zeros(B, D), torch.zeros(B, D)
        for j in range(j0, j1):
            n, q0 = kvn * G + j // nlive, (first + j % nlive) * B
            qb, ob = rows_of(q2r[n], q0, T), rows_of(dor[n], q0, T)
            l2b, dvb = rows_of(l2[n], q0, T), rows_of(dvec[n], q0, T)
            rows = torch.arange(q0, q0 + B)[:, None]
            cols = torch.arange(k0, k0 + B)[None, :]
            keep = (rows < T) & (cols < Tk) & (l2b[:, None] > TF.NEG_INF / 2)
            if causal:
                keep &= rows >= cols
            if window:
                keep &= rows - cols < window
            p = torch.where(keep, torch.exp2(qb @ kb.T - l2b[:, None]), 0.0)
            ds = p * (ob @ vb.T - dvb[:, None])
            pv += _rnd(p, mxu).T @ ob
            pk += _rnd(ds, mxu).T @ qb
        parts, first_slot = plan.tiles[tile]
        if parts > 1:
            ws[slot, 0], ws[slot, 1] = pk, pv
            counters[tile] += 1
            if counters[tile] < parts:
                continue
            folds += 1
            pk, pv = ws[first_slot, 0].clone(), ws[first_slot, 1].clone()
            for s in range(first_slot + 1, first_slot + parts):
                pk += ws[s, 0]
                pv += ws[s, 1]
            counters[tile] = 0
        n_rows = max(0, min(B, Tk - k0))
        dk[kvn, k0:k0 + n_rows] = (pk * (1.0 / TF._LOG2E))[:n_rows]
        dv[kvn, k0:k0 + n_rows] = pv[:n_rows]
    assert counters == [0] * len(plan.tiles)
    assert folds == sum(p > 1 for p, _ in plan.tiles)
    return dk.to(k.dtype), dv.to(v.dtype)


def _operands(N, Nk, T, Tk, D, seed):
    rng = np.random.default_rng(seed)
    f = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((N, T, D), (Nk, Tk, D), (Nk, Tk, D), (N, T, D), (N, T),
                   (N, T))]
    q2, k, v, do, l2, dvec = f
    l2 = l2 + 6.0  # a log-sum-exp above the scores keeps P in (0, 1]
    l2[0, :3] = TF.NEG_INF  # dead rows
    return q2, k, v, do, l2, dvec


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


EMU_SHAPES = [(8, 2, 320, 320, True, None), (8, 2, 320, 320, True, 100),
              (4, 1, 200, 320, False, None), (8, 8, 192, 192, True, None),
              (8, 1, 192, 192, True, None), (4, 2, 200, 200, True, None),
              (4, 1, 256, 256, True, 70)]


@pytest.mark.parametrize("mxu", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", EMU_SHAPES, ids=_ids)
def test_emulated_items_match_plain_and_repeat_bitwise(shape, mxu):
    N, Nk, T, Tk, causal, window = shape
    ops = _operands(N, Nk, T, Tk, 32, sum(shape[:4]))
    cfg = TF._resolve_schedule(T, Tk, 32, torch.float32, causal, 64, 64,
                               mxu, "grid", None, False, None, None,
                               window) + (N // Nk,)
    want_dk, want_dv = TF.flash_bwd_dkv_plain(*ops, cfg)
    got = [emulate_dkv(*ops, causal, window, mxu, 16, seed)
           for seed in (1, 2)]
    bound = 3e-5 if mxu == torch.float32 else 1.6e-2
    dk, dv = got[0]
    assert _rel(dk, want_dk) <= bound and _rel(dv, want_dv) <= bound
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


def test_emulated_items_match_jax_flash_backward():
    """The emulation on the JAX package's own prepared operands against
    dK and dV of its ``_flash_backward`` (the Pallas dK/dV kernel in
    interpret mode), as test_plain_dq_dkv_match_jax_flash_backward."""
    N, G, T, D, window = 8, 4, 192, 32, None
    rng = np.random.default_rng(61)
    q, k, v, g_out = (rng.standard_normal(s).astype(np.float32)
                      for s in ((N, T, D), (N // G, T, D), (N // G, T, D),
                                (N, T, D)))
    g_lse = rng.standard_normal((N, T)).astype(np.float32)
    cfg_j = JF._resolve_schedule(T, T, D, jnp.dtype(jnp.float32), True, 64,
                                 64, True, jnp.float32, "grid", None, False,
                                 None, None, window) + (G,)
    out, lse = JF.flash_attention_packed_lse(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, block_q=64,
        block_k=64, interpret=True, mxu_dtype=jnp.float32, kernel="grid")
    _dq, want_dk, want_dv = JF._flash_backward(
        *(jnp.asarray(a) for a in (q, k, v)), out, lse, jnp.asarray(g_out),
        jnp.asarray(g_lse), cfg_j)
    t = torch.from_numpy
    qp, kp, vp, go = (t(a) for a in (q, k, v, g_out))
    q2 = (qp * (TF._LOG2E / float(D) ** 0.5))
    l2 = t(np.array(lse)) * TF._LOG2E
    dvec = (go * t(np.array(out))).sum(-1) - t(g_lse)
    dk, dv = emulate_dkv(q2, kp, vp, go, l2, dvec, True, window,
                         torch.float32, 132, 3)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), rtol=1e-5,
                               atol=1e-5)
