"""The launch geometry and the fold of the port's flash forward kernels
(csrc/flash.cu ``flash_fwd_fma`` and ``flash_fwd_wgmma``;
accl_tpu_torch/ops/flash.py ``fwd_walk``, ``fwd_heads``,
``kernel_ctas``), on the CPU.

- The tile rows and heads per CTA the wrapper reckons with are the
  ``constexpr``s compiled into csrc/flash.cu, and the CTA count is the
  kernel's launch grid.
- For ~20 shapes (causal, windowed, cross-length non-causal, ragged T =
  1200, MQA, GQA groups 1, 3, 4 and 8) in both MXU dtypes: the launch
  covers each (q head, q tile) exactly once, last q tiles first, the
  heads of one CTA under one K/V head; each q tile's walk is the k tiles
  holding a pair the masks keep, and a walked tile is masked exactly
  when it drops a pair.  At T and Tk multiples of 64 the walk is the
  JAX package's ``_grid_live_masked`` set from ``_window_first_block``,
  the masked flags its diagonal predicate.
- The kernels' fold emulated tile by tile (q tiles of 128 rows on the
  float32 mainloop and 64 on the bfloat16 one, 64-column k tiles, the
  running max rescaled at each, q K^T and P rounded to the MXU dtype where the
  kernels round them, the row sum over the unrounded P) is within
  chip_smoke.py's FLASH_BOUND of the plain versions (1e-5 for the
  float32 MXU dtype, 1.6e-2 for bfloat16), and at one small shape
  within 1e-5 of the JAX package's Pallas forward in interpret mode
  (float32 MXU dtype, as tests/test_torch_flash.py).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accl_tpu.ops.flash as JF
from accl_tpu_torch.ops import flash as TF

FLASH_CU = Path(TF.__file__).resolve().parent / "csrc" / "flash.cu"
B = TF.FWD_TILE
MXUS = (torch.float32, torch.bfloat16)
#: (N, Nk, T, Tk, causal, window)
SHAPES = [
    (8, 2, 4096, 4096, True, None), (4, 1, 8192, 8192, True, None),
    (8, 8, 640, 640, True, None), (8, 1, 640, 640, True, None),
    (32, 8, 2048, 2048, True, None), (8, 2, 1200, 1200, True, None),
    (8, 2, 1200, 1200, False, None), (4, 1, 2048, 2048, True, 1000),
    (4, 1, 2048, 2048, True, 64), (4, 2, 512, 512, True, 1),
    (8, 2, 1200, 1200, True, 100), (8, 2, 1024, 1536, False, None),
    (4, 1, 200, 320, False, None), (6, 3, 513, 513, True, None),
    (12, 4, 1000, 1000, True, 300), (2, 1, 63, 63, True, None),
    (1, 1, 1, 1, True, None), (3, 3, 100, 700, False, None),
    (16, 2, 4096, 4096, True, 512), (2, 1, 128, 4096, False, None),
    (4, 1, 96, 96, True, 5),
]


def _ids(shape):
    return "N{}_Nk{}_T{}_Tk{}_{}_w{}".format(*shape)


def test_tile_geometry_matches_the_kernel_source():
    src = FLASH_CU.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["BQ"]) == int(consts["BK"]) == TF.FWD_TILE
    assert int(consts["FMA_BQ"]) == TF.FWD_FMA_ROWS
    assert int(consts["MAX_HEADS"]) == TF.FWD_HEADS
    assert int(consts["WG_THREADS"]) == 128 and int(consts["FMA_THREADS"]) == 256
    # the launch grid is the wrapper's count: (N / heads) ceil(T / rows)
    # CTAs, rows BQ on the tensor-core mainloop and FMA_BQ on the fp32 one
    assert "const int rows = MMA ? BQ : FMA_BQ;" in src
    assert "(int64_t)(p.N / p.heads) * ((p.T + rows - 1) / rows)" in src
    # ... the heads of a CTA are adjacent q heads of one K/V head, q tiles
    # last first
    assert "n_qt - 1 - (int)(blockIdx.x / hp)" in src
    assert "const int n_qt = (p.T + FMA_BQ - 1) / FMA_BQ;" in src
    assert "walk(p, q0, FMA_BQ, first, end)" in src
    assert "walk(p, q0, BQ, first, end)" in src
    assert "(int)(blockIdx.x % hp) * p.heads" in src
    assert "kvn = n0 / p.group" in src
    # ... one head a CTA on the fp32 mainloop, heads dividing the group on
    # the bf16 one
    assert re.search(r"if \(!mxu_bf16\) return heads == 1;\s*return \(heads == 1 "
                     r"\|\| heads == MAX_HEADS\) && group % heads == 0;", src)
    # the walk and the masked test fwd_walk mirrors
    assert ("first = p.window > 0 ? max(q0 - (p.window - 1), 0) / BK : 0;"
            in src)
    assert "end = p.causal ? min((q0 + rows - 1) / BK + 1, nkt) : nkt;" in src
    assert re.search(r"return c0 \+ BK > p\.Tk \|\| \(p\.causal && c0 \+ BK - 1 > "
                     r"q0\) \|\|\s*\(p\.window > 0 && c0 < q0 \+ rows - "
                     r"p\.window\);", src)
    for group in (1, 2, 3, 4, 8):
        assert TF.fwd_heads(group, torch.float32) == 1
        assert TF.fwd_heads(group, torch.bfloat16) == (2 if group % 2 == 0
                                                      else 1)


def _kept(rows, cols, Tk, causal, window):
    r, c = np.asarray(rows)[:, None], np.asarray(cols)[None, :]
    keep = c < Tk
    if causal:
        keep = keep & (r >= c)
    if window:
        keep = keep & (r - c < window)
    return keep


@pytest.mark.parametrize("mxu", MXUS, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_launch_covers_each_head_and_q_tile_once(shape, mxu):
    N, Nk, T, Tk, causal, window = shape
    G = N // Nk
    heads = TF.fwd_heads(G, mxu)
    n_qt = -(-T // TF.fwd_rows(mxu))
    ctas = TF.kernel_ctas(N, T, G, mxu)
    assert ctas == N // heads * n_qt
    hp = N // heads
    seen, qts = [], []
    for b in range(ctas):  # the kernel's own index arithmetic
        qt = n_qt - 1 - b // hp
        n0 = (b % hp) * heads
        assert len({(n0 + h) // G for h in range(heads)}) == 1
        seen += [(n0 + h, qt) for h in range(heads)]
        qts.append(qt)
    assert sorted(seen) == [(n, qt) for n in range(N) for qt in range(n_qt)]
    assert qts == sorted(qts, reverse=True)


@pytest.mark.parametrize("rows", [B, TF.FWD_FMA_ROWS])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_walk_is_the_live_cells_and_the_pallas_schedule(shape, rows):
    _N, _Nk, T, Tk, causal, window = shape
    nkt = -(-Tk // B)
    for qt in range(-(-T // rows)):
        first, end, masked = TF.fwd_walk(qt, T, Tk, causal, window, rows)
        q0 = qt * rows
        real = range(q0, min(q0 + rows, T))
        virtual = range(q0, q0 + rows)  # the kernel's rows past T included
        live = [kt for kt in range(nkt)
                if _kept(real, range(kt * B, kt * B + B), Tk, causal,
                         window).any()]
        assert list(range(first, end)) == live
        for kt, m in zip(range(first, end), masked):
            kept = _kept(virtual, range(kt * B, kt * B + B), Tk, causal,
                         window)
            assert m == (not kept.all())
        if rows == B and T % B == 0 and Tk % B == 0:
            w = window
            want_first = (int(JF._window_first_block(qt, B, B, w)) if w
                          else 0)
            cells = [kt for kt in range(nkt)
                     if bool(JF._grid_live_masked(qt, kt, B, B, causal, w)[0])]
            assert first == (want_first if causal else 0)
            assert list(range(first, end)) == cells
            diag = [bool(JF._grid_live_masked(qt, kt, B, B, causal, w)[1])
                    for kt in range(first, end)]
            assert list(masked) == diag


def emulate_fwd(q, k, v, causal, window, mxu, static_max=None):
    """The forward kernels' fold in torch, tile by tile: per q tile of
    ``fwd_rows(mxu)`` rows the walk of ``fwd_walk``, 64-column tiles, the
    per-cell test on masked tiles only, the running max rescaled at each
    tile, q pre-scaled in the input dtype and rounded (with K and V) to the
    MXU dtype, P rounded to it before the PV product, the row sum over the
    unrounded P."""
    N, T, D = q.shape
    Nk, Tk = k.shape[:2]
    G = N // Nk
    R = TF.fwd_rows(mxu)
    scale = torch.tensor(TF._LOG2E / D ** 0.5, dtype=q.dtype)
    n_qt, nkt = -(-T // R), -(-Tk // B)

    def pad(x, rows):
        out = torch.zeros((x.shape[0], rows, D))
        out[:, :x.shape[1]] = x.to(mxu).float()
        return out

    qs = pad(q * scale, n_qt * R).reshape(Nk, G, n_qt * R, D)
    ks, vs = pad(k, nkt * B)[:, None], pad(v, nkt * B)[:, None]
    out = torch.empty((N, T, D), dtype=q.dtype)
    lse = torch.empty((N, T))
    neg, half = TF.NEG_INF, TF.NEG_INF / 2
    for qt in range(n_qt):
        first, end, masked = TF.fwd_walk(qt, T, Tk, causal, window, R)
        q0 = qt * R
        qb = qs[:, :, q0:q0 + R]
        m = torch.full((Nk, G, R, 1), neg)
        l = torch.zeros((Nk, G, R, 1))
        acc = torch.zeros((Nk, G, R, D))
        for kt, msk in zip(range(first, end), masked):
            c0 = kt * B
            s = qb @ ks[:, :, c0:c0 + B].transpose(-1, -2)
            if msk:
                keep = torch.from_numpy(_kept(range(q0, q0 + R),
                                              range(c0, c0 + B), Tk, causal,
                                              window))
                s = torch.where(keep, s, neg)
            if static_max is not None:
                p = torch.exp2(s - static_max)
                alpha = torch.ones_like(m)
            else:
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                shift = torch.where(m_new <= half, 0.0, m_new)
                p = torch.exp2(s - shift)
                if msk:
                    p = torch.where(s <= half, 0.0, p)
                alpha = torch.where(m <= half, 0.0, torch.exp2(m - shift))
                m = m_new
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(mxu).float() @ vs[:, :, c0:c0 + B]
        rows = min(R, T - q0)
        o = acc / torch.where(l == 0.0, 1.0, l)
        if static_max is not None:
            m = torch.where(l == 0.0, neg, static_max)
        ls = torch.where(m <= half, neg,
                         m * TF._LN2 + torch.log(torch.clamp_min(l, 1e-38)))
        out[:, q0:q0 + rows] = o.reshape(N, R, D)[:, :rows].to(q.dtype)
        lse[:, q0:q0 + rows] = ls.reshape(N, R)[:, :rows]
    return out, lse


#: (N, Nk, T, Tk, causal, window, static_max, kernel, input dtype)
EMU_CASES = [
    (8, 2, 320, 320, True, None, None, "resident", torch.float32),
    (8, 2, 200, 200, True, None, None, "resident", torch.float32),
    (4, 1, 256, 256, True, 70, None, "grid", torch.float32),
    (8, 2, 192, 320, False, None, None, "grid", torch.float32),
    (6, 3, 256, 256, True, None, 6.0, "grid", torch.float32),
    (8, 2, 256, 256, True, None, None, "resident", torch.bfloat16),
    (4, 1, 160, 160, True, 40, None, "grid", torch.bfloat16),
]


def _inputs(N, Nk, T, Tk, D, dt, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
            for s in ((N, T, D), (Nk, Tk, D), (Nk, Tk, D))]


@pytest.mark.parametrize("mxu", MXUS, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", EMU_CASES,
                         ids=lambda c: "_".join(str(x) for x in c[:8]))
def test_emulated_fold_matches_plain(case, mxu):
    N, Nk, T, Tk, causal, window, static_max, kernel, dt = case
    D = 32
    q, k, v = _inputs(N, Nk, T, Tk, D, dt, sum(case[:4]))
    cfg = TF._resolve_schedule(T, Tk, D, dt, causal, 256, 512, mxu, kernel,
                               None, False, None, None, window,
                               static_max) + (N // Nk,)
    plain = (TF.flash_fwd_resident_plain if kernel == "resident"
             else TF.flash_fwd_grid_plain)
    want, want_lse = plain(q, k, v, cfg)
    got, got_lse = emulate_fwd(q, k, v, causal, window, mxu, static_max)
    # a bf16 output rounds once more: the bf16 bound
    bound = 1e-5 if mxu == dt == torch.float32 else 1.6e-2
    assert float((got.float() - want.float()).abs().max()) <= bound
    assert float((got_lse - want_lse).abs().max()) <= bound


def test_emulated_fold_matches_jax_pallas_forward():
    """At a small GQA causal shape with a ragged last tile of the
    resolver's blocks, against the Pallas resident kernel in interpret
    mode (float32 MXU dtype)."""
    N, Nk, T, D = 8, 2, 192, 32
    q, k, v = _inputs(N, Nk, T, T, D, torch.float32, 71)
    jo, jl = JF.flash_attention_packed_lse(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True,
        block_q=64, block_k=128, interpret=True, mxu_dtype=jnp.float32,
        kernel="resident")
    got, got_lse = emulate_fwd(q, k, v, True, None, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
