"""Card-only tests of the port's CUDA kernels: each kernel against its
plain PyTorch version on the same CUDA tensors, and the model's forward
on the card against the same forward on the CPU.

This file imports torch and the port only, so it runs on a machine
without JAX, bypassing tests/conftest.py (which pins JAX to the CPU):

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

Without a card every test skips.
"""
import contextlib
import time

import numpy as np
import pytest
import torch

from accl_tpu_torch.models import transformer as TT
from accl_tpu_torch.ops import compression as TC
from accl_tpu_torch.ops import flash as TFL
from accl_tpu_torch.ops import fused as TF
from accl_tpu_torch.ops import reduce_ops as TR
from accl_tpu_torch.ops import ring as tring

pytestmark = pytest.mark.cuda
FLASH_DTYPES = [(torch.float32, torch.float32),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16)]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("dtype,op", [(torch.float32, "sum"),
                                      (torch.float32, "max"),
                                      (torch.int32, "sum")])
def test_kernels_match_plain_on_card(dtype, op):
    P, n = 8, 4099
    g = torch.Generator().manual_seed(7)
    base = (torch.randn(P, P, n, generator=g) * 100).to(dtype)
    xs = [base[r].cuda() for r in range(P)]
    got = tring.ring_reduce_scatter(xs, op)
    want = tring.ring_reduce_scatter_plain(xs, op)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    gathered = tring.ring_all_gather(got)
    for a, b in zip(gathered, tring.ring_all_gather_plain(got)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_match_plain_on_card(dtype):
    P, m, K, N = 8, 125, 333, 777
    g = torch.Generator().manual_seed(7)
    xs = [torch.randint(-3, 4, (P, m, K), generator=g).to(dtype).cuda()
          for _ in range(P)]
    ws = [torch.randint(-3, 4, (K, N), generator=g).to(dtype).cuda()
          for _ in range(P)]
    a = TF.pallas_matmul(xs[0][0], ws[0])
    assert torch.equal(a, TF.pallas_matmul_plain(xs[0][0], ws[0]))
    got = TF.fused_matmul_reduce_scatter(xs, ws)
    want = TF.fused_matmul_reduce_scatter_plain(xs, ws)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


MATMUL_EDGE_SHAPES = [(1, 1792, 4096), (127, 333, 777), (128, 1792, 4096),
                      (129, 40, 128), (4096, 1792, 4096), (64, 17, 129),
                      (512, 512, 4096)]


def _spread(x, w):
    """sqrt(K) 2^-24 (|x| @ |w|): the reach of fp32 rounding errors that
    add as a random walk (chip_smoke.py's ``ref64``)."""
    return (x.shape[-1] ** 0.5 * 2.0 ** -24
            * (x.double().abs() @ w.double().abs()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", MATMUL_EDGE_SHAPES)
def test_matmul_kernel_plans_match_plain_on_card(m, k, n, dtype):
    """accl_matmul under the plan for each shape (64- and 128-row tiles,
    splits of K, ragged and unaligned edges): bitwise on integers, within
    the fp32 spread on N(0, 1), and two launches on the same inputs give
    the same bits (the split's fixed-order sum)."""
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randint(-3, 4, (m, k), generator=g, device="cuda").to(dtype)
    w = torch.randint(-3, 4, (k, n), generator=g, device="cuda").to(dtype)
    before = TF.pallas_matmul.launches
    assert torch.equal(TF.pallas_matmul(x, w), TF.pallas_matmul_plain(x, w))
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    w = torch.randn(k, n, generator=g, device="cuda").to(dtype)
    a, b = TF.pallas_matmul(x, w), TF.pallas_matmul(x, w)
    torch.cuda.synchronize()
    assert TF.pallas_matmul.launches == before + 3
    assert torch.equal(a, b)
    plain = TF.pallas_matmul_plain(x, w)
    assert bool(((a.double() - plain.double()).abs() <= _spread(x, w)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,m,K,N", [(2, 64, 96, 256), (3, 100, 333, 777),
                                     (8, 512, 1792, 4096), (8, 125, 40, 130)])
def test_fused_kernel_back_to_back_matches_plain_on_card(P, m, K, N, dtype):
    """accl_fused_matmul_rs launched three times back to back on one
    stream with no memset between (each block leaves its flags at 0),
    bitwise on integers each time, and within the fp32 spread of the
    plain version on N(0, 1) (K = P K: the sum runs over P ranks)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    xs = [torch.randint(-3, 4, (P, m, K), generator=g,
                        device="cuda").to(dtype) for _ in range(P)]
    ws = [torch.randint(-3, 4, (K, N), generator=g,
                        device="cuda").to(dtype) for _ in range(P)]
    want = TF.fused_matmul_reduce_scatter_plain(xs, ws)
    before = TF.fused_matmul_reduce_scatter.launches
    runs = [TF.fused_matmul_reduce_scatter(xs, ws) for _ in range(3)]
    torch.cuda.synchronize()
    assert TF.fused_matmul_reduce_scatter.launches == before + 3
    for got in runs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    xs = [torch.randn(P, m, K, generator=g, device="cuda").to(dtype)
          for _ in range(P)]
    ws = [torch.randn(K, N, generator=g, device="cuda").to(dtype)
          for _ in range(P)]
    got = TF.fused_matmul_reduce_scatter(xs, ws)
    again = TF.fused_matmul_reduce_scatter(xs, ws)
    want = TF.fused_matmul_reduce_scatter_plain(xs, ws)
    torch.cuda.synchronize()
    absref = sum(x.double().abs() @ w.double().abs() for x, w in zip(xs, ws))
    spread = (P * K) ** 0.5 * 2.0 ** -24 * absref
    for r in range(P):
        assert torch.equal(got[r], again[r])
        assert bool(((got[r].double() - want[r].double()).abs()
                     <= spread[r]).all())


def test_matmul_kernels_launch_above_48kb_of_shared_memory_on_card():
    """The fp32 128-row kernels take 64 KB of dynamic shared memory: the
    opt-in is set before the occupancy query and the launch, which the
    runtime would otherwise refuse."""
    import ctypes

    from accl_tpu_torch.ops import _build

    lib = _build.load("fused")
    info = {}
    for which in range(6):
        out = (ctypes.c_int * 5)()
        assert lib.accl_fused_kernel_info(which, 0, out) == 0
        info[which] = list(out)
    assert info[0][3] > 48 * 1024 and info[4][3] > 48 * 1024
    assert all(v[4] >= 1 for v in info.values())
    assert TF._resident(0, 0) >= 8
    x = torch.ones(4096, 64, device="cuda")
    w = torch.ones(64, 4096, device="cuda")
    assert TF.matmul_plan(4096, 4096, 64, TF._sms(0)).bm == 128
    assert torch.equal(TF.pallas_matmul(x, w),
                       torch.full((4096, 4096), 64.0, device="cuda"))
    xs = [torch.ones(8, 128, 64, device="cuda") for _ in range(8)]
    ws = [torch.ones(64, 256, device="cuda") for _ in range(8)]
    for o in TF.fused_matmul_reduce_scatter(xs, ws):
        assert torch.equal(o, torch.full((128, 256), 512.0, device="cuda"))


@pytest.mark.parametrize("dt,mxu", FLASH_DTYPES)
@pytest.mark.parametrize("kernel,causal,window", [
    ("resident", True, None), ("resident", False, None),
    ("grid", True, None), ("grid", True, 100), ("grid_resident", False, None)])
def test_flash_kernels_match_plain_on_card(kernel, causal, window, dt, mxu):
    """Bounds as chip_smoke.py's FLASH_BOUND: 1e-5 for the float32 MXU
    dtype, 1.6e-2 (two bf16 ulps) for bfloat16."""
    g = torch.Generator(device="cuda").manual_seed(3)
    N, Nk, T, D = 8, 2, 320, 128
    Tk = T if causal else 200
    q = torch.randn(N, T, D, generator=g, device="cuda").to(dt)
    k = torch.randn(Nk, Tk, D, generator=g, device="cuda").to(dt)
    v = torch.randn(Nk, Tk, D, generator=g, device="cuda").to(dt)
    cfg = TFL._resolve_schedule(T, Tk, D, dt, causal, 64, 64, mxu, kernel,
                                None, False, None, None, window) + (N // Nk,)
    fn = TFL.flash_fwd_resident if kernel == "resident" \
        else TFL.flash_fwd_grid
    plain = TFL.flash_fwd_resident_plain if kernel == "resident" \
        else TFL.flash_fwd_grid_plain
    before = fn.launches
    out, lse = TFL.flash_attention_packed_lse(
        q, k, v, causal=causal, mxu_dtype=mxu, kernel=kernel, window=window,
        block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want, want_lse = plain(q, k, v, cfg)
    tol = 1e-5 if mxu == torch.float32 else 1.6e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=tol)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (N, Nk, T, Tk, causal, window, static_max, kernel)
    (8, 2, 1200, 1200, True, None, None, "resident"),   # ragged T
    (8, 2, 1200, 1200, True, None, None, "grid"),
    (8, 2, 1024, 1536, False, None, None, "resident"),  # cross length
    (8, 2, 1024, 1536, False, None, None, "grid"),
    (4, 1, 2048, 2048, True, 1000, None, "grid"),       # window
    (8, 2, 640, 640, True, None, 12.0, "resident"),     # static_max
    (8, 2, 640, 640, True, None, 12.0, "grid"),
    (6, 3, 640, 640, True, None, None, "resident"),     # odd group: 1 head
], ids=lambda c: "_".join(str(x) for x in c))
def test_flash_tensor_core_forward_matches_plain_on_card(case, dt, D):
    """The bfloat16 MXU dtype (the tensor-core mainloop, two q heads of a
    GQA group per CTA where the group is even) against the plain version
    within chip_smoke.py's FLASH_BOUND for bf16, 1.6e-2 (two bf16 ulps)."""
    N, Nk, T, Tk, causal, window, static_max, kernel = case
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(N, T, D, generator=g, device="cuda").to(dt)
    k = torch.randn(Nk, Tk, D, generator=g, device="cuda").to(dt)
    v = torch.randn(Nk, Tk, D, generator=g, device="cuda").to(dt)
    mxu = torch.bfloat16
    cfg = TFL._resolve_schedule(T, Tk, D, dt, causal, 256, 512, mxu, kernel,
                                None, False, None, None, window,
                                static_max) + (N // Nk,)
    fn = TFL.flash_fwd_resident if kernel == "resident" \
        else TFL.flash_fwd_grid
    plain = TFL.flash_fwd_resident_plain if kernel == "resident" \
        else TFL.flash_fwd_grid_plain
    before = (fn.launches, fn.launches_tc)
    out, lse = fn(q, k, v, cfg)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_tc) == (before[0] + 1, before[1] + 1)
    want, want_lse = plain(q, k, v, cfg)
    assert bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1.6e-2)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1.6e-2)


@pytest.mark.parametrize("dt,mxu", FLASH_DTYPES)
@pytest.mark.parametrize("kernel", ["resident", "grid", "resident_skew"])
def test_flash_forward_repeats_bitwise_on_card(kernel, dt, mxu):
    """Two launches of each forward kernel on the same operands give the
    same bits (out and lse)."""
    g = torch.Generator(device="cuda").manual_seed(12)
    N, Nk, T, D = 8, 2, 1200, 128
    q = torch.randn(N, T, D, generator=g, device="cuda").to(dt)
    k = torch.randn(Nk, T, D, generator=g, device="cuda").to(dt)
    v = torch.randn(Nk, T, D, generator=g, device="cuda").to(dt)
    cfg = TFL._resolve_schedule(T, T, D, dt, True, 256, 512, mxu, kernel,
                                None, False, None, None) + (N // Nk,)
    fn = getattr(TFL, f"flash_fwd_{kernel}")
    first = fn(q, k, v, cfg)
    for _ in range(3):
        again = fn(q, k, v, cfg)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
def test_model_forward_on_card_matches_cpu(fused):
    """The tp = 2 flash forward of a small GQA/SwiGLU/RoPE model: on the
    card (flash kernels, cuBLAS) against the CPU (plain versions), float32
    at rtol = atol = 1e-4 (other summation orders on both sides)."""
    cfg = TT.ModelConfig(vocab=96, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_head=32, d_ff=128, mlp="swiglu",
                         rope=True, attn="flash")
    cpu = TT.init_params(np.random.default_rng(5), cfg, tp=2, device="cpu")
    card = TT.init_params(np.random.default_rng(5), cfg, tp=2)
    assert card["embed"].device.type == "cuda"
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 96))
    before = TFL.flash_fwd_resident.launches
    got = TT.forward(card, torch.from_numpy(tokens), cfg, fused=fused)
    torch.cuda.synchronize()
    assert TFL.flash_fwd_resident.launches == before + cfg.n_layers * 2
    want = TT.forward(cpu, torch.from_numpy(tokens), cfg, fused=fused)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _bwd_operands(N, Nk, T, Tk, dt, mxu, causal, window, g_lse, seed):
    """The prepared operands of ``_flash_backward`` on the card: a forward
    through the kernels, a random dO (and g_lse), the host prep."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = 64
    q = torch.randn(N, T, D, generator=g, device="cuda").to(dt)
    k = torch.randn(Nk, Tk, D, generator=g, device="cuda").to(dt)
    v = torch.randn(Nk, Tk, D, generator=g, device="cuda").to(dt)
    cfg = TFL._resolve_schedule(T, Tk, D, dt, causal, 64, 128, mxu, "auto",
                                None, False, None, None, window) + (N // Nk,)
    out, lse = TFL._flash_forward_impl(q, k, v, cfg)
    do = torch.randn(N, T, D, generator=g, device="cuda").to(dt)
    a = 1.0 / D ** 0.5
    q2 = (q.float() * (a * TFL._LOG2E)).to(dt)
    l2 = (lse * TFL._LOG2E).contiguous()
    dvec = (do.float() * out.float()).sum(-1)
    if g_lse:
        dvec = dvec - torch.randn(N, T, generator=g, device="cuda")
    return (q2, k, v, do, l2, dvec.contiguous()), cfg


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("dt,mxu", FLASH_DTYPES)
@pytest.mark.parametrize("case", [
    (8, 2, 320, 320, True, None, True),     # GQA causal, g_lse
    (8, 2, 320, 320, True, 100, False),     # window
    (4, 1, 200, 320, False, None, True),    # cross-length, MQA, ragged
])
def test_flash_bwd_kernels_match_plain_on_card(case, dt, mxu):
    """Bounds as chip_smoke.py's BWD_BOUND, on max |kernel - plain| over
    max |plain|: 3e-5 for the float32 MXU dtype, 1.6e-2 (two bf16 ulps)
    for bfloat16."""
    N, Nk, T, Tk, causal, window, g_lse = case
    ops, cfg = _bwd_operands(N, Nk, T, Tk, dt, mxu, causal, window, g_lse, 4)
    before = (TFL.flash_bwd_dq.launches, TFL.flash_bwd_dkv.launches)
    dq = TFL.flash_bwd_dq(*ops, cfg)
    dk, dv = TFL.flash_bwd_dkv(*ops, cfg)
    torch.cuda.synchronize()
    assert (TFL.flash_bwd_dq.launches, TFL.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want_dq = TFL.flash_bwd_dq_plain(*ops, cfg)
    want_dk, want_dv = TFL.flash_bwd_dkv_plain(*ops, cfg)
    bound = 3e-5 if mxu == torch.float32 else 1.6e-2
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, want) <= bound


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_repeat_bitwise_on_card(dt):
    """Two launches of each backward kernel on the same operands give the
    same bits: dK/dV's split tiles sum their partials in a fixed order
    whichever item arrives last, and no float atomics run."""
    ops, cfg = _bwd_operands(8, 2, 1024, 1024, dt, dt, True, None, True, 6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert TFL.bwd_plan(8, 2, 1024, 1024, True, 0, sms, dt).slots > 0
    first = (TFL.flash_bwd_dq(*ops, cfg), *TFL.flash_bwd_dkv(*ops, cfg))
    for _ in range(3):
        again = (TFL.flash_bwd_dq(*ops, cfg), *TFL.flash_bwd_dkv(*ops, cfg))
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dt,mxu", FLASH_DTYPES)
@pytest.mark.parametrize("N,Nk,T", [(4, 4, 640), (8, 2, 640), (8, 1, 640),
                                    (8, 2, 1200)])
def test_flash_bwd_split_tiles_match_plain_on_card(N, Nk, T, dt, mxu):
    """dK/dV run as plan items with split tiles at GQA groups 1, 4 and 8
    and at a ragged T, within the bounds of
    test_flash_bwd_kernels_match_plain_on_card."""
    ops, cfg = _bwd_operands(N, Nk, T, T, dt, mxu, True, None, True, 8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = TFL.bwd_plan(N, Nk, T, T, True, 0, sms, mxu)
    assert plan.slots > 0 and len(plan.items) > len(plan.tiles)
    dq = TFL.flash_bwd_dq(*ops, cfg)
    dk, dv = TFL.flash_bwd_dkv(*ops, cfg)
    torch.cuda.synchronize()
    want_dq = TFL.flash_bwd_dq_plain(*ops, cfg)
    want_dk, want_dv = TFL.flash_bwd_dkv_plain(*ops, cfg)
    bound = 3e-5 if mxu == torch.float32 else 1.6e-2
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, want) <= bound


def test_model_train_step_on_card_matches_cpu():
    """One dp 2 x tp 2 flash train step of a small GQA/SwiGLU/RoPE model on
    the card (flash kernels forward and backward, cuBLAS) against the same
    step on the CPU (plain versions): loss within rtol 1e-5, parameters
    within rtol 1e-4 / atol 1e-6 (float32 sums in other orders)."""
    cfg = TT.ModelConfig(vocab=96, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_head=32, d_ff=128, mlp="swiglu",
                         rope=True, attn="flash")
    from accl_tpu_torch.parallel import make_mesh

    tokens = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 96))
    results = []
    for dev in ("cpu", "cuda"):
        params = TT.init_params(np.random.default_rng(5), cfg, tp=2,
                                device=dev)
        step, _ = TT.make_train_step(make_mesh(dp=2, tp=2, device=dev), cfg,
                                     lr=0.1)
        before = (TFL.flash_bwd_dq.launches, TFL.flash_bwd_dkv.launches)
        params, loss = step(params, torch.from_numpy(tokens))
        torch.cuda.synchronize()
        launched = (TFL.flash_bwd_dq.launches - before[0],
                    TFL.flash_bwd_dkv.launches - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (8, 8))
        results.append((params, float(loss)))
    (cpu, cpu_loss), (card, card_loss) = results
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for a, b in zip(TT.tree_leaves(card), TT.tree_leaves(cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", list(TR.KERNEL_DTYPES))
@pytest.mark.parametrize("n,block_rows", [(4099, 0), (1 << 20, 16)])
def test_combine_kernel_matches_plain_on_card(dtype, n, block_rows):
    """Every ARITH_LANE lane (6 dtypes x sum, max), bitwise against a + b
    and torch.maximum, a ragged length included, and donate in place."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, n, generator=g, device="cuda")
    if not dtype.is_floating_point:
        x = x * 1000
    a, b = x[0].to(dtype), x[1].to(dtype)
    b[:7] = a[:7]
    before = TR._pallas_combine_2d.launches
    assert torch.equal(TR.pallas_add(a, b, block_rows=block_rows), a + b)
    assert torch.equal(TR.pallas_max(a, b), torch.maximum(a, b))
    want = a + b
    assert TR.pallas_add(a, b, donate=True) is a and torch.equal(a, want)
    torch.cuda.synchronize()
    assert TR._pallas_combine_2d.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_cast_kernels_match_tensor_to_on_card(dtype):
    """Nearest-even casts both ways, bitwise against Tensor.to: NaN, inf,
    overflow and fp16 subnormals included, at a ragged length."""
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(3 * 512 * 7 + 5, generator=g, device="cuda") * 4
    x[:9] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                          70000.0, -0.0, 1e-6, 3e-8, 6e-5, 65520.0],
                         device="cuda")
    before = TC._cast_2d.launches
    y = TC.compress_cast(x, dtype)
    assert torch.equal(y.view(torch.int16), x.to(dtype).view(torch.int16))
    z = TC.decompress_cast(y)
    assert torch.equal(z.view(torch.int32), y.float().view(torch.int32))
    torch.cuda.synchronize()
    assert TC._cast_2d.launches == before + 2


@pytest.mark.parametrize("dtype", list(TC.STOCHASTIC_TARGETS))
@pytest.mark.parametrize("block_rows", [TC._BLOCK_ROWS, 3])
def test_stochastic_cast_kernel_matches_plain_on_card(dtype, block_rows):
    """Stochastic rounding bitwise against its plain version on the same
    CUDA tensor (the hash and the rounding in integer torch ops)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(40, 512, generator=g, device="cuda") * 30
    x[0, :6] = torch.tensor([float("inf"), -float("inf"), 1e6, -1e6, 1e-30,
                             -0.0], device="cuda")
    got = TC._cast_2d(x, 12345, dtype, True, block_rows)
    want = TC._cast_2d_plain(x, 12345, dtype, True, block_rows)
    iv = torch.int16 if dtype == torch.bfloat16 else torch.uint8
    torch.cuda.synchronize()
    assert torch.equal(got.view(iv), want.view(iv))
    assert torch.equal(TC.decompress_cast(got), got.float())


#: stochastic rounding's edge inputs (chip_smoke.py SR_EDGES): NaN, fp32
#: subnormals, +-FLT_MAX, inf, zeros, the fp8 range thresholds and values
#: below 2^-24 (the kernel's 64-bit add)
SR_EDGES = [float("nan"), -float("nan"), 1e-40, -1e-40, 1.4e-45,
            3.4028235e38, -3.4028235e38, float("inf"), -float("inf"), 0.0,
            -0.0, 57344.0, 61440.0, 65504.0, 65520.0, 65535.0, 65536.0,
            -65536.0, 448.0, 464.0, 479.0, 480.0, -480.0, 2.0 ** -14,
            2.0 ** -15, 2.0 ** -6, 2.0 ** -7, 2.0 ** -16, 2.0 ** -9,
            2.0 ** -17, 2.0 ** -18, 2.0 ** -24, 2.0 ** -25, 3e-8, 1e-10,
            -1e-10, 1e-30, 1.0 + 2.0 ** -12]


def _same_bits_or_nan(a, b):
    """Bitwise equal where neither is NaN, NaN in the same places (the
    widening cast keeps cvt's NaN payload)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and _same_bits(a[~na], b[~nb])


def _edge_input(g, shape):
    x = torch.randn(shape, generator=g, device="cuda") * 30
    flat = x.view(-1)
    flat[:len(SR_EDGES)] = torch.tensor(SR_EDGES, device="cuda")[:flat.numel()]
    if flat.numel() > 4096:
        flat[1024:2048] *= 1e-10  # below 2^-24
        flat[2048:3072] *= 1e-6   # fp8 subnormals
        flat[3072:4096] *= 1e-40  # fp32 subnormals
    return x


@pytest.mark.parametrize("dtype", list(TC.STOCHASTIC_TARGETS))
@pytest.mark.parametrize("shape,block_rows", [((64, 512), 16), ((40, 5), 3),
                                              ((7, 3), 1)])
def test_stochastic_cast_edges_match_plain_on_card(dtype, shape, block_rows):
    """The stochastic edges bitwise against the plain version, at the
    lane's width, at a tile of 15 elements and at tiles of 3; the
    widening cast after them (NaN where NaN)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    x = _edge_input(g, shape)
    got = TC._cast_2d(x, 99, dtype, True, block_rows)
    want = TC._cast_2d_plain(x, 99, dtype, True, block_rows)
    back = TC.decompress_cast(got)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert _same_bits_or_nan(back, got.float())


@pytest.mark.parametrize("dtype", list(TC.STOCHASTIC_TARGETS))
def test_stochastic_cast_repeats_for_one_seed_on_card(dtype):
    g = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn(1000, 512, generator=g, device="cuda") * 30
    a = TC._cast_2d(x, 5, dtype, True, 7)
    b = TC._cast_2d(x, 5, dtype, True, 7)
    c = TC._cast_2d(x, 6, dtype, True, 7)
    torch.cuda.synchronize()
    assert _same_bits(a, b) and not _same_bits(a, c)


@pytest.mark.parametrize("dtype", list(TR.KERNEL_DTYPES))
def test_combine_kernel_on_unaligned_views_matches_plain_on_card(dtype):
    """Operands one element off 16-byte alignment take the element path:
    bitwise the plain version, sum, max and donate."""
    g = torch.Generator(device="cuda").manual_seed(19)
    rows = 1031
    bufs = [torch.randn(rows * 128 + 1, generator=g, device="cuda") * 1000
            for _ in range(2)]
    a, b = (t.to(dtype)[1:].view(rows, 128) for t in bufs)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    for is_max in (False, True):
        got = TR._pallas_combine_2d(a, b, is_max)
        assert _same_bits(got, TR._combine_2d_plain(a, b, is_max))
    want = a + b
    assert TR._pallas_combine_2d(a, b, False, 0, True) is a
    torch.cuda.synchronize()
    assert _same_bits(a, want)


@pytest.mark.parametrize("pair", ["f16", "bf16", "sr_bf16", "sr_e5m2",
                                  "sr_e4m3fn", "widen_f16", "widen_bf16",
                                  "widen_e5m2", "widen_e4m3fn"])
def test_cast_kernel_on_unaligned_views_matches_plain_on_card(pair):
    """A source one element off 16-byte alignment takes the element path:
    bitwise the plain version (NaN where NaN for the fp8 widening)."""
    dts = {"f16": torch.float16, "bf16": torch.bfloat16,
           "e5m2": torch.float8_e5m2, "e4m3fn": torch.float8_e4m3fn}
    g = torch.Generator(device="cuda").manual_seed(20)
    x = _edge_input(g, (129 * 512 + 1,))
    kind, _, name = pair.rpartition("_")
    if kind == "widen":
        src = dts[name]
        buf = torch.empty(x.numel(), dtype=src, device="cuda")
        buf.copy_(x.to(src))
        xu = buf[1:].view(129, 512)
        got = TC._cast_2d(xu, 0, torch.float32, False, 7)
        torch.cuda.synchronize()
        assert _same_bits_or_nan(got, xu.float())
        if src in (torch.float16, torch.bfloat16):
            assert _same_bits(got, xu.float())
        return
    xu = x[1:].view(129, 512)
    assert xu.data_ptr() % 16
    stochastic = kind == "sr"  # else "" (nearest even)
    got = TC._cast_2d(xu, 3, dts[name], stochastic, 7)
    want = TC._cast_2d_plain(xu, 3, dts[name], stochastic, 7)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


def test_streaming_kernels_fit_without_spills_on_card():
    """Every instantiation of both streaming kernels fits on an SM and
    keeps no thread state in local memory; the plan gives one CTA per
    block."""
    dev = torch.cuda.current_device()
    for code in TR.KERNEL_DTYPES.values():
        for is_max in (False, True):
            for vec in (False, True):
                info = TR.combine_kernel_info(code, is_max, vec, dev)
                assert info["ctas_per_sm"] >= 1 and info["local_bytes"] == 0
    pairs = ([(torch.float32, d, False) for d in TC.NEAREST_TARGETS]
             + [(s, torch.float32, False) for s in TC.WIDEN_SOURCES]
             + [(torch.float32, d, True) for d in TC.STOCHASTIC_TARGETS])
    for src, dst, sr in pairs:
        for vec in (False, True):
            info = TC.cast_kernel_info(src, dst, sr, vec, dev)
            assert info["ctas_per_sm"] >= 1 and info["local_bytes"] == 0
    assert TR.stream_plan(1 << 24).grid == (1 << 24) // TR.STREAM_THREADS
    assert TR.stream_plan(1000).grid == 4


@pytest.mark.parametrize("dt,mxu", FLASH_DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_skew_kernel_matches_resident_on_card(causal, dt, mxu):
    """flash_fwd_resident_skew bitwise equal to flash_fwd_resident (same
    device functions, same fold order) and within chip_smoke.py's
    FLASH_BOUND of its plain version."""
    g = torch.Generator(device="cuda").manual_seed(8)
    N, Nk, T, D = 8, 2, 320, 128
    q = torch.randn(N, T, D, generator=g, device="cuda").to(dt)
    k = torch.randn(Nk, T, D, generator=g, device="cuda").to(dt)
    v = torch.randn(Nk, T, D, generator=g, device="cuda").to(dt)
    before = TFL.flash_fwd_resident_skew.launches
    out, lse = TFL.flash_attention_packed_lse(
        q, k, v, causal=causal, mxu_dtype=mxu, kernel="resident_skew",
        block_q=64, block_k=64)
    ref, ref_lse = TFL.flash_attention_packed_lse(
        q, k, v, causal=causal, mxu_dtype=mxu, kernel="resident",
        block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert TFL.flash_fwd_resident_skew.launches == before + 1
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    cfg = TFL._resolve_schedule(T, T, D, dt, causal, 64, 64, mxu,
                                "resident_skew", None, False, None,
                                None) + (N // Nk,)
    want, want_lse = TFL.flash_fwd_resident_skew_plain(q, k, v, cfg)
    tol = 1e-5 if mxu == torch.float32 else 1.6e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=tol)


def _same_bits(a, b):
    if a.dtype.is_floating_point:
        iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[a.element_size()]
        return torch.equal(a.view(iv), b.view(iv))
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(tring.KERNEL_DTYPES))
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("N,seg", [(8 * 3 * 4096, 8 * 4096),
                                   (3 * 8 * 4099 + 13, 8 * 4099),
                                   (8 * 37 + 5, 16), (5, 1 << 18)])
def test_segment_walk_matches_plain_on_card(dtype, op, N, seg):
    """The segmented allreduce, one launch per phase over every segment,
    bitwise against the plain composition (the reference's padded
    segments): whole segments of several tiles, odd N with a ragged tail,
    many small segments, fewer elements than ranks; MAX with NaN
    present; out of place and in place."""
    P = 8
    g = torch.Generator(device="cuda").manual_seed(9)
    xs = []
    for r in range(P):
        x = torch.randn(N, generator=g, device="cuda") * 1000
        x = x.to(dtype)
        if op == "max" and dtype.is_floating_point:
            x[r::97] = float("nan")
        xs.append(x)
    want = tring.ring_all_reduce_segmented(xs, op, seg, plain=True)
    before = (tring.ring_reduce_scatter.launches,
              tring.ring_all_gather.launches)
    got = tring.ring_all_reduce_segmented(xs, op, seg)
    same = [x.clone() for x in xs]
    tring.ring_all_reduce_segmented(same, op, seg, out=same)
    torch.cuda.synchronize()
    assert (tring.ring_reduce_scatter.launches - before[0],
            tring.ring_all_gather.launches - before[1]) == (2, 2)
    for r in range(P):
        assert _same_bits(got[r], want[r])
        assert _same_bits(same[r], want[r])


def test_segmented_drivers_refuse_unsafe_out_on_card():
    """A result that overlaps an operand without being its own rank's
    (allreduce) is refused before any launch."""
    P, n = 8, 4096
    base = torch.zeros(P, 3 * P * n, device="cuda")
    xs = [base[r, :n] for r in range(P)]
    before = (tring.ring_reduce_scatter.launches,
              tring.ring_all_gather.launches)
    with pytest.raises(ValueError, match="overlaps"):
        tring.ring_all_reduce_segmented(
            xs, "sum", out=[base[r, 4:n + 4] for r in range(P)])
    with pytest.raises(ValueError, match="overlaps"):
        tring.ring_all_reduce_segmented(xs, "sum", out=xs[1:] + xs[:1])
    with pytest.raises(ValueError, match="overlaps"):
        tring.ring_all_gather_segmented(
            xs, out=[base[r, :P * n] for r in range(P)])
    assert (tring.ring_reduce_scatter.launches,
            tring.ring_all_gather.launches) == before


@pytest.mark.parametrize("dtype", list(tring.KERNEL_DTYPES))
@pytest.mark.parametrize("n", [1, 256, 4099, 3 * 32768 + 7])
def test_one_segment_kernels_match_plain_on_card(dtype, n):
    """ring_reduce_scatter and ring_all_gather on one segment, one tile
    to many, with strided operand rows and strided result rows."""
    P = 8
    g = torch.Generator(device="cuda").manual_seed(10)
    xs = [(torch.randn(P, n + 3, generator=g, device="cuda") * 1000)
          .to(dtype)[:, :n] for _ in range(P)]
    got = tring.ring_reduce_scatter(xs, "sum")
    outs = [torch.zeros(P, n + 5, dtype=dtype, device="cuda")[:, :n]
            for _ in range(P)]
    gathered = tring.ring_all_gather(got, out=outs)
    torch.cuda.synchronize()
    for a, b in zip(got, tring.ring_reduce_scatter_plain(xs, "sum")):
        assert _same_bits(a, b)
    for a, b in zip(gathered, tring.ring_all_gather_plain(got)):
        assert _same_bits(a, b)


def test_driver_ring_lane_one_launch_per_phase_on_card():
    """CudaWorld on the card: an in-place allreduce over 3 segments and a
    ragged tail launches each ring kernel once and writes the result
    buffers directly, bitwise equal to the plain composition."""
    from accl_tpu_torch import CudaWorld

    P, N = 4, 3 * (1 << 18) + 7
    with CudaWorld(P) as world:
        world.engine.ring_threshold_bytes = 0
        g = torch.Generator(device="cuda").manual_seed(11)
        bufs = [world.accls[r].create_buffer(N, np.float32) for r in range(P)]
        for b in bufs:
            b.dev.copy_(torch.randn(N, generator=g, device="cuda"))
        want = tring.ring_all_reduce_segmented([b.dev.clone() for b in bufs],
                                               "sum", plain=True)
        before = (tring.ring_reduce_scatter.launches,
                  tring.ring_all_gather.launches)
        world.run(lambda a, r: a.allreduce(bufs[r], bufs[r], N,
                                           from_fpga=True, to_fpga=True))
        torch.cuda.synchronize()
        assert (tring.ring_reduce_scatter.launches - before[0],
                tring.ring_all_gather.launches - before[1]) == (1, 1)
        for r in range(P):
            assert torch.equal(bufs[r].dev, want[r])


# ---------------------------------------------------------------------------
# observability on the card: the ring's device-trace stamp mode and the
# driver's spans
# ---------------------------------------------------------------------------
@pytest.fixture
def _devtrace(monkeypatch):
    """The ACCL_DEVICE_TRACE gate on, a clean collector; reset after."""
    from accl_tpu_torch.observability import trace as obs_trace

    def set_gate(on):
        if on:
            monkeypatch.setenv("ACCL_DEVICE_TRACE", "1")
        else:
            monkeypatch.delenv("ACCL_DEVICE_TRACE", raising=False)
        tring._reset_device_trace_cache()
        obs_trace.collector().clear()
        return obs_trace.collector()

    yield set_gate
    tring._reset_device_trace_cache()
    obs_trace.collector().clear()


def _trace_records(col):
    from collections import Counter

    return Counter((r["collective"], tuple(map(tuple, r["rows"])))
                   for r in col.device_records())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int64])
@pytest.mark.parametrize("case", ["allreduce", "allgather", "reduce_scatter"])
@pytest.mark.parametrize("N,seg", [(8 * 3 * 4096 + 13, 8 * 4096), (5, 16),
                                   (8 * 37 + 5, 16)])
def test_stamp_rows_match_plain_on_card(_devtrace, dtype, case, N, seg):
    """The stamp instantiation's rows, landed after the launch, equal the
    plain version's rows for every (segment, rank); the results are
    bitwise those of the gate-off kernels."""
    P = 8
    g = torch.Generator(device="cuda").manual_seed(12)
    n = N * (P if case == "reduce_scatter" else 1)
    xs = [(torch.randn(n, generator=g, device="cuda") * 100).to(dtype)
          for _ in range(P)]
    fn = {"allreduce": lambda **k: tring.ring_all_reduce_segmented(
              xs, "sum", seg, **k),
          "allgather": lambda **k: tring.ring_all_gather_segmented(
              xs, seg, **k),
          "reduce_scatter": lambda **k: tring.ring_reduce_scatter_segmented(
              xs, "sum", seg, **k)}[case]
    _devtrace(False)
    off = fn()
    torch.cuda.synchronize()
    col = _devtrace(True)
    fn(plain=True)
    plain_rows = _trace_records(col)
    col.clear()
    on = fn()
    assert _trace_records(col) == plain_rows
    for a, b in zip(on, off):
        assert _same_bits(a, b)


@pytest.mark.parametrize("kind", ["all_gather", "reduce_scatter"])
def test_direct_wrapper_lands_its_rows_on_card(_devtrace, kind):
    """A caller of the bare wrappers (the TP path, parallel.collectives)
    gets its rows in the collector when the call returns: one record
    per rank, the schedule's rows."""
    P, n = 8, 4096
    g = torch.Generator(device="cuda").manual_seed(13)
    col = _devtrace(True)
    if kind == "all_gather":
        tring.ring_all_gather([torch.randn(n, generator=g, device="cuda")
                               for _ in range(P)])
    else:
        tring.ring_reduce_scatter([torch.randn(P, n, generator=g,
                                               device="cuda")
                                   for _ in range(P)])
    want = {(kind, tuple(map(tuple, rows.tolist()))): 1
            for rows in tring.stamp_rows(P, n * 4)}
    assert _trace_records(col) == want


def test_stamp_instantiations_fit_without_spills_on_card():
    for kind in (0, 1, 2):
        off = tring.kernel_info(kind, torch.float32, False)
        on = tring.kernel_info(kind, torch.float32, True)
        assert off["local_bytes"] == on["local_bytes"] == 0
        assert min(off["blocks_per_sm"], on["blocks_per_sm"]) >= 2


def test_driver_spans_in_order_at_4mib_on_card():
    """Tracing on: every stage of an 8-rank 4 MiB allreduce is stamped in
    order, and the device window closes after the stream's sync."""
    from accl_tpu_torch import CudaWorld
    from accl_tpu_torch.observability import trace as obs_trace

    P, N = 8, (4 << 20) // 4
    col = obs_trace.enable()
    col.clear()
    try:
        with CudaWorld(P) as world:
            bufs = [world.accls[r].create_buffer(N, np.float32)
                    for r in range(P)]
            outs = [world.accls[r].create_buffer(N, np.float32)
                    for r in range(P)]
            for _ in range(3):
                world.run(lambda a, r: a.allreduce(
                    bufs[r], outs[r], N, from_fpga=True, to_fpga=True))
        spans = [s for s in col.spans() if s.name == "allreduce"]
    finally:
        obs_trace.disable()
        col.clear()
    assert len(spans) == 3 * P
    for s in spans:
        assert s.t_submit <= s.t_queue <= s.t_gang_ready <= s.t_dispatch
        assert s.t_dispatch <= s.t_device_begin < s.t_device_end
        assert s.t_device_end <= s.t_complete
        assert s.nbytes == N * 4 and s.lane in ("leader", "executor")


def test_tenant_link_matrix_on_card():
    """Two tenants on CudaWorld(4) on the card, the ring lane on both
    (threshold 0): each tenant's slice holds exactly its ring bytes,
    rank r to rank r + 1, bitwise results, and the two slices sum to the
    matrix over both tenants' communicators."""
    from accl_tpu_torch import CudaWorld
    from accl_tpu_torch.observability import telemetry as obs_tel

    P, calls = 4, {"train": ((1 << 20) + 4 * 7, 2), "serve": (4096, 3)}
    with CudaWorld(P) as world:
        world.engine.ring_threshold_bytes = 0
        g = torch.Generator(device="cuda").manual_seed(14)
        bufs = {t: ([world.accls[r].create_buffer(N, np.float32)
                     for r in range(P)],
                    [world.accls[r].create_buffer(N, np.float32)
                     for r in range(P)]) for t, (N, _k) in calls.items()}
        for sends, _outs in bufs.values():
            for b in sends:
                b.dev.copy_(torch.randn(b.length, generator=g,
                                        device="cuda"))

        def body(a, r):
            ids = {t: a.create_communicator(list(range(P)), tenant=t)
                   for t in calls}
            for t, (N, k) in calls.items():
                for _ in range(k):
                    a.allreduce(bufs[t][0][r], bufs[t][1][r], N,
                                comm_id=ids[t], from_fpga=True,
                                to_fpga=True)
            return ids

        ids = world.run(body)[0]
        torch.cuda.synchronize()
        for t, (sends, outs) in bufs.items():
            want = tring.ring_all_reduce_segmented(
                [b.dev for b in sends], "sum", plain=True)
            for r in range(P):
                assert torch.equal(outs[r].dev, want[r])
        slices = {t: world.link_matrix(tenant=t) for t in calls}
        both = obs_tel.link_matrix(world.link_stats(), nranks=P,
                                   comms=set(ids.values()))
    for t, (N, k) in calls.items():
        per_link = k * (N * 4 * 2 * (P - 1) // P)
        tx = slices[t]["fields"]["tx_bytes"]
        for r in range(P):
            for d in range(P):
                assert tx[r][d] == (per_link if d == (r + 1) % P else 0)
    for f, cells in both["fields"].items():
        assert cells == [[slices["train"]["fields"][f][r][d]
                          + slices["serve"]["fields"][f][r][d]
                          for d in range(P)] for r in range(P)], f


def test_device_overlap_over_stamp_rows_on_card(_devtrace):
    """The ring kernels' landed stamp rows of a sequential allreduce read
    as fully exposed; the fused lane's overlapped rows, as less."""
    from accl_tpu_torch import CudaWorld
    from accl_tpu_torch.observability import attribution as obs_attr
    from accl_tpu_torch.observability import trace as obs_trace

    P, N = 4, (1 << 20)
    col = _devtrace(True)
    obs_trace.enable()
    try:
        with CudaWorld(P) as world:
            world.engine.ring_threshold_bytes = 0
            bufs = [world.accls[r].create_buffer(N, np.float32)
                    for r in range(P)]
            for fused in (False, True):
                world.run(lambda a, r: a.allreduce(
                    bufs[r], bufs[r], N, from_fpga=True, to_fpga=True,
                    fused=fused))
            torch.cuda.synchronize()
        rep = obs_attr.device_overlap(col.to_perfetto())["collectives"]
    finally:
        obs_trace.disable()
    for coll in ("reduce_scatter", "all_gather"):
        assert rep[coll]["exposed_fraction"] == 1.0
        assert rep[coll]["ranks"] == P
    assert rep["fused_allreduce"]["exposed_fraction"] < 1.0


# ---------------------------------------------------------------------------
# persistent plans, batched dispatch and the sanitizer on the card
# ---------------------------------------------------------------------------
def _plan_case(world, kind, N, g):
    """Per-rank operand and result buffers of one collective (N elements
    per rank of operand), and its driver call."""
    P = world.nranks
    m = N // P
    out_len = {"allreduce": N, "allgather": N * P, "reduce_scatter": m,
               "small": N}[kind]
    sends = [world.accls[r].create_buffer(N, np.float32) for r in range(P)]
    outs = [world.accls[r].create_buffer(out_len, np.float32)
            for r in range(P)]
    eager = [world.accls[r].create_buffer(out_len, np.float32)
             for r in range(P)]

    def call(a, r, res):
        kw = {"from_fpga": True, "to_fpga": True}
        if kind in ("allreduce", "small"):
            a.allreduce(sends[r], res[r], N, **kw)
        elif kind == "allgather":
            a.allgather(sends[r], res[r], N, **kw)
        else:
            a.reduce_scatter(sends[r], res[r], m, **kw)

    def refill():
        for b in sends:
            b.dev.copy_(torch.randn(N, generator=g, device="cuda"))

    return sends, outs, eager, call, refill


@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter", "allgather",
                                  "small"])
def test_plan_replays_bitwise_with_the_eager_launches_on_card(kind):
    """A captured collective replayed on new operands: bitwise the eager
    call on the same operands and the plain composition, with the eager
    call's launches (one per ring phase; none below the threshold)."""
    from accl_tpu_torch import CudaWorld

    P = 8
    N = 64 * 1024 + 8 * 7 if kind != "small" else 1024
    g = torch.Generator(device="cuda").manual_seed(5)
    with CudaWorld(P) as world:
        if kind != "small":
            world.engine.ring_threshold_bytes = 0
        sends, outs, eager, call, refill = _plan_case(world, kind, N, g)
        refill()
        plans = world.run(lambda a, r: a.capture_plan(
            lambda a2: call(a2, r, outs)))
        expect = {"allreduce": (1, 1), "reduce_scatter": (1, 0),
                  "allgather": (0, 1), "small": (0, 0)}[kind]
        for _ in range(3):
            refill()
            before = (tring.ring_reduce_scatter.launches,
                      tring.ring_all_gather.launches)
            world.run(lambda a, r: plans[r].replay())
            assert (tring.ring_reduce_scatter.launches - before[0],
                    tring.ring_all_gather.launches - before[1]) == expect
            world.run(lambda a, r: call(a, r, eager))
            torch.cuda.synchronize()
            xs = [b.dev for b in sends]
            if kind in ("allreduce", "small"):
                want = (tring.ring_all_reduce_segmented(xs, "sum", plain=True)
                        if kind == "allreduce"
                        else [torch.stack(xs).sum(0)] * P)
            elif kind == "allgather":
                want = tring.ring_all_gather_segmented(xs, plain=True)
            else:
                want = tring.ring_reduce_scatter_segmented(xs, "sum",
                                                           plain=True)
            for r in range(P):
                assert torch.equal(outs[r].dev, eager[r].dev)
                assert torch.equal(outs[r].dev, want[r])
        stats = world.devices[0].engine_stats()
        assert stats["plans_live"] == 1 and stats["plan_replays"] == 3


def test_plan_rebuilds_copied_operands_on_card():
    """The widened fp16 operand and the short bcast root are copies: a
    replay reads them as they are then, as the eager calls do."""
    from accl_tpu_torch import CudaWorld

    P, N, root = 4, 4096, 1
    g = torch.Generator(device="cuda").manual_seed(6)
    with CudaWorld(P) as world:
        world.engine.ring_threshold_bytes = 0
        h = [world.accls[r].create_buffer(N, np.float16) for r in range(P)]
        res = [world.accls[r].create_buffer(N, np.float32) for r in range(P)]
        ref = [world.accls[r].create_buffer(N, np.float32) for r in range(P)]
        b = [world.accls[r].create_buffer(N // 2 if r == root else N,
                                          np.float32) for r in range(P)]

        def body(a, r, out):
            kw = {"from_fpga": True, "to_fpga": True}
            a.allreduce(h[r], out[r], N, **kw)
            a.bcast(b[r], N, root=root, **kw)

        def refill():
            for x in h:
                x.dev.copy_(torch.randn(N, generator=g, device="cuda"))
            b[root].dev.copy_(torch.randn(N // 2, generator=g, device="cuda"))

        refill()
        plans = world.run(lambda a, r: a.capture_plan(
            lambda a2: body(a2, r, res)))
        for _ in range(2):
            refill()
            world.run(lambda a, r: plans[r].replay())
            got = [x.dev.clone() for x in res]
            bc = [x.dev.clone() for x in b]
            world.run(lambda a, r: body(a, r, ref))
            torch.cuda.synchronize()
            for r in range(P):
                assert torch.equal(got[r], ref[r].dev)
                assert torch.equal(bc[r], b[r].dev)
            assert torch.equal(bc[0][:N // 2], b[root].dev)
            assert not bc[0][N // 2:].any()


def test_async_window_batches_bitwise_on_card():
    """A window of async allreduces queued behind a busy executor runs in
    batches; its results equal the same window under profile_sync (one
    gang at a time), bitwise."""
    from accl_tpu_torch import CudaWorld

    P, n, K = 8, 1024, 32
    g = torch.Generator(device="cuda").manual_seed(8)
    with CudaWorld(P) as world:
        src = [world.accls[r].create_buffer(n * K, np.float32)
               for r in range(P)]
        for x in src:
            x.dev.copy_(torch.randn(n * K, generator=g, device="cuda"))
        outs = {}
        for mode in ("batched", "single"):
            world.engine.profile_sync = mode == "single"
            dst = [world.accls[r].create_buffer(n * K, np.float32)
                   for r in range(P)]
            before = dict(world.engine.stats)
            with world.engine._ready_cv:
                world.engine._inline_busy = True
            try:
                reqs = world.run(lambda a, r: [a.allreduce(
                    src[r].slice(i * n, (i + 1) * n),
                    dst[r].slice(i * n, (i + 1) * n), n, from_fpga=True,
                    to_fpga=True, run_async=True) for i in range(K)])
            finally:
                with world.engine._ready_cv:
                    world.engine._inline_busy = False
                    world.engine._ready_cv.notify_all()
            for rs in reqs:
                for q in rs:
                    assert q.wait(60)
                    q.check()
            torch.cuda.synchronize()
            after = dict(world.engine.stats)
            outs[mode] = ([d.dev.clone() for d in dst],
                          after["batches"] - before["batches"])
        world.engine.profile_sync = False
    assert outs["batched"][1] > 0 and outs["single"][1] == 0
    for a, b in zip(outs["batched"][0], outs["single"][0]):
        assert torch.equal(a, b)


def test_sanitizer_mismatch_raises_on_every_rank_on_card():
    import time

    from accl_tpu_torch import ACCLError, CudaWorld
    from accl_tpu_torch.analysis import sanitizer

    sanitizer._reset_exchange()
    sanitizer.set_enabled(True)
    try:
        with CudaWorld(8) as world:
            def fn(a, r):
                s = a.create_buffer(1024, np.float32)
                d = a.create_buffer(1024, np.float32)
                with pytest.raises(ACCLError, match="call mismatch"):
                    a.allreduce(s, d, 512 if r == 0 else 1024,
                                from_fpga=True, to_fpga=True)
                return True

            t0 = time.perf_counter()
            assert all(world.run(fn, timeout=5))
            assert time.perf_counter() - t0 < 5
    finally:
        sanitizer.set_enabled(False)
        sanitizer._reset_exchange()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_ring_hop_is_bitwise_per_member_launches_on_card(dtype,
                                                                 causal):
    # one hop of the ring: the live members stacked along the batch axis
    # into one launch give each member's rows bit for bit as a launch for
    # that member alone (the packed kernels treat every (batch, head) row
    # on its own; the schedule depends on the lengths and head size only)
    import importlib

    RA = importlib.import_module("accl_tpu_torch.parallel.ring_attention")
    g = torch.Generator(device="cuda").manual_seed(13)
    members = [tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                     for shape in ((1, 1024, 8, 128), (1, 1024, 2, 128),
                                   (1, 1024, 2, 128)))
               for _ in range(3)]
    before = TFL.flash_fwd_resident.launches
    parts = RA._flash_hop(members, causal, dtype, None)
    assert TFL.flash_fwd_resident.launches == before + 1
    for (q, k, v), (out, lse) in zip(members, parts):
        o1, l1 = TFL.flash_attention_lse(q, k, v, causal=causal,
                                         mxu_dtype=dtype)
        assert torch.equal(out, o1) and torch.equal(lse, l1)


@pytest.mark.parametrize("schedule,window,causal", [
    ("contiguous", None, False), ("contiguous", None, True),
    ("zigzag", None, True), ("contiguous", 700, True)])
def test_ring_attention_on_card_matches_plain_and_trains(schedule, window,
                                                         causal):
    # the flash ring on the card (stacked hops, lse merges, the backward
    # kernels fed the merges' live lse cotangent) against the same ring on
    # the CPU through the kernels' plain versions: out and gradients
    from accl_tpu_torch.parallel import ring_attention

    P, Tl, H, G, D = 4, 1024, 8, 2, 128
    g = torch.Generator().manual_seed(17)
    base = [torch.randn((1, P * Tl, h, D), generator=g) for h in (H, G, G)]
    kw = dict(causal=causal, impl="flash", schedule=schedule, window=window)

    def run(dev):
        ts = [t.to(dev).requires_grad_(True) for t in base]
        out = ring_attention(*(list(t.chunk(P, dim=1)) for t in ts), **kw)
        loss = sum((o.double() ** 2).sum() for o in out)
        return (torch.cat(out, dim=1).detach().cpu(),
                [d.cpu() for d in torch.autograd.grad(loss, ts)])

    out, grads = run("cuda")
    want, wgrads = run("cpu")
    assert float((out - want).abs().max()) <= 1e-5
    for a, b in zip(grads, wgrads):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


def test_moe_fused_lane_on_card():
    # the fused lane's routing is dispatch -> FFN -> combine bit for bit
    # with an expert that computes each row alone; with the expert's
    # matmuls the model's fused forward is within the fp32 bound of the
    # unfused one (cuBLAS picks its kernel, and so its order of summation,
    # by the row count: a chunk's P ck rows against the capacity's P cap),
    # a bound the same forward must fail with the last block's expert banks
    # rounded to bf16 (the routers see what they saw: only the products'
    # precision moves the logits)
    from accl_tpu_torch.models import moe as TM
    from accl_tpu_torch.parallel import expert_combine, expert_dispatch

    g = torch.Generator(device="cuda").manual_seed(7)
    P, N, D = 8, 512, 256
    xs = [torch.randn((N, D), generator=g, device="cuda") for _ in range(P)]
    idxs = [torch.randint(0, P, (N,), generator=g, device="cuda")
            for _ in range(P)]
    ffns = [lambda t, r=r: torch.nn.functional.gelu(t) * (r + 1)
            for r in range(P)]
    for cap, chunks in ((80, 4), (64, 2), (0, 3)):
        got = TF.fused_expert_ffn(xs, idxs, ffns, capacity=cap,
                                  chunks=chunks)
        inp, info = expert_dispatch(xs, idxs, capacity=cap)
        want = expert_combine([f(t) for f, t in zip(ffns, inp)], info)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    cfg = TM.MoEConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                       d_head=64, d_ff=1024, n_experts=8)
    params = TM.init_params(np.random.default_rng(5), cfg, ep=8)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (8, 256))).cuda()
    a, _ = TM.forward(params, tokens, cfg, ep=8)
    b, _ = TM.forward(params, tokens, cfg, ep=8, fused=True)
    bound = 4e-5
    assert float((a - b).abs().max()) <= bound
    *rest, last = params["blocks"]
    rounded = {**params, "blocks": rest + [
        {**last, **{w: [x.bfloat16().float() for x in last[w]]
                    for w in ("we1", "we2")}}]}
    c, _ = TM.forward(rounded, tokens, cfg, ep=8, fused=True)
    assert float((a - c).abs().max()) > bound


# ---------------------------------------------------------------------------
# the ring kernels' self-ring mode, CUDA graphs, the AdamW step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(tring.KERNEL_DTYPES))
@pytest.mark.parametrize("V", [2, 3, 8])
@pytest.mark.parametrize("n", [1, 4099, 4096 * 128])
def test_selfring_kernels_match_plain_on_card(dtype, V, n):
    """ring_kernel with one rank and a ring of V hops: the reduce-scatter
    (sum and max), all-gather and allreduce bitwise their plain
    versions, each one launch counted in ``launches_self``."""
    g = torch.Generator(device="cuda").manual_seed(31)
    x = (torch.randn(V, n, generator=g, device="cuda") * 100).to(dtype)
    before = (tring.ring_reduce_scatter.launches_self,
              tring.ring_all_gather.launches_self)
    for op in ("sum", "max"):
        (got,) = tring.ring_reduce_scatter([x], op, ring_size=V)
        (want,) = tring.ring_reduce_scatter_plain([x], op, ring_size=V)
        assert _same_bits(got, want), op
    (ag,) = tring.ring_all_gather([x[0].contiguous()], ring_size=V)
    assert _same_bits(ag, x[0].expand(V, n))
    flat = x.reshape(-1)
    (ar,) = tring.ring_all_reduce([flat], ring_size=V)
    (ar_plain,) = tring.ring_all_reduce([flat], plain=True, ring_size=V)
    assert _same_bits(ar, ar_plain)
    torch.cuda.synchronize()
    assert (tring.ring_reduce_scatter.launches_self - before[0],
            tring.ring_all_gather.launches_self - before[1]) == (3, 2)


def test_selfring_stamp_rows_match_the_schedule_on_card(_devtrace):
    """The self-ring allreduce's stamp rows: one record per launch, V - 1
    rows with rank and both peers 0 (``stamp_rows(1, bytes, V)``, the
    rows the CPU path records and tests/test_torch_selfring.py holds to
    the JAX package's)."""
    V, n = 8, 4099
    g = torch.Generator(device="cuda").manual_seed(32)
    x = torch.randn(V * n, generator=g, device="cuda")
    col = _devtrace(True)
    tring.ring_all_reduce([x], ring_size=V)
    rows = tuple(map(tuple, tring.stamp_rows(1, n * 4, V)[0].tolist()))
    assert _trace_records(col) == {("reduce_scatter", rows): 1,
                                   ("all_gather", rows): 1}


def test_ring_capture_with_device_trace_raises_on_card(_devtrace):
    """A stamp launch synchronizes to land its rows, which a capture
    cannot hold: the wrapper raises instead of skipping the rows."""
    xs = [torch.randn(4096, device="cuda") for _ in range(8)]
    tring.ring_all_gather(xs)  # scratch allocated outside the capture
    _devtrace(True)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="ACCL_DEVICE_TRACE"):
        with torch.cuda.graph(graph):
            tring.ring_all_gather(xs)


def _capture(fn):
    """Warm ``fn`` up on a side stream, then capture it there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return graph, out


def test_hand_kernels_replay_in_a_cuda_graph_on_card():
    """fused_matmul_allreduce_pallas (the fused matmul reduce-scatter
    kernel, then the ring all-gather kernel) and a self-ring allreduce,
    captured after a warm-up and replayed on new operands: every replay
    bitwise the eager launches on the same operands; the wrappers count
    only the captured launches."""
    P, M, K, N, V = 8, 8, 224, 512, 8
    g = torch.Generator(device="cuda").manual_seed(33)
    xs = [torch.randn(M, K, generator=g, device="cuda") for _ in range(P)]
    ws = [torch.randn(K, N, generator=g, device="cuda") for _ in range(P)]
    sr = torch.randn(V * 4096, generator=g, device="cuda")

    def fn():
        return (TF.fused_matmul_allreduce_pallas(xs, ws)[0],
                tring.ring_all_reduce([sr], ring_size=V)[0])

    graph, out = _capture(fn)
    counts = (TF.fused_matmul_reduce_scatter.launches,
              tring.ring_all_gather.launches,
              tring.ring_reduce_scatter.launches)
    for _ in range(3):
        for t in xs + ws + [sr]:
            t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        got = [o.clone() for o in out]
        want = fn()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (TF.fused_matmul_reduce_scatter.launches,
            tring.ring_all_gather.launches,
            tring.ring_reduce_scatter.launches) == (
        counts[0] + 3, counts[1] + 6, counts[2] + 3)


def test_captured_scratch_outlives_a_recycled_stream_on_card():
    """A captured graph's ring and fused kernels keep scratch of their
    own.  After the capture (whose side stream is dropped), larger eager
    launches on every stream of the pool, the capture's handle among
    them, replace and free the wrappers' cached scratch, and new tensors
    full of -1 take the freed memory; the replays stay bitwise the eager
    launches on the same operands."""
    P, M, K, N, V = 8, 8, 224, 512, 8
    g = torch.Generator(device="cuda").manual_seed(34)
    xs = [torch.randn(M, K, generator=g, device="cuda") for _ in range(P)]
    ws = [torch.randn(K, N, generator=g, device="cuda") for _ in range(P)]
    sr = torch.randn(V * 4096, generator=g, device="cuda")

    def fn():
        return (TF.fused_matmul_allreduce_pallas(xs, ws)[0],
                tring.ring_all_reduce([sr], ring_size=V)[0])

    graph, out = _capture(fn)
    big = [torch.randn(1 << 22, generator=g, device="cuda")
           for _ in range(P)]
    big_xs = [torch.randn(P, 64, K, generator=g, device="cuda")
              for _ in range(P)]
    for _ in range(80):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            tring.ring_all_gather(big)
            TF.fused_matmul_reduce_scatter(big_xs, ws)
        s.synchronize()
    junk = [torch.full((1 << k,), -1, dtype=torch.int32, device="cuda")
            for k in range(7, 24) for _ in range(4)]
    for _ in range(3):
        for t in xs + ws + [sr]:
            t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        got = [o.clone() for o in out]
        want = fn()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(bool((j == -1).all()) for j in junk)


GRAPH_CFG = dict(vocab=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_head=32, d_ff=128, mlp="swiglu", rope=True)


@pytest.mark.parametrize("fused", [False, True])
def test_generate_graph_matches_the_eager_loop_on_card(fused):
    """generate as one captured decode step replayed, against the eager
    loop: greedy tokens equal, and teacher-forced replayed logits bitwise
    the eager decode_step's."""
    from accl_tpu_torch.models import decode as TD

    cfg = TT.ModelConfig(**GRAPH_CFG)
    params = TT.init_params(np.random.default_rng(5), cfg, tp=2)
    params = {**params, "embed": params["embed"] * 40}
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, size=(2, 12))).cuda()
    eager = TD.generate(params, prompt, cfg, 8, fused=fused, graph=False)
    graphed = TD.generate(params, prompt, cfg, 8, fused=fused)
    assert torch.equal(graphed, eager)
    cont = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, size=(2, 6))).cuda()
    logits = {}
    for mode in ("eager", "graph"):
        cache = TD.init_kv_cache(cfg, 2, 18, tp=2)
        _, cache = TD.prefill(params, prompt, cache, cfg, fused=fused)
        out = []
        if mode == "eager":
            for t in range(6):
                lg, cache = TD.decode_step(params, cont[:, t], cache, cfg,
                                           fused=fused)
                out.append(lg)
        else:
            stepper = TD.DecodeGraph(params, cache, cfg, cont[:, 0],
                                     fused=fused).capture()
            for t in range(6):
                stepper.token.copy_(cont[:, t])
                out.append(stepper.replay().clone())
            assert stepper.replays == 6
            assert int(stepper.cache["pos"]) == 18
        logits[mode] = torch.stack(out)
    assert torch.equal(logits["graph"], logits["eager"])


def test_generate_graph_under_device_trace_on_card(_devtrace):
    """generate captures its decode step with ACCL_DEVICE_TRACE set: the
    step launches no ring kernel (the model's lanes multiply with
    torch.matmul), so nothing in it stamps; tokens equal the eager
    loop's, unfused and fused."""
    from accl_tpu_torch.models import decode as TD

    cfg = TT.ModelConfig(**GRAPH_CFG)
    params = TT.init_params(np.random.default_rng(5), cfg, tp=2)
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, size=(2, 12))).cuda()
    _devtrace(True)
    for fused in (False, True):
        graphed = TD.generate(params, prompt, cfg, 6, fused=fused)
        eager = TD.generate(params, prompt, cfg, 6, fused=fused, graph=False)
        assert torch.equal(graphed, eager)


def test_adamw_train_step_on_card_matches_cpu():
    """Two AdamW steps (dp 2 x tp 2, flash) on the card against the CPU:
    loss within rtol 1e-5, parameters within rtol 1e-4 / atol 1e-5 (an
    AdamW update is about lr a parameter whatever its gradient, so the
    bound is set by lr 1e-3), moments within rtol 1e-3 / atol 1e-9."""
    from accl_tpu_torch import optim
    from accl_tpu_torch.parallel import make_mesh

    cfg = TT.ModelConfig(**GRAPH_CFG, attn="flash")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 96))
    results = []
    for dev in ("cpu", "cuda"):
        params = TT.init_params(np.random.default_rng(5), cfg, tp=2,
                                device=dev)
        step, (_s, st_specs, _t), init_opt = TT.make_train_step(
            make_mesh(dp=2, tp=2, device=dev), cfg,
            optimizer=optim.adamw(1e-3), params=params)
        state = init_opt(params)
        losses = []
        for _ in range(2):
            params, state, loss = step(params, state,
                                       torch.from_numpy(tokens))
            losses.append(float(loss))
        assert losses[1] < losses[0]
        results.append((params, state, losses))
    (cp, cs, cl), (gp, gs, gl) = results
    assert abs(gl[0] - cl[0]) <= 1e-5 * abs(cl[0])
    assert int(gs.count) == int(cs.count) == 2
    for a, b in zip(TT.tree_leaves(gp), TT.tree_leaves(cp)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    for a, b in zip(TT.tree_leaves(gs.mu) + TT.tree_leaves(gs.nu),
                    TT.tree_leaves(cs.mu) + TT.tree_leaves(cs.nu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-9)


def test_sampled_generate_graph_on_card():
    """Sampling in the replayed graph: the generator is registered with
    the graph, so a seeded run repeats, and it draws as the eager loop
    does from the same seed."""
    from accl_tpu_torch.models import decode as TD

    cfg = TT.ModelConfig(**GRAPH_CFG)
    params = TT.init_params(np.random.default_rng(5), cfg, tp=2)
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, size=(2, 12))).cuda()

    def sample(graph):
        g = torch.Generator(device="cuda").manual_seed(17)
        return TD.generate(params, prompt, cfg, 8, temperature=0.8,
                           top_k=10, generator=g, graph=graph)

    a, b = sample(None), sample(None)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    assert torch.equal(a, sample(False))


# ---------------------------------------------------------------------------
# resilience on the card: the ring lane on communicators recovery mints,
# and the native emulator against the card's world
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W", [7, 8])
def test_abort_grow_then_ring_lane_on_card(W):
    """CudaWorld(W) on the card: ranks 0..W-2 run a ragged ring allreduce
    on their comm (P = W - 1), bitwise the plain composition, and capture
    it; rank 0 aborts the comm, every replay raises and the kernels
    launch nothing; rank W-1 joins and the survivors grow the comm to
    P = W, whose ring allreduce launches both kernels once, bitwise."""
    from accl_tpu_torch import ACCLError, CudaWorld
    from accl_tpu_torch.communicator import Communicator, Rank
    from accl_tpu_torch.constants import ErrorCode

    N = 3 * (1 << 18) + 5  # several segments and a ragged tail
    members = list(range(W - 1))
    row = Rank(ip="127.0.0.1", port=0, session=W - 1)

    def counts():
        return (tring.ring_reduce_scatter.launches,
                tring.ring_all_gather.launches)

    with CudaWorld(W) as world:
        world.engine.ring_threshold_bytes = 0
        g = torch.Generator(device="cuda").manual_seed(W)
        send = [world.accls[r].create_buffer(N, np.float32) for r in range(W)]
        recv = [world.accls[r].create_buffer(N, np.float32) for r in range(W)]
        for b in send:
            b.dev.copy_(torch.randn(N, generator=g, device="cuda"))
        xs = [b.dev.clone() for b in send]

        def call(a, r, comm):
            a.allreduce(send[r], recv[r], N, comm_id=comm, from_fpga=True,
                        to_fpga=True)

        def ring_of_members(a, r):
            if r not in members:
                return None
            assert a.create_communicator(members) == 1
            call(a, r, 1)
            return a.capture_plan(lambda a2: call(a2, r, 1), timeout_s=30)

        plans = world.run(ring_of_members, timeout=30)
        torch.cuda.synchronize()
        want = tring.ring_all_reduce_segmented(xs[:W - 1], "sum", plain=True)
        for r in members:
            assert torch.equal(recv[r].dev, want[r])
        world.accls[0].abort(1, error=int(ErrorCode.RANK_FAILED))
        before = counts()
        for r in members:
            with pytest.raises(ACCLError):
                plans[r].replay()
        assert counts() == before

        def join(a, r):
            if r == W - 1:
                assert a.device.join_sync(0) == 0
                a._pad_communicators(a.device.comm_count())

        def grow(a, r):
            if r in members:
                gid = a.grow_communicator([row], comm_id=1, window_s=0.1)
            else:
                rows = [Rank(ip="127.0.0.1", port=0, session=i)
                        for i in members] + [row]
                gid = a._install_communicator(
                    Communicator(rows, W - 1, comm_id=2))
            call(a, r, gid)
            return gid

        world.run(join, timeout=30)
        before = counts()
        assert world.run(grow, timeout=30) == [2] * W
        torch.cuda.synchronize()
        assert (counts()[0] - before[0], counts()[1] - before[1]) == (1, 1)
        want = tring.ring_all_reduce_segmented(xs, "sum", plain=True)
        for r in range(W):
            assert torch.equal(recv[r].dev, want[r])


def test_emu_world_matches_cuda_world_on_card():
    """EmuWorld(4) on the native engine against CudaWorld(4) on the card
    at 8 MiB per rank (the ring lane): int32 bitwise; fp32 folds in
    another order, each within (P - 1) 2^-24 sum|x| of float64."""
    from accl_tpu_torch import CudaWorld, ReduceFunction
    from accl_tpu_torch.backends.emu import EmuWorld

    P, n = 4, (8 << 20) // 4
    rng = np.random.default_rng(3)
    ints = [rng.integers(-1 << 20, 1 << 20, n, dtype=np.int32)
            for _ in range(P)]
    flts = [rng.standard_normal(n).astype(np.float32) for _ in range(P)]

    def prog(data):
        def fn(a, r):
            s = a.create_buffer_like(data[r])
            o = a.create_buffer(n, data[r].dtype)
            a.allreduce(s, o, n, ReduceFunction.SUM)
            return o.host.copy()
        return fn

    with EmuWorld(P, devmem_bytes=128 << 20,
                  max_rendezvous_size=64 << 20) as ew:
        emu_i, emu_f = ew.run(prog(ints), timeout=30), ew.run(prog(flts),
                                                             timeout=30)
    with CudaWorld(P) as cw:
        before = tring.ring_reduce_scatter.launches
        card_i, card_f = cw.run(prog(ints), timeout=30), cw.run(prog(flts),
                                                              timeout=30)
        assert tring.ring_reduce_scatter.launches - before == 2
    ref = np.sum([x.astype(np.float64) for x in flts], axis=0)
    bound = (P - 1) * 2.0 ** -24 * np.sum(
        [np.abs(x.astype(np.float64)) for x in flts], axis=0)
    for r in range(P):
        np.testing.assert_array_equal(emu_i[r], card_i[r])
        assert (np.abs(emu_f[r] - ref) <= bound).all()
        assert (np.abs(card_f[r] - ref) <= bound).all()


def _stream_allreduce(a, r, data, n, before_call=None, pull_on=None):
    """Rank r's stream->stream allreduce by the device API: push, call,
    pull (stream 9).  ``before_call`` runs between the push and the call;
    ``pull_on`` is the stream the pull runs on."""
    import contextlib

    from accl_tpu_torch import Operation, StreamFlags
    from accl_tpu_torch.constants import DataType
    from accl_tpu_torch.device_api import ACCLCommand, ACCLData

    f32 = a._arith_ids[(DataType.float32, DataType.float32)]
    d = ACCLData(a.device)
    d.push(data[r])
    if before_call is not None:
        before_call()
    cmd = ACCLCommand(a.device, arithcfg=f32)
    cmd.start_call(Operation.allreduce, n, function=0, tag=9,
                   stream_flags=StreamFlags.OP0_STREAM
                   | StreamFlags.RES_STREAM)
    cmd.finalize_call()
    with (torch.cuda.stream(pull_on) if pull_on is not None
          else contextlib.nullcontext()):
        return d.pull(n, np.float32, 9, timeout=60)


def test_stream_allreduce_64mib_is_the_buffer_ring_on_card():
    """CudaWorld(8) at 64 MiB fp32 per rank: the stream-sourced allreduce
    (ACCLData.push, ACCLCommand.start_call with OP0_STREAM | RES_STREAM,
    pull) launches both ring kernels once and is bitwise the
    buffer-sourced allreduce of the same data."""
    from accl_tpu_torch import CudaWorld, ReduceFunction

    P, n = 8, (64 << 20) // 4
    rng = np.random.default_rng(17)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(P)]

    def buffered(a, r):
        s = a.create_buffer_like(data[r])
        o = a.create_buffer(n, np.float32)
        a.allreduce(s, o, n, ReduceFunction.SUM)
        return o.host.copy()

    with CudaWorld(P) as world:
        want = world.run(buffered, timeout=120)
        before = (tring.ring_reduce_scatter.launches,
                  tring.ring_all_gather.launches)
        got = world.run(lambda a, r: _stream_allreduce(a, r, data, n),
                        timeout=120)
        assert (tring.ring_reduce_scatter.launches - before[0],
                tring.ring_all_gather.launches - before[1]) == (1, 1)
    for r in range(P):
        assert got[r].tobytes() == want[r].tobytes()


def test_pop_stream_waits_for_the_ring_on_card():
    """The join of the stream paths: after every rank pushed its operand,
    the card's default stream is held busy, so the ring kernels of the
    stream allreduce start late; each rank pulls its result at once on a
    side stream, which does not wait for the default one.  pop_stream
    synchronizes the delivery's event first, so the bytes are the
    finished result, not what the memory held before the kernels ran."""
    import threading

    from accl_tpu_torch import CudaWorld, ReduceFunction

    P, n = 8, (16 << 20) // 4
    rng = np.random.default_rng(18)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(P)]
    side = torch.cuda.Stream()
    pushed = threading.Barrier(P, timeout=60)

    def buffered(a, r):
        s = a.create_buffer_like(data[r])
        o = a.create_buffer(n, np.float32)
        a.allreduce(s, o, n, ReduceFunction.SUM)
        return o.host.copy()

    def hold():
        if pushed.wait() == 0:
            torch.cuda._sleep(500_000_000)  # ~0.3 s at the card's clock
        pushed.wait()

    with CudaWorld(P) as world:
        want = world.run(buffered, timeout=120)
        got = world.run(lambda a, r: _stream_allreduce(
            a, r, data, n, before_call=hold, pull_on=side), timeout=120)
    for r in range(P):
        assert got[r].tobytes() == want[r].tobytes()


def test_stream_call_under_graph_capture_raises_on_card():
    """A stream call under CUDA graph capture raises (plans refuse stream
    traffic); nothing is popped from the operand queue."""
    from accl_tpu_torch import ACCLError, CudaWorld

    with CudaWorld(1) as world:
        a = world.accls[0]
        src = a.create_buffer_like(np.arange(64, dtype=np.float32))
        dst = a.create_buffer(64, np.float32)
        a.device.push_krnl(np.ones(64, np.float32))
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with pytest.raises(ACCLError, match="graph capture"):
            with torch.cuda.graph(g):
                a.copy_to_stream(src, 64, stream_id=9, from_fpga=True)
        a.copy_from_stream(dst, 64)
        np.testing.assert_array_equal(dst.host, np.ones(64, np.float32))


def test_online_episode_with_the_ring_lane_on_card(monkeypatch):
    """One online-tuner episode on CudaWorld(8) at a 1 MiB allreduce
    cell (below the static ring threshold, so the ring lane is a
    challenger): the shortlist holds the ring lane, the episode closes
    with a measured decision, and the ring kernels launched."""
    from accl_tpu_torch import CudaWorld
    from accl_tpu_torch.observability import metrics as OM
    from accl_tpu_torch.tuning.online import DECISIONS, OnlineTuner

    monkeypatch.setenv("ACCL_FABRIC", "8")
    before = tring.ring_reduce_scatter.launches
    with CudaWorld(8) as w:
        tuner = OnlineTuner(w, registry=OM.MetricsRegistry(),
                            repetitions=2)
        tuner.on_findings([{
            "collective": "allreduce", "dtype": "float32",
            "size_bucket": "<=1MiB", "axis": "p50_us", "ratio": 2.0,
            "kind": "latency", "live": 2.0, "baseline": 1.0}])
        ep = tuner.step()
    assert ep["decision"] in DECISIONS and ep["decision"] != "error", ep
    lanes = [c["algorithm"] for c in ep["hypothesis"]["shortlist"]]
    assert "ring" in lanes and "hierarchical" not in lanes, lanes
    assert tring.ring_reduce_scatter.launches > before


def test_traced_window_trace_holds_ring_kernels_on_card(tmp_path):
    """traced_window(xla_logdir=) captures the card's kernels: a segmented
    allreduce's two ring launches are device events of the trace."""
    import json

    from accl_tpu_torch.observability.trace import traced_window

    g = torch.Generator(device="cuda").manual_seed(3)
    xs = [torch.randn(8 * 4096, generator=g, device="cuda")
          for _ in range(8)]
    with traced_window("ring", xla_logdir=str(tmp_path)):
        tring.ring_all_reduce_segmented(xs, "sum")
        torch.cuda.synchronize()
    (path,) = tmp_path.glob("*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"
              and "ring_kernel" in e.get("name", "")]
    assert len(events) >= 2


# ---------------------------------------------------------------------------
# ranks on several cards: the ring kernels' cross-card mode, its
# per-rank-table form on one card, and CudaWorld(devices=)
# ---------------------------------------------------------------------------
def _two_cards_or_skip() -> int:
    """The card count, or a skip below two (decided in the test, never at
    import: every worker must collect the same tests)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    return cards


def _operands(P, N, dtype, op, seed, devices):
    g = torch.Generator().manual_seed(seed)
    xs = []
    for r in range(P):
        x = (torch.randn(N, generator=g) * 1000).to(dtype)
        if op == "max" and dtype.is_floating_point:
            x[r::97] = float("nan")
        xs.append(x.to(devices[r]))
    return xs


def _cross_launches():
    return (tring.ring_reduce_scatter.launches_cross,
            tring.ring_all_gather.launches_cross)


@pytest.mark.parametrize("dtype", list(tring.KERNEL_DTYPES))
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("N,seg", [(8 * 3 * 4096, 8 * 4096),
                                   (3 * 8 * 4099 + 13, 8 * 4099),
                                   (8 * 37 + 5, 16), (5, 1 << 18)])
def test_rank_tables_form_matches_one_launch_on_card(dtype, op, N, seg):
    """The cross-card mode's per-rank-table form, with every rank on one
    card (one launch, .sys flags, the entry handshake), bitwise against
    the one-launch form and the plain composition, three calls back to
    back on the same tables (the handshake's count grows)."""
    P = 8
    xs = _operands(P, N, dtype, op, 12, ["cuda"] * P)
    want = tring.ring_all_reduce_segmented(xs, op, seg, plain=True)
    one = tring.ring_all_reduce_segmented(xs, op, seg)
    before = _cross_launches()
    with tring.rank_tables():
        got = [tring.ring_all_reduce_segmented(xs, op, seg)
               for _ in range(3)]
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_cross_launches(), before)) == (3, 3)
    for r in range(P):
        assert _same_bits(one[r], want[r])
        for call in got:
            assert _same_bits(call[r], want[r])


@pytest.mark.parametrize("dtype", list(tring.KERNEL_DTYPES))
@pytest.mark.parametrize("n", [1, 4099, 3 * 32768 + 7])
def test_rank_tables_one_segment_matches_plain_on_card(dtype, n):
    """Both kernels of the per-rank-table form on one segment, with
    strided operand and result rows, bitwise against the plain versions
    and the one-launch form."""
    P = 4
    g = torch.Generator(device="cuda").manual_seed(13)
    xs = [(torch.randn(P, n + 3, generator=g, device="cuda") * 1000)
          .to(dtype)[:, :n] for _ in range(P)]
    with tring.rank_tables():
        got = tring.ring_reduce_scatter(xs, "sum")
        outs = [torch.zeros(P, n + 5, dtype=dtype, device="cuda")[:, :n]
                for _ in range(P)]
        gathered = tring.ring_all_gather(got, out=outs)
    one = tring.ring_reduce_scatter(xs, "sum")
    torch.cuda.synchronize()
    for a, b, c in zip(got, tring.ring_reduce_scatter_plain(xs, "sum"), one):
        assert _same_bits(a, b) and _same_bits(a, c)
    for a, b in zip(gathered, tring.ring_all_gather_plain(got)):
        assert _same_bits(a, b)


def test_cross_card_instantiations_stay_two_blocks_an_sm_on_card():
    """Every instantiation of the cross-card mode (plain and device-trace,
    five dtypes, three kinds) keeps two blocks per SM, the co-residency
    the stripe count assumes.  At the 128-register cap of two blocks an
    SM it spills some bytes to local memory (PERF.md rows 1m-2m); the
    one-launch instantiations of fp32 spill none (the stamp test)."""
    for dtype in tring.KERNEL_DTYPES:
        for kind in (0, 1, 2):
            for variant in (2, 3):
                info = tring.kernel_info(kind, dtype, variant)
                assert info["blocks_per_sm"] >= 2, (dtype, kind, variant,
                                                    info)


def _layouts():
    cards = _two_cards_or_skip()
    one_a_card = [f"cuda:{c}" for c in range(cards)]
    two_a_card = [f"cuda:{c}" for c in range(cards) for _ in range(2)]
    interleaved = [f"cuda:{r % cards}" for r in range(2 * cards)]
    return {"one_a_card": one_a_card, "two_a_card": two_a_card,
            "interleaved": interleaved}


@pytest.mark.parametrize("layout", ["one_a_card", "two_a_card",
                                    "interleaved"])
@pytest.mark.parametrize("dtype", list(tring.KERNEL_DTYPES))
@pytest.mark.parametrize("op", ["sum", "max"])
def test_cross_card_ring_matches_plain_on_cards(layout, dtype, op):
    """The cross-card mode over every card (one rank a card, two, and
    ranks dealt round the cards), ragged, NaN under MAX: one launch per
    card and phase, each rank's result on its own card, bitwise the
    plain composition's and the one-card launch's; ten calls back to
    back on the same tables."""
    devices = _layouts()[layout]
    P = len(devices)
    N = 3 * P * 4099 + 13
    xs = _operands(P, N, dtype, op, 14, devices)
    want = tring.ring_all_reduce_segmented(xs, op, 8 * 4099, plain=True)
    one = tring.ring_all_reduce_segmented([x.to("cuda:0") for x in xs], op,
                                          8 * 4099)
    before = _cross_launches()
    for _ in range(10):
        got = tring.ring_all_reduce_segmented(xs, op, 8 * 4099)
    torch.cuda.synchronize()
    cards = len(set(devices))
    assert tuple(a - b for a, b in zip(_cross_launches(), before)) \
        == (10 * cards, 10 * cards)
    for r in range(P):
        assert got[r].device == torch.device(devices[r])
        assert _same_bits(got[r], want[r])
        assert _same_bits(got[r].cpu(), one[r].cpu())
    # each rank's slots and flags on its own card, the one that reads them
    layout = tuple(torch.device(d).index for d in devices)
    tables = [t for key, t in tring._tables.items() if key[0] == layout]
    assert tables
    for tabs in tables:
        assert [t.device.index for t in tabs.slots] == list(layout)
        assert [t.device.index for t in tabs.flags] == list(layout)


def test_cross_card_launch_given_up_ends_at_once_on_card(monkeypatch):
    """A cross-card launch whose second launch fails after the first was
    enqueued: the first's blocks wait for the host's gate, which gives the
    launch up, so they end at once (no trap after SPIN_TIMEOUT_NS, the
    card stays usable) and the next launch, on fresh tables, is bitwise
    its plain version.  Played on one card: the per-rank-table form of two
    ranks, split into one launch a rank."""
    from accl_tpu_torch.ops import _build

    P, n = 2, 3 * 4099
    g = torch.Generator(device="cuda").manual_seed(16)
    xs = [torch.randn(P, n, generator=g, device="cuda") for _ in range(P)]
    lib = _build.load("ring")
    real, calls = lib.accl_ring_launch_cross, []

    def launch(*args):
        calls.append(args)
        return real(*args) if len(calls) == 1 else 1  # cudaErrorInvalidValue

    tring._plan.cache_clear()
    monkeypatch.setattr(tring, "card_groups",
                        lambda layout: [(c, [r]) for r, c in enumerate(layout)])
    monkeypatch.setattr(lib, "accl_ring_launch_cross", launch)
    try:
        with tring.rank_tables(), pytest.raises(RuntimeError,
                                                match="CUDA error 1"):
            tring.ring_reduce_scatter(xs, "sum")
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        assert time.perf_counter() - t0 < 2.0
        assert len(calls) == 2
    finally:
        monkeypatch.undo()
        tring._plan.cache_clear()
    with tring.rank_tables():
        got = tring.ring_reduce_scatter(xs, "sum")
    torch.cuda.synchronize()
    for a, b in zip(got, tring.ring_reduce_scatter_plain(xs, "sum")):
        assert _same_bits(a, b)


def _busy_for(seconds: float, device: int) -> None:
    """Queue one kernel that spins for about ``seconds`` on ``device``'s
    current stream (``torch.cuda._sleep``, scaled from a short one)."""
    with torch.cuda.device(device):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        torch.cuda._sleep(10 ** 8)
        end.record()
        end.synchronize()
        torch.cuda._sleep(int(10 ** 8 * seconds * 1e3
                              / start.elapsed_time(end)))


def test_cross_card_launch_waits_for_a_busy_card_on_cards():
    """A cross-card allreduce whose last card's stream still holds a
    kernel that runs past SPIN_TIMEOUT_NS (10 s) when the call is made:
    the cards' streams are joined before the launches, so no card's
    blocks start before that kernel ends, and the call is bitwise its
    plain version instead of a trap on the other cards."""
    cards = _two_cards_or_skip()
    devices = [f"cuda:{c}" for c in range(cards)]
    P = len(devices)
    xs = _operands(P, 3 * P * 4099 + 13, torch.float32, "sum", 17, devices)
    want = tring.ring_all_reduce_segmented(xs, "sum", 8 * 4099, plain=True)
    # the tables exist before the busy kernel (making them synchronizes)
    tring.ring_all_reduce_segmented(xs, "sum", 8 * 4099)
    for c in range(cards):
        torch.cuda.synchronize(c)
    _busy_for(12.0, cards - 1)
    t0 = time.perf_counter()
    got = tring.ring_all_reduce_segmented(xs, "sum", 8 * 4099)
    for c in range(cards):
        torch.cuda.synchronize(c)
    assert time.perf_counter() - t0 > 10.0  # the busy kernel was waited for
    for r in range(P):
        assert _same_bits(got[r], want[r])


@pytest.mark.parametrize("layout", ["one_a_card", "two_a_card"])
def test_cross_card_world_lanes_match_one_card_on_cards(layout):
    """CudaWorld(P, devices=) over every card: each lane's results, on
    each rank's own card, bitwise those of CudaWorld(P) on one card."""
    from accl_tpu_torch import CudaWorld, DataType

    devices = _layouts()[layout]
    P, N = len(devices), 4096

    def lanes(accl, rank):
        rng = np.random.default_rng(100 + rank)
        x = accl.create_buffer(N * P, np.float32)
        x.host[:] = rng.standard_normal(N * P).astype(np.float32)
        x.sync_to_device()
        y = accl.create_buffer(N * P, np.float32)
        out = {}
        for name, kw in (("small", {}), ("fused", {"fused": True}),
                         ("int8", {"compress_dtype": DataType.int8})):
            accl.allreduce(x, y, N * P, **kw)
            out[name] = y.host.copy()
        accl.reduce_scatter(x, y, N)
        out["rs"] = y.host[:N].copy()
        accl.alltoall(x, y, N)
        out["a2a"] = y.host.copy()
        accl.bcast(x, N, root=1)
        out["bcast"] = x.host[:N].copy()
        accl.send(x, N, (rank + 1) % P, tag=5)
        accl.recv(y, N, (rank - 1) % P, tag=5)
        out["p2p"] = y.host[:N].copy()
        return out

    results = {}
    for name, kw in (("one", {}), ("cards", {"devices": devices})):
        with CudaWorld(P, **kw) as w:
            results[name] = w.run(lanes)
            w.engine.ring_threshold_bytes = 0
            results[name + "_ring"] = w.run(lanes)
            if name == "cards":
                assert w.engine.peer_moves > 0
                assert {b.dev.device for b in
                        w.engine._buffers[P - 1].values()} \
                    == {torch.device(devices[P - 1])}
    for lane in ("", "_ring"):
        for r in range(P):
            for k, v in results["one" + lane][r].items():
                np.testing.assert_array_equal(
                    results["cards" + lane][r][k].view(np.uint32),
                    v.view(np.uint32), err_msg=f"{lane} {k} rank {r}")


# ---------------------------------------------------------------------------
# model meshes over several cards: the fused kernel's cross-card mode, its
# per-rank-table form on one card, and the models on per-card lists
# ---------------------------------------------------------------------------
def _fused_operands(P, m, K, N, dtype, seed, devices, ints=True):
    g = torch.Generator().manual_seed(seed)
    if ints:
        xs = [torch.randint(-3, 4, (P, m, K), generator=g) for _ in devices]
        ws = [torch.randint(-3, 4, (K, N), generator=g) for _ in devices]
    else:
        xs = [torch.randn(P, m, K, generator=g) for _ in devices]
        ws = [torch.randn(K, N, generator=g) * 0.05 for _ in devices]
    return ([x.to(dtype).to(d) for x, d in zip(xs, devices)],
            [w.to(dtype).to(d) for w, d in zip(ws, devices)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,m,K,N", [(2, 128, 64, 128), (3, 100, 40, 72),
                                     (4, 256, 96, 384), (8, 125, 333, 777)])
def test_fused_rank_tables_form_matches_one_launch_on_card(dtype, P, m, K,
                                                           N):
    """The fused kernel's cross-card mode in its per-rank-table form, every
    rank on one card: bitwise the plain version on integers and the
    one-launch kernel on random data, three calls back to back on the
    same tables (the handshake's count grows), one launch each."""
    devices = ["cuda:0"] * P
    xs, ws = _fused_operands(P, m, K, N, dtype, 21, devices)
    want = TF.fused_matmul_reduce_scatter_plain(xs, ws)
    before = TF.fused_matmul_reduce_scatter.launches_cross
    with tring.rank_tables():
        for _ in range(3):
            got = [t.clone() for t in TF.fused_matmul_reduce_scatter(xs, ws)]
    torch.cuda.synchronize()
    assert TF.fused_matmul_reduce_scatter.launches_cross - before == 3
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    xs, ws = _fused_operands(P, m, K, N, dtype, 22, devices, ints=False)
    one = TF.fused_matmul_reduce_scatter(xs, ws)
    with tring.rank_tables():
        got = TF.fused_matmul_reduce_scatter(xs, ws)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(got, one))


def test_fused_cross_instantiations_fit_one_block_an_sm_on_card():
    """The cross-card mode's instantiations run at one block an SM, with
    no spill, as the one-launch kernel does."""
    import ctypes

    from accl_tpu_torch.ops import _build

    lib = _build.load("fused")
    for which in (6, 7):
        out = (ctypes.c_int * 5)()
        assert lib.accl_fused_kernel_info(which, 0, out) == 0
        assert out[1] == 0 and out[4] == 1, list(out)


@pytest.mark.parametrize("layout", ["one_a_card", "two_a_card",
                                    "interleaved"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_cross_card_matches_plain_on_cards(layout, dtype):
    """The fused kernel over every card: one launch per card, each rank's
    block on its own card, bitwise the plain version on integers and the
    one-launch kernel on random data; five calls back to back; the
    allreduce form with the ring all-gather's cross-card mode."""
    devices = _layouts()[layout]
    P = len(devices)
    xs, ws = _fused_operands(P, 128, 72, 256, dtype, 23, devices)
    want = TF.fused_matmul_reduce_scatter_plain(xs, ws)
    before = TF.fused_matmul_reduce_scatter.launches_cross
    for _ in range(5):
        got = TF.fused_matmul_reduce_scatter(xs, ws)
    torch.cuda.synchronize()
    cards = len(set(devices))
    assert TF.fused_matmul_reduce_scatter.launches_cross - before == 5 * cards
    for r in range(P):
        assert got[r].device == torch.device(devices[r])
        assert _same_bits(got[r], want[r])
    xs, ws = _fused_operands(P, 128, 72, 256, dtype, 24, devices, ints=False)
    one = TF.fused_matmul_reduce_scatter([x.to("cuda:0") for x in xs],
                                         [w.to("cuda:0") for w in ws])
    got = TF.fused_matmul_reduce_scatter(xs, ws)
    assert all(_same_bits(a.to("cuda:0"), b) for a, b in zip(got, one))
    full = [x.reshape(P * 128, 72).contiguous() for x in xs]
    ar = TF.fused_matmul_allreduce_pallas(full, ws)
    ar_one = TF.fused_matmul_allreduce_pallas([x.to("cuda:0") for x in full],
                                              [w.to("cuda:0") for w in ws])
    assert all(a.device == torch.device(d) and _same_bits(a.to("cuda:0"), b)
               for a, b, d in zip(ar, ar_one, devices))


def _card_slots(n):
    """n mesh slots over the cards in contiguous groups (card 0 alone
    holds them all on a one-card machine)."""
    cards = min(4, torch.cuda.device_count())
    return [f"cuda:{r * cards // n}" for r in range(n)]


def _small_model():
    cfg = TT.ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=8,
                         n_kv_heads=4, d_head=32, d_ff=512, mlp="swiglu",
                         rope=True, attn="flash")
    return cfg, TT.init_params(np.random.default_rng(3), cfg, tp=1,
                               device="cuda:0")


def test_model_forward_generate_and_step_over_cards_on_cards():
    """The transformer over per-card lists (all on card 0 with one card):
    the forward, greedy generate and a dp 2 x tp 2 AdamW step, bitwise
    the one-card forms; the decode graph captures over the cards and
    replays the eager static step."""
    from accl_tpu_torch import optim
    from accl_tpu_torch.models import decode as TD
    from accl_tpu_torch.parallel import make_mesh
    from accl_tpu_torch.utils.tree import tree_leaves

    cfg, full = _small_model()
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (4, 64))).to("cuda:0")
    placed = TT.place_params(full, cfg, make_mesh(tp=4,
                                                  devices=_card_slots(4)))
    one = TT.shard_params(full, cfg, 4)
    torch.cuda.set_device(0)
    assert torch.equal(TT.forward(placed, tok, cfg).cpu(),
                       TT.forward(one, tok, cfg).cpu())
    # a kernel launched on another card leaves the current card as it was
    assert torch.cuda.current_device() == 0
    assert torch.equal(TD.generate(placed, tok[:, :8], cfg, 5).cpu(),
                       TD.generate(one, tok[:, :8], cfg, 5).cpu())
    cache = TD.init_kv_cache(cfg, 4, 16, 4, devices=placed.places.devices)
    _lg, cache = TD.prefill(placed, tok[:, :8], cache, cfg)
    eager = TD.DecodeGraph(placed, {**cache, "layers": [
        {k: [t.clone() for t in v] for k, v in layer.items()}
        for layer in cache["layers"]]}, cfg, tok[:, 8])
    g = TD.DecodeGraph(placed, cache, cfg, tok[:, 8]).capture()
    for _ in range(3):
        assert torch.equal(g.replay().cpu(), eager.step().cpu())
        assert torch.equal(g.token.cpu(), eager.token.cpu())
    mesh = make_mesh(dp=2, tp=2, devices=_card_slots(4))
    reps = TT.place_params(full, cfg, mesh)
    ref = TT.shard_params(full, cfg, 2)
    opt = optim.adamw(1e-3)
    sc, _s, ic = TT.make_train_step(mesh, cfg, optimizer=opt, params=reps)
    s1, _s, i1 = TT.make_train_step(make_mesh(dp=2, tp=2), cfg,
                                    optimizer=opt, params=ref)
    stc, st1 = ic(reps), i1(ref)
    for _ in range(2):
        _p, stc, lc = sc(reps, stc, tok)
        _p, st1, l1 = s1(ref, st1, tok)
        assert torch.equal(lc.cpu(), l1.cpu())
    for rep in reps:
        for a, b in zip(tree_leaves(TT.shard_params(rep, cfg, 2)),
                        tree_leaves(ref)):
            assert torch.equal(a.cpu(), b.cpu())


def _table_ops(P, seed):
    """The per-rank-table forms' launches of chip_smoke.py's
    cross_capture phase at a small size: (name -> call, name -> plain
    result)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, m, K, N = 3 * 4099, 64, 96, 128
    xs = [torch.randn(P, n, generator=g, device="cuda") for _ in range(P)]
    ys = [torch.randn(n, generator=g, device="cuda") for _ in range(P)]
    tx = [torch.randint(-3, 4, (P * m, K), generator=g, device="cuda")
          .float() for _ in range(P)]
    tw = [torch.randint(-3, 4, (K, N), generator=g, device="cuda").float()
          for _ in range(P)]
    ops = {"rs_sum": lambda: tring.ring_reduce_scatter(xs),
           "rs_max": lambda: tring.ring_reduce_scatter(xs, "max"),
           "ag": lambda: tring.ring_all_gather(ys),
           "tp": lambda: TF.fused_matmul_allreduce_pallas(tx, tw)}
    mine = TF.fused_matmul_reduce_scatter_plain(
        [x.view(P, m, K) for x in tx], tw)
    want = {"rs_sum": tring.ring_reduce_scatter_plain(xs),
            "rs_max": tring.ring_reduce_scatter_plain(xs, "max"),
            "ag": tring.ring_all_gather_plain(ys),
            "tp": [t.view(P * m, N) for t in tring.ring_all_gather_plain(
                [b.view(-1) for b in mine])]}
    return ops, want


def test_rank_tables_forms_replay_in_a_cuda_graph_on_card():
    """The cross-card modes' per-rank-table forms (ring reduce-scatter by
    sum and max, all-gather, fused_matmul_allreduce_pallas) captured in
    one graph and replayed 4 times, with eager launches on the same
    tables (the capture stream's) before, between and after: every
    replay and eager launch bitwise the plain versions; the wrappers
    count the captured launches once."""
    P = 4
    ops, want = _table_ops(P, 41)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def eager():
        with tring.rank_tables(), torch.cuda.stream(side):
            out = {k: f() for k, f in ops.items()}
        side.synchronize()
        return out

    def held(got):
        for k, ts in got.items():
            for a, b in zip(ts, want[k]):
                assert _same_bits(a, b), k

    held(eager())
    counters = (tring.ring_reduce_scatter, tring.ring_all_gather,
                TF.fused_matmul_reduce_scatter)
    before = [fn.launches_cross for fn in counters]
    graph = torch.cuda.CUDAGraph()
    with tring.rank_tables():
        with torch.cuda.graph(graph, stream=side):
            static = {k: f() for k, f in ops.items()}
    assert [fn.launches_cross - b for fn, b in zip(counters, before)] \
        == [2, 2, 1]
    for _ in range(4):
        with torch.cuda.stream(side):
            for ts in static.values():
                for t in ts:
                    t.zero_()
            graph.replay()
        side.synchronize()
        held(static)
        held(eager())
        held(eager())


def test_cross_capture_needs_the_eager_warm_up_on_card():
    """A cross-card launch under capture on tables no eager launch made
    (or made too small) raises naming the warm-up."""
    P = 4
    g = torch.Generator(device="cuda").manual_seed(42)
    xs = [torch.randn(P, 1 << 20, generator=g, device="cuda")
          for _ in range(P)]
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="warm-up"):
        with tring.rank_tables():
            with torch.cuda.graph(graph, stream=side):
                tring.ring_reduce_scatter(xs)


def test_cross_card_launches_replay_in_a_cuda_graph_on_cards():
    """Across the cards (one rank a card): the ring reduce-scatter,
    all-gather and fused_matmul_allreduce_pallas captured in one graph
    with a side stream current on every card (forked into the capture by
    the launches' join and joined back to the capturing card's), replayed
    on that card's stream between eager launches on the same streams:
    bitwise the plain versions, each result on its rank's card."""
    cards = _two_cards_or_skip()
    P = cards
    devs = [torch.device("cuda", c) for c in range(cards)]
    # each rank's operands on its own card
    g = torch.Generator(device="cuda").manual_seed(44)
    n, m, K, N = 3 * 4099, 64, 96, 128
    xs = [torch.randn(P, n, generator=g, device="cuda").to(d) for d in devs]
    ys = [torch.randn(n, generator=g, device="cuda").to(d) for d in devs]
    tx = [torch.randint(-3, 4, (P * m, K), generator=g, device="cuda")
          .float().to(d) for d in devs]
    tw = [torch.randint(-3, 4, (K, N), generator=g, device="cuda").float()
          .to(d) for d in devs]
    ops_cards = {"rs": lambda: tring.ring_reduce_scatter(xs),
                 "ag": lambda: tring.ring_all_gather(ys),
                 "tp": lambda: TF.fused_matmul_allreduce_pallas(tx, tw)}
    want_cards = {k: [t.to("cuda:0") for t in f()]
                  for k, f in {"rs": lambda: tring.ring_reduce_scatter(
                      [x.to("cuda:0") for x in xs]),
                      "ag": lambda: tring.ring_all_gather(
                          [y.to("cuda:0") for y in ys]),
                      "tp": lambda: TF.fused_matmul_allreduce_pallas(
                          [x.to("cuda:0") for x in tx],
                          [w.to("cuda:0") for w in tw])}.items()}
    sides = [torch.cuda.Stream(d) for d in devs]
    for d, sd in zip(devs, sides):
        sd.wait_stream(torch.cuda.current_stream(d))

    def current():
        stack = contextlib.ExitStack()
        for sd in sides[::-1]:
            stack.enter_context(torch.cuda.stream(sd))
        return stack

    def sync():
        for sd in sides:
            sd.synchronize()

    def held(got):
        for k, ts in got.items():
            for r, (a, b) in enumerate(zip(ts, want_cards[k])):
                assert a.device == devs[r], k
                assert _same_bits(a.to("cuda:0"), b), k

    def eager():
        with current():
            out = {k: f() for k, f in ops_cards.items()}
        sync()
        return out

    held(eager())
    graph = torch.cuda.CUDAGraph()
    pools = {}
    for d in devs[1:]:
        with torch.cuda.device(d):
            pools[d] = torch.cuda.MemPool()
    with torch.cuda.graph(graph, stream=sides[0]):
        with current(), contextlib.ExitStack() as stack:
            # as DecodeGraph.capture: the other cards' memory from pools
            # the graph holds, their streams forked into the capture first
            for d, pool in pools.items():
                stack.enter_context(torch.cuda.use_mem_pool(pool, d))
            for sd in sides[1:]:
                sd.wait_stream(sides[0])
            static = {k: f() for k, f in ops_cards.items()}
            for sd in sides[1:]:
                sides[0].wait_stream(sd)
    for _ in range(3):
        with torch.cuda.stream(sides[0]):
            graph.replay()
        sides[0].synchronize()
        held(static)
        held(eager())


def test_cross_card_capture_forks_the_other_cards_on_cards():
    """A capture on card 0's side stream of cross-card launches whose
    outputs exist (nothing allocated on the other cards): the launches'
    join forks the other cards' side streams into the capture and joins
    them back, so the capture needs nothing else; replays bitwise the
    plain versions.  With an other card's default stream current the
    launch raises instead."""
    cards = _two_cards_or_skip()
    devs = [torch.device("cuda", c) for c in range(cards)]
    g = torch.Generator(device="cuda").manual_seed(45)
    n = 3 * 4099
    xs = [torch.randn(cards, n, generator=g, device="cuda").to(d)
          for d in devs]
    rs = [torch.empty(n, device=d) for d in devs]
    ag = [torch.empty(cards, n, device=d) for d in devs]
    want_rs = tring.ring_reduce_scatter_plain(xs)
    want_ag = tring.ring_all_gather_plain(want_rs)
    sides = [torch.cuda.Stream(d) for d in devs]
    for d, sd in zip(devs, sides):
        sd.wait_stream(torch.cuda.current_stream(d))

    def step():
        tring.ring_reduce_scatter(xs, out=rs)
        tring.ring_all_gather(rs, out=ag)

    def current():
        stack = contextlib.ExitStack()
        for sd in sides[::-1]:
            stack.enter_context(torch.cuda.stream(sd))
        return stack

    with current():
        step()  # the warm-up: the tables of these streams
    for sd in sides:
        sd.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=sides[0]):
        with current():
            step()
    for _ in range(3):
        for t in rs + ag:
            t.zero_()
        for d in devs:
            torch.cuda.synchronize(d)
        with torch.cuda.stream(sides[0]):
            graph.replay()
        sides[0].synchronize()
        for a, b in zip(rs + ag, want_rs + want_ag):
            assert _same_bits(a, b.to(a.device))
    with pytest.raises(RuntimeError, match="default stream"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=sides[0]):
            step()


def test_decode_graph_over_card0_mesh_is_the_eager_step_on_card():
    """DecodeGraph on a tp = 4 mesh with every slot on card 0 (a placed
    tree: the capture path over the placement's cards, one here):
    captured and replayed 4 times, each step bitwise the eager static
    step on a copy of the cache; generate with the graph gives
    graph=False's tokens."""
    from accl_tpu_torch.models import decode as TD
    from accl_tpu_torch.parallel import make_mesh

    cfg, full = _small_model()
    placed = TT.place_params(full, cfg, make_mesh(tp=4,
                                                  devices=["cuda:0"] * 4))
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 12))).to("cuda:0")
    cache = TD.init_kv_cache(cfg, 2, 20, 4, devices=placed.places.devices)
    _lg, cache = TD.prefill(placed, tok[:, :8], cache, cfg)
    copy = {**cache, "layers": [{k: [t.clone() for t in v]
                                 for k, v in layer.items()}
                                for layer in cache["layers"]]}
    eager = TD.DecodeGraph(placed, copy, cfg, tok[:, 8])
    g = TD.DecodeGraph(placed, cache, cfg, tok[:, 8]).capture()
    for t in range(4):
        g.token.copy_(tok[:, 8 + t])
        eager.token.copy_(tok[:, 8 + t])
        assert torch.equal(g.replay(), eager.step())
    assert torch.equal(TD.generate(placed, tok[:, :8], cfg, 5),
                       TD.generate(placed, tok[:, :8], cfg, 5, graph=False))


@pytest.mark.parametrize("schedule", ["contiguous", "zigzag", "windowed"])
def test_ring_attention_over_cards_on_cards(schedule):
    """Ring attention with the sp members on per-card lists (under
    autograd a flash launch per member and hop), bitwise the one-card
    ring, with gradients."""
    import importlib

    RA = importlib.import_module("accl_tpu_torch.parallel.ring_attention")
    devs = _card_slots(4)
    g = torch.Generator().manual_seed(5)
    base = [torch.randn(1, 4 * 256, h, 64, generator=g) for h in (8, 2, 2)]
    kw = {"causal": True}
    if schedule == "zigzag":
        kw["schedule"] = "zigzag"
    if schedule == "windowed":
        kw["window"] = 100

    def run(devices):
        # devices=None: the one-card ring, every member on card 0
        ts = [b.to("cuda:0").requires_grad_(True) for b in base]
        args = [[c.to(d) for c, d in zip(t.chunk(4, 1),
                                         devices or ["cuda:0"] * 4)]
                for t in ts]
        outs = RA.ring_attention(*args, impl="flash", devices=devices, **kw)
        sum((o.to("cuda:0") * (i + 1)).sum()
            for i, o in enumerate(outs)).backward()
        return [o.to("cuda:0") for o in outs], [t.grad for t in ts]

    got, gg = run(devs)
    want, gw = run(None)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert all(_same_bits(a, b) for a, b in zip(gg, gw))


#: test_moe_over_cards_on_cards: the logits of each member's rows run on
#: their own against the one-card ep forward, which multiplies every
#: member's rows at once (cuBLAS may take another kernel for fewer rows):
#: read 3.58e-7 on an H100 at 700 W, fused or not; bitwise four cards
#: against their card-0 mesh
MOE_MEMBER_LOGITS_TOL = 1e-5


def test_moe_over_cards_on_cards(record_property):
    """The MoE model with each ep member's rows on its card (two members
    a card on four cards), forward and one SGD step: bitwise the same
    mesh with every slot on card 0; against the one-card ep forms the
    logits within MOE_MEMBER_LOGITS_TOL (recorded as a property of the
    test), and, since each member folds its own rows' share of the
    replicated leaves' gradients, the loss within 1e-5 and each leaf's
    update (lr 1: the mean gradient) within 1e-3 relative L2
    (chip_smoke.py's MOE_UPDATE_BOUND)."""
    from accl_tpu_torch.models import moe as TMO
    from accl_tpu_torch.parallel import make_mesh
    from accl_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = TMO.MoEConfig(vocab=256, d_model=64, n_layers=2, n_heads=4,
                        d_head=16, d_ff=128, n_experts=8)
    full = TMO.init_params(np.random.default_rng(6), cfg, ep=1,
                           device="cuda:0")
    tok = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (8, 32))).to("cuda:0")
    mesh = make_mesh(ep=8, devices=_card_slots(8))
    card0 = make_mesh(ep=8, devices=["cuda:0"] * 8)
    placed = TMO.place_params(full, cfg, mesh)
    on0 = TMO.place_params(full, cfg, card0)
    one = tree_map(torch.clone, TMO.shard_params(full, cfg, 8))
    # one copy of a replicated leaf a card, each member's tensor over it
    pl, emb = placed.places, placed["embed"]
    owns = [pl.own(emb, e) for e in range(8)]
    assert all(t.device == torch.device(d) for t, d in zip(owns, pl.devices))
    assert len({t.data_ptr() for t in owns}) == len(pl.cards)
    for fused in (False, True):
        a, _ = TMO.forward(placed, tok, cfg, ep=8, fused=fused)
        b, _ = TMO.forward(on0, tok, cfg, ep=8, fused=fused)
        c, _ = TMO.forward(one, tok, cfg, ep=8, fused=fused)
        assert torch.equal(a.cpu(), b.cpu())
        err = float((a.cpu() - c.cpu()).abs().max())
        record_property(f"logits_max_abs_err_fused_{fused}", err)
        assert err <= MOE_MEMBER_LOGITS_TOL, err
    p0 = [t.clone() for t in tree_leaves(one)]
    sc, _ = TMO.make_train_step(mesh, cfg, lr=1.0)
    s0, _ = TMO.make_train_step(card0, cfg, lr=1.0)
    s1, _ = TMO.make_train_step(make_mesh(ep=8), cfg, lr=1.0)
    _p, lc = sc(placed, tok)
    _p, l0 = s0(on0, tok)
    _p, l1 = s1(one, tok)
    assert torch.equal(lc.cpu(), l0.cpu())
    assert abs(float(lc) - float(l1)) <= 1e-5 * abs(float(l1))
    got = tree_leaves(TMO.shard_params(placed, cfg, 8))
    for a, b, c, c0 in zip(got, tree_leaves(TMO.shard_params(on0, cfg, 8)),
                           tree_leaves(one), p0):
        assert torch.equal(a.cpu(), b.cpu())
        du, dw = a.double().cpu() - c0.double().cpu(), \
            c.double().cpu() - c0.double().cpu()
        assert float((du - dw).norm() / dw.norm()) <= 1e-3
