"""Card-only tests of the port's CUDA kernels: each kernel against its
plain PyTorch version on the same CUDA tensors, and the model's forward
on the card against the same forward on the CPU.

This file imports torch and the port only, so it runs on a machine
without JAX, bypassing tests/conftest.py (which pins JAX to the CPU):

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

Without a card every test skips.
"""
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
        iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
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
