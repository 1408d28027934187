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
from accl_tpu_torch.ops import flash as TFL
from accl_tpu_torch.ops import fused as TF
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
