"""The port's flash-attention backward (accl_tpu_torch/ops/flash.py,
``_FlashPacked.backward`` over ``flash_bwd_dq`` / ``flash_bwd_dkv``)
against ``jax.grad`` of the JAX package's entries (accl_tpu/ops/flash.py).

The JAX side runs its Pallas kernels in interpret mode, forward and
backward, as tests/test_flash_attention.py does on the CPU; the port runs
its plain versions, which the wrappers take for CPU tensors.  Inputs and
the cotangent weights are the same numpy arrays, made from a seed; the
loss is sum(out * w_out) + sum(lse * w_lse), so the lse cotangent is
nonzero unless a case drops that term.  T <= 128 and D <= 32 keep the
interpreter quick.

Tolerances (max |port - JAX| on dq, dk and dv; both packages fold the
same blocks in the same order and differ only in BLAS and XLA summation
orders and the last ulp of exp2):
- mxu_dtype float32: 1e-5 absolute and relative, the JAX tests' bound for
  float32 gradients (tests/test_flash_attention.py:424); readings up to
  3.1e-6 on gradients up to 6 in magnitude;
- mxu_dtype bfloat16: 4e-3, as the forward's (tests/test_torch_flash.py):
  a last-ulp difference can flip a probability's or a dS entry's bf16
  rounding; readings up to 1.9e-5 with float32 inputs and 4.9e-4 with
  bfloat16 gradients (a bf16 ulp is 3.1e-2 at 5).
The plain dq/dkv versions on the JAX package's own prepared operands
(``_flash_backward``) are held to the same bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accl_tpu.ops.flash as JF
from accl_tpu_torch.ops import flash as TF

TOL = {"float32": 1e-5, "bfloat16": 4e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CASES = [("float32", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "bfloat16")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _grads_both(fn_j, fn_t, arrays, w_out, w_lse, dt, mxu, **kw):
    """d/d(q, k, v) of sum(out w_out) [+ sum(lse w_lse)] through the JAX
    entry (interpret) and the port's; numpy float32 triples.  An entry
    returning only out takes w_lse None; w_out None drops the out term
    (an lse-only loss)."""
    def loss_j(q, k, v):
        res = fn_j(q, k, v, interpret=True, mxu_dtype=JDT[mxu], **kw)
        out, lse = res if isinstance(res, tuple) else (res, None)
        total = 0.0
        if w_out is not None:
            total = jnp.sum(out.astype(jnp.float32) * w_out)
        if w_lse is not None:
            total = total + jnp.sum(lse * w_lse)
        return total

    jg = jax.grad(loss_j, argnums=(0, 1, 2))(
        *(jnp.asarray(a, JDT[dt]) for a in arrays))
    ts = [torch.from_numpy(a).to(TDT[dt]).requires_grad_(True)
          for a in arrays]
    res = fn_t(*ts, mxu_dtype=TDT[mxu], **kw)
    out, lse = res if isinstance(res, tuple) else (res, None)
    total = 0.0
    if w_out is not None:
        total = (out.float() * torch.from_numpy(w_out)).sum()
    if w_lse is not None:
        total = total + (lse * torch.from_numpy(w_lse)).sum()
    total.backward()
    return ([np.asarray(g, np.float32) for g in jg],
            [t.grad.float().numpy() for t in ts])


def _close(got, want, mxu, what=""):
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, rtol=TOL[mxu], atol=TOL[mxu],
                                   err_msg=f"{what} d{name}")


def _packed_case(seed, N, G, T, Tk, D, dt, mxu, use_lse=True, **kw):
    q, k, v, w_out = _arrays(seed, (N, T, D), (N // G, Tk, D),
                             (N // G, Tk, D), (N, T, D))
    w_lse = _arrays(seed + 100, (N, T))[0] if use_lse else None
    got_want = _grads_both(JF.flash_attention_packed_lse,
                           TF.flash_attention_packed_lse, [q, k, v], w_out,
                           w_lse, dt, mxu, **kw)
    _close(got_want[1], got_want[0], mxu, str(kw))


@pytest.mark.parametrize("dt,mxu", CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_packed_grads_match_jax(causal, dt, mxu):
    # GQA with 2 or 4 q heads per K/V head; g_lse nonzero
    group = 2 if causal else 4
    _packed_case(3 * causal + CASES.index((dt, mxu)), 8, group, 64, 64, 32,
                 dt, mxu, causal=causal, block_q=16, block_k=32)


@pytest.mark.parametrize("kernel", ["resident", "grid"])
def test_cross_length_mqa_grads_match_jax(kernel):
    # one K/V head for every q head, Tq != Tk, no lse term (g_lse None)
    _packed_case(21, 4, 4, 32, 96, 32, "float32", "float32", use_lse=False,
                 causal=False, block_q=16, block_k=32, kernel=kernel)


@pytest.mark.parametrize("window,kernel", [(5, "grid"),
                                           (40, "grid_resident")])
def test_window_grads_match_jax(window, kernel):
    _packed_case(window, 4, 2, 128, 128, 32, "float32", "float32",
                 causal=True, block_q=32, block_k=16, kernel=kernel,
                 window=window)


@pytest.mark.parametrize("opts", [
    {"block_q": 32, "block_k": 64, "chunk_k": 16},  # chunk_k < bk
    {"block_q": 64, "block_k": 64},   # T = 96: the blocks shrink to 32
])
def test_chunked_and_ragged_grads_match_jax(opts):
    _packed_case(31, 4, 2, 96, 96, 32, "float32", "float32", causal=True,
                 kernel="resident", **opts)


def test_bthd_entries_and_lse_only_loss_match_jax():
    B, T, H, G, D = 2, 32, 4, 2, 16
    q, k, v, w_out = _arrays(41, (B, T, H, D), (B, T, G, D), (B, T, G, D),
                             (B, T, H, D))
    (w_lse,) = _arrays(42, (B, H, T))
    kw = dict(causal=True, block_q=16, block_k=16)
    want, got = _grads_both(JF.flash_attention, TF.flash_attention,
                            [q, k, v], w_out, None, "float32", "float32",
                            **kw)
    _close(got, want, "float32", "flash_attention")
    # the out cotangent unused: g_out arrives as None and becomes zeros
    want, got = _grads_both(JF.flash_attention_lse, TF.flash_attention_lse,
                            [q, k, v], None, w_lse, "float32", "float32",
                            **kw)
    _close(got, want, "float32", "flash_attention_lse, lse only")


@pytest.mark.parametrize("window", [None, 9])
def test_plain_dq_dkv_match_jax_flash_backward(window):
    """flash_bwd_dq_plain / flash_bwd_dkv_plain against the two Pallas
    kernels through the JAX package's own ``_flash_backward`` (its host
    prep included), on one set of saved forward residuals."""
    N, G, T, D = 8, 4, 64, 32
    q, k, v, g_out = _arrays(51, (N, T, D), (N // G, T, D), (N // G, T, D),
                             (N, T, D))
    (g_lse,) = _arrays(52, (N, T))
    cfg_t = TF._resolve_schedule(T, T, D, torch.float32, True, 16, 32,
                                 torch.float32, "grid", 16, False, None,
                                 None, window) + (G,)
    cfg_j = JF._resolve_schedule(T, T, D, jnp.dtype(jnp.float32), True, 16,
                                 32, True, jnp.float32, "grid", 16, False,
                                 None, None, window) + (G,)
    out, lse = JF.flash_attention_packed_lse(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, block_q=16,
        block_k=32, interpret=True, mxu_dtype=jnp.float32, kernel="grid",
        window=window)
    want = JF._flash_backward(*(jnp.asarray(a) for a in (q, k, v)), out, lse,
                              jnp.asarray(g_out), jnp.asarray(g_lse), cfg_j)
    t = torch.from_numpy
    qp, kp, vp, go = (t(a) for a in (q, k, v, g_out))
    out_t, lse_t = t(np.array(out)), t(np.array(lse))
    a = 1.0 / float(D) ** 0.5
    q2 = (qp.float() * (a * TF._LOG2E)).to(qp.dtype)
    l2 = lse_t * TF._LOG2E
    dvec = (go * out_t).sum(-1) - t(g_lse)
    dq = TF.flash_bwd_dq(q2, kp, vp, go, l2, dvec, cfg_t)
    dk, dv = TF.flash_bwd_dkv(q2, kp, vp, go, l2, dvec, cfg_t)
    _close([x.numpy() for x in (dq, dk, dv)],
           [np.asarray(x) for x in want], "float32", f"window={window}")
    assert TF.flash_bwd_dq.launches == 0 and TF.flash_bwd_dkv.launches == 0


def test_card_tensors_never_take_the_plain_version():
    q = torch.zeros(2, 8, 16, device="meta")
    cfg = TF._resolve_schedule(8, 8, 16, torch.float32, True, 8, 8,
                               torch.float32, "grid", None, False, None,
                               None) + (1,)
    lse = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        TF.flash_bwd_dq(q, q, q, q, lse, lse, cfg)
    with pytest.raises(ValueError, match="cpu or cuda"):
        TF.flash_bwd_dkv(q, q, q, q, lse, lse, cfg)
