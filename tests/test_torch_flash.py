"""The port's flash attention (accl_tpu_torch/ops/flash.py) against the
JAX package's (accl_tpu/ops/flash.py).

The JAX side runs as tests/test_flash_attention.py runs it on the CPU:
the Pallas kernels in interpret mode.  The port runs its plain PyTorch
versions, which the kernel wrappers take for CPU tensors.  Inputs are the
same numpy arrays, made from a seed; T <= 128 and D <= 32 keep the
interpreter quick.

Tolerances (max |port - JAX| on out and lse, both packages folding in
the same block order; they differ only in BLAS summation order and in the
last ulp of exp2):
- mxu_dtype float32: 5e-6 absolute and relative (readings up to 1.7e-6,
  the largest under static_max; tests/test_flash_attention.py holds
  float32 to 1e-5);
- mxu_dtype bfloat16: 4e-3 (readings up to 1.5e-4 on float32 outputs,
  where a last-ulp exp2 difference can flip a probability's bf16
  rounding, and 9.8e-4, one bf16 ulp, on bfloat16 outputs;
  tests/test_flash_attention.py holds bf16 to 2e-2).
``_resolve_schedule`` agrees exactly, errors included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accl_tpu.ops.flash as JF
from accl_tpu_torch import ACCLError
from accl_tpu_torch.ops import flash as TF

TOL = {"float32": 5e-6, "bfloat16": 4e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(fn_j, fn_t, arrays, dt, mxu, **kw):
    """Run the JAX entry (interpret) and the port's on the same arrays in
    dtype ``dt`` with MXU dtype ``mxu``; returns numpy float32 results."""
    jo = fn_j(*(jnp.asarray(a, JDT[dt]) for a in arrays), interpret=True,
              mxu_dtype=JDT[mxu], **kw)
    to = fn_t(*(torch.from_numpy(a).to(TDT[dt]) for a in arrays),
              mxu_dtype=TDT[mxu], **kw)
    if not isinstance(jo, tuple):
        jo, to = (jo,), (to,)
    return ([np.asarray(x, np.float32) for x in jo],
            [x.float().numpy() for x in to])


def _close(got, want, mxu, what=""):
    tol = TOL[mxu]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


CASES = [("float32", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("dt,mxu", CASES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel", ["resident", "grid", "grid_resident"])
def test_packed_lse_matches_jax(kernel, causal, dt, mxu):
    # GQA with 2 or 4 q heads per K/V head, varied per case
    group = 2 if (kernel == "grid") == causal else 4
    N, T, D = 8, 128, 32
    seed = 10 * ["resident", "grid", "grid_resident"].index(kernel) \
        + 3 * causal + CASES.index((dt, mxu))
    arrays = _arrays(seed, (N, T, D),
                     (N // group, T, D), (N // group, T, D))
    (jo, jl), (to, tl) = _both(JF.flash_attention_packed_lse,
                               TF.flash_attention_packed_lse, arrays, dt, mxu,
                               causal=causal, block_q=32, block_k=64,
                               kernel=kernel)
    _close(to, jo, mxu, "out")
    _close(tl, jl, mxu, "lse")


@pytest.mark.parametrize("causal", [False, True])
def test_bthd_entries_match_jax(causal):
    B, T, H, G, D = 2, 64, 4, 1, 16
    arrays = _arrays(5, (B, T, H, D), (B, T, G, D), (B, T, G, D))
    (jo,), (to,) = _both(JF.flash_attention, TF.flash_attention, arrays,
                         "float32", "float32", causal=causal, block_q=16,
                         block_k=32)
    _close(to, jo, "float32", "flash_attention")
    (jo, jl), (to, tl) = _both(JF.flash_attention_lse, TF.flash_attention_lse,
                               arrays, "float32", "float32", causal=causal,
                               block_q=16, block_k=32)
    _close(to, jo, "float32", "out")
    _close(tl, jl, "float32", "lse")
    (jo,), (to,) = _both(JF.flash_attention_packed,
                         TF.flash_attention_packed,
                         [a.transpose(0, 2, 1, 3).reshape(-1, T, D)
                          for a in arrays], "float32", "float32",
                         causal=causal, block_q=16, block_k=32)
    _close(to, jo, "float32", "flash_attention_packed")


@pytest.mark.parametrize("window,kernel", [(1, "grid"), (5, "grid"),
                                           (40, "grid_resident"),
                                           (200, "auto")])
def test_window_matches_jax(window, kernel):
    N, T, D = 4, 128, 32
    arrays = _arrays(window, (N, T, D), (N // 2, T, D), (N // 2, T, D))
    (jo, jl), (to, tl) = _both(JF.flash_attention_packed_lse,
                               TF.flash_attention_packed_lse, arrays,
                               "float32", "float32", causal=True, block_q=32,
                               block_k=16, kernel=kernel, window=window)
    _close(to, jo, "float32", "out")
    _close(tl, jl, "float32", "lse")


@pytest.mark.parametrize("kernel,mxu", [("resident", "float32"),
                                        ("grid", "float32"),
                                        ("resident", "bfloat16")])
def test_static_max_matches_jax(kernel, mxu):
    N, T, D = 4, 128, 32
    arrays = _arrays(11, (N, T, D), (N, T, D), (N, T, D))
    (jo, jl), (to, tl) = _both(JF.flash_attention_packed_lse,
                               TF.flash_attention_packed_lse, arrays,
                               "float32", mxu, causal=True, block_q=32,
                               block_k=32, kernel=kernel, static_max=40.0)
    _close(to, jo, mxu, "out")
    _close(tl, jl, mxu, "lse")


@pytest.mark.parametrize("kernel", ["resident", "grid"])
def test_cross_length_matches_jax(kernel):
    arrays = _arrays(13, (4, 64, 32), (2, 128, 32), (2, 128, 32))
    (jo, jl), (to, tl) = _both(JF.flash_attention_packed_lse,
                               TF.flash_attention_packed_lse, arrays,
                               "float32", "float32", causal=False,
                               block_q=32, block_k=32, kernel=kernel)
    _close(to, jo, "float32", "out")
    _close(tl, jl, "float32", "lse")


@pytest.mark.parametrize("opts", [
    {"kernel": "resident", "chunk_k": 16, "q_tiles": 2, "fuse_denom": False},
    {"kernel": "resident", "fuse_denom": True, "chunk_k": 24},
    {"kernel": "grid", "q_tiles": 4, "chunk_k": 8},
    {"block_q": 64, "block_k": 64},   # T = 96: the blocks halve to 32
])
def test_schedule_options_match_jax(opts):
    N, T, D = 4, 96, 32
    arrays = _arrays(17, (N, T, D), (N, T, D), (N, T, D))
    kw = {"block_q": 32, "block_k": 48, **opts}
    (jo, jl), (to, tl) = _both(JF.flash_attention_packed_lse,
                               TF.flash_attention_packed_lse, arrays,
                               "float32", "float32", causal=True, **kw)
    _close(to, jo, "float32", "out")
    _close(tl, jl, "float32", "lse")


def _sweep():
    cases = []
    for T, Tk in ((128, 128), (96, 96), (4096, 4096), (8192, 8192),
                  (64, 128), (12, 12), (100, 100)):
        for D in (32, 64, 128):
            for dt in ("float32", "bfloat16"):
                for kernel in ("auto", "resident", "grid", "grid_resident",
                               "resident_skew", "bogus"):
                    for extra in ({}, {"window": 7}, {"static_max": 40},
                                  {"q_tiles": 3, "chunk_k": 20},
                                  {"fuse_denom": True},
                                  {"kv_cast_scratch": True, "q_tiles": 0}):
                        cases.append((T, Tk, D, dt, kernel, extra))
    return cases


def _resolve(mod, T, Tk, D, dt, kernel, extra, jax_side):
    kw = dict(window=extra.get("window"), static_max=extra.get("static_max"))
    args = (T, Tk, D, (jnp.dtype(JDT[dt]) if jax_side else TDT[dt]),
            T == Tk, 64 if T == 100 else 256, 512)
    rest = ((True,) if jax_side else ()) + (
        JDT["bfloat16"] if jax_side else TDT["bfloat16"], kernel,
        extra.get("chunk_k"), extra.get("kv_cast_scratch", False),
        extra.get("q_tiles"), extra.get("fuse_denom"))
    try:
        out = mod._resolve_schedule(*args, *rest, **kw)
    except ValueError as e:
        return ("error", str(e))
    out = list(out)
    if jax_side:
        del out[4]  # interpret
    out[4] = str(out[4]).replace("torch.", "")
    return tuple(out)


def test_resolve_schedule_agrees_with_jax():
    cases = _sweep()
    kinds = set()
    for case in cases:
        want = _resolve(JF, *case, jax_side=True)
        got = _resolve(TF, *case, jax_side=False)
        assert got == want, case
        kinds.add(want[0] if want[0] == "error" else want[5])
    # the sweep reaches every schedule and the errors
    assert kinds == {"error", "resident", "grid", "grid_resident",
                     "resident_skew"}
    # Llama-3-8B's head size in float32: 4096 tokens resident, 8192 grid
    f32 = torch.float32
    assert TF._resolve_schedule(4096, 4096, 128, f32, True, 256, 512, f32,
                                "auto", None, False, None, None)[5] \
        == "resident"
    assert TF._resolve_schedule(8192, 8192, 128, f32, True, 256, 512, f32,
                                "auto", None, False, None, None)[5] == "grid"


def test_unported_parts_raise():
    q = torch.randn(2, 32, 16)
    with pytest.raises(ACCLError, match="resident_skew"):
        TF.flash_attention_packed(q, q, q, kernel="resident_skew")
    # the backward is ported: gradients reach q (tests/test_torch_flash_bwd)
    qg = q.clone().requires_grad_(True)
    out = TF.flash_attention_packed(qg, q, q, causal=True,
                                    mxu_dtype=torch.float32)
    out.sum().backward()
    assert qg.grad.shape == q.shape and bool(torch.isfinite(qg.grad).all())


def test_shape_errors_match_jax():
    q, k3 = torch.randn(4, 32, 16), torch.randn(3, 32, 16)
    with pytest.raises(ValueError, match="K/V heads must divide"):
        TF.flash_attention_packed(q, k3, k3)
    with pytest.raises(ValueError, match="causal masking requires"):
        TF.flash_attention_packed(q, torch.randn(4, 64, 16),
                                  torch.randn(4, 64, 16), causal=True)
    with pytest.raises(ValueError, match="K/V heads must divide"):
        TF.flash_attention(torch.randn(1, 8, 4, 16), torch.randn(1, 8, 3, 16),
                           torch.randn(1, 8, 3, 16))
    with pytest.raises(ValueError, match="cpu or cuda"):
        TF.flash_attention_packed(q.to("meta"), q.to("meta"), q.to("meta"))
