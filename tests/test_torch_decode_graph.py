"""The static decode step of ``generate`` (accl_tpu_torch/models/decode.py
``DecodeGraph``: the position a device int tensor, the cache written
with ``index_copy_`` at it, the token a buffer the step overwrites), run
eagerly on the CPU, against today's eager decode (``decode_step`` with a
Python position) and the JAX package's greedy ``generate``, whose
``lax.scan`` of decode steps is what the CUDA graph stands for.

Tolerance: bitwise.  The static step computes the same values as the
eager one (the same positions, the same cache slots, the same mask);
only where they come from differs.  Against JAX, the generated tokens
are equal, as tests/test_torch_model.py holds them (every greedy choice
decided by more than ten times its logit tolerance).  The CUDA capture
and replay run only on the card (tests/test_torch_card.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accl_tpu.models.decode as JD
from accl_tpu_torch.models import decode as TD
from accl_tpu_torch.models import transformer as TT
from accl_tpu_torch.ops import ring as tring
from test_torch_model import (B, CONFIGS, T, _cfgs, _gen_setup, _jax_params,
                              _port_params, _tokens)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _teacher(params, tcfg, toks, Tp, fused, static):
    """Prefill toks[:, :Tp], then teacher-forced steps over the rest: the
    logits of each step and the cache after them."""
    L = toks.shape[1]
    cache = TD.init_kv_cache(tcfg, B, L, tp=TT.tp_size(params), device="cpu")
    _, cache = TD.prefill(params, toks[:, :Tp], cache, tcfg, fused=fused)
    out = []
    if static:
        stepper = TD.DecodeGraph(params, cache, tcfg, toks[:, Tp],
                                 fused=fused)
        for t in range(Tp, L):
            stepper.token.copy_(toks[:, t])
            out.append(stepper.step().clone())
        assert int(stepper.cache["pos"]) == L
        assert stepper.cache["pos"].dtype == torch.int64
        return out, stepper.cache
    for t in range(Tp, L):
        lg, cache = TD.decode_step(params, toks[:, t], cache, tcfg,
                                   fused=fused)
        out.append(lg)
    return out, cache


@pytest.mark.parametrize("name,tp,fused", [
    ("dense_gqa_swiglu_rope", 2, True), ("flash_window", 1, False),
    ("dense_mha_gelu", 4, False), ("dense_window", 2, False)])
def test_static_step_is_bitwise_the_eager_decode(name, tp, fused):
    jcfg, tcfg = _cfgs(**CONFIGS[name])
    params = _port_params(_jax_params(jcfg), tcfg, tp)
    toks = torch.from_numpy(_tokens()).long()
    got, gcache = _teacher(params, tcfg, toks, 6, fused, static=True)
    want, wcache = _teacher(params, tcfg, toks, 6, fused, static=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for la, lb in zip(gcache["layers"], wcache["layers"]):
        for key in ("k", "v"):
            for a, b in zip(la[key], lb[key]):
                assert torch.equal(a, b)


def test_prefill_at_a_tensor_position_is_bitwise_the_int_one():
    jcfg, tcfg = _cfgs(**CONFIGS["dense_gqa_swiglu_rope"])
    params = _port_params(_jax_params(jcfg), tcfg, 2)
    toks = torch.from_numpy(_tokens()).long()
    outs = []
    for pos in (5, torch.tensor(5)):
        cache = TD.init_kv_cache(tcfg, B, T, tp=2, device="cpu")
        _, cache = TD.prefill(params, toks[:, :5], cache, tcfg)
        cache["pos"] = pos
        lg, cache = TD.prefill(params, toks[:, 5:9], cache, tcfg)
        assert int(cache["pos"]) == 9
        outs.append((lg, cache))
    (a, ca), (b, cb) = outs
    assert torch.equal(a, b)
    for la, lb in zip(ca["layers"], cb["layers"]):
        for a_, b_ in zip(la["k"] + la["v"], lb["k"] + lb["v"]):
            assert torch.equal(a_, b_)


@pytest.mark.parametrize("tp,fused", [(1, False), (2, False), (2, True)])
def test_generate_static_matches_eager_loop_and_jax(tp, fused):
    jcfg, tcfg, jp, prompt = _gen_setup()
    new = 6
    want = np.asarray(JD.generate(jp, jnp.asarray(prompt), jcfg,
                                  max_new=new))
    params = _port_params(jp, tcfg, tp)
    pr = torch.from_numpy(prompt)
    static = TD.generate(params, pr, tcfg, max_new=new, fused=fused)
    eager = TD.generate(params, pr, tcfg, max_new=new, fused=fused,
                        graph=False)
    assert torch.equal(static, eager)
    np.testing.assert_array_equal(static.numpy(), want)
    for n in (0, 1, 2):
        got = TD.generate(params, pr, tcfg, max_new=n, fused=fused)
        assert tuple(got.shape) == (B, n)
        assert torch.equal(got, eager[:, :n])


def test_sampled_static_step_draws_as_the_eager_loop():
    _, tcfg, jp, prompt = _gen_setup()
    params = _port_params(jp, tcfg, 2)
    pr = torch.from_numpy(prompt)
    runs = []
    for graph in (True, False):
        g = torch.Generator().manual_seed(21)
        runs.append(TD.generate(params, pr, tcfg, max_new=6,
                                temperature=0.7, top_k=5, generator=g,
                                graph=graph))
    assert torch.equal(*runs)


def test_graph_needs_a_card_and_no_device_trace(monkeypatch):
    """Capture needs a CUDA device; on the CPU, generate's default
    (``graph=True``) runs the static step eagerly.  ACCL_DEVICE_TRACE
    does not stop generate: only a ring kernel's stamp launch refuses a
    capture (tests/test_torch_card.py), and the decode step runs none."""
    _, tcfg = _cfgs()
    params = TT.init_params(np.random.default_rng(0), tcfg, device="cpu")
    toks = torch.from_numpy(_tokens()).long()
    eager = TD.generate(params, toks[:, :4], tcfg, max_new=3, graph=False)
    assert torch.equal(
        TD.generate(params, toks[:, :4], tcfg, max_new=3, graph=True), eager)
    cache = TD.init_kv_cache(tcfg, B, 8, device="cpu")
    _, cache = TD.prefill(params, toks[:, :4], cache, tcfg)
    stepper = TD.DecodeGraph(params, cache, tcfg, toks[:, 4])
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        stepper.capture()
    monkeypatch.setenv("ACCL_DEVICE_TRACE", "1")
    tring._reset_device_trace_cache()
    try:
        assert torch.equal(
            TD.generate(params, toks[:, :4], tcfg, max_new=3), eager)
        with pytest.raises(ValueError, match="CUDA graphs need a CUDA"):
            stepper.capture()
    finally:
        monkeypatch.delenv("ACCL_DEVICE_TRACE")
        tring._reset_device_trace_cache()
