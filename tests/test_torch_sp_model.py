"""Sequence parallelism through the port's transformer
(accl_tpu_torch/models/transformer.py: ``forward``, ``loss_fn`` and
``make_train_step`` with an sp axis) against the JAX package's, case for
case with tests/test_model.py: the train step on every axis set of its
``test_parallel_train_step_matches_single`` (contiguous and zigzag), RoPE
under sp, SwiGLU at dp 2 x tp 2 x sp 2, and the windowed forward.

The port runs each case twice: with the ring's dense impl (the CPU
default) and with its flash hops on the plain versions of the port's
kernels (the card's default, forced here).  Both are held to the JAX
package's dense sp mesh step (``make_train_step`` under ``shard_map``,
``check_vma`` on) and to its single-device step, from the same
numpy-seeded parameters and tokens; zigzag runs take the tokens permuted
by ``zigzag_indices``, as tests/test_model.py feeds them.

Tolerances (tests/test_model.py:76-82): loss rtol 1e-5, parameters rtol
5e-4 / atol 5e-5; each leaf's update (new - old) within a relative L2
error of 2e-4 of the reference's (tests/test_torch_train.py's bound; the
lr of 0.05 makes the updates large enough to read); logits rtol = atol =
3e-5 (tests/test_torch_model.py's bound).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import accl_tpu.models.transformer as JT
from accl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from accl_tpu_torch import model_params_from_jax, model_params_to_numpy
from accl_tpu_torch.models import transformer as TT
from accl_tpu_torch.parallel import make_mesh

RA = importlib.import_module("accl_tpu_torch.parallel.ring_attention")

LR = 0.05
B, T = 4, 16
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=64)
UPDATE_TOL = 2e-4
LOGIT_TOL = 3e-5
#: tests/test_model.py:42-48
AXES = [(dict(dp=2), "contiguous"), (dict(tp=2), "contiguous"),
        (dict(sp=2), "contiguous"), (dict(dp=2, tp=2, sp=2), "contiguous"),
        (dict(sp=2), "zigzag"), (dict(sp=4), "zigzag")]
#: tests/test_model.py:302-308
ROPE_AXES = [(dict(sp=2), "contiguous"), (dict(sp=2), "zigzag"),
             (dict(sp=4), "zigzag"), (dict(dp=2, tp=2, sp=2), "contiguous")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(params=["dense", "flash"])
def ring_impl(request, monkeypatch):
    """The ring's impl under the model: "dense" (the CPU default) or
    "flash" (the card's default, its hops on the plain versions here)."""
    if request.param == "flash":
        real = RA._flash_defaults
        monkeypatch.setattr(RA, "_flash_defaults",
                            lambda q: (True, real(q)[1]))
    return request.param


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(seed=2):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], size=(B, T)).astype(np.int32)


def _zigzag(tokens, axes, schedule):
    if schedule != "zigzag":
        return tokens
    return tokens[:, RA.zigzag_indices(T, axes["sp"]).numpy()]


def _jax_single_step(params, tokens, cfg):
    (loss_sum, count), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jnp.asarray(tokens), cfg), has_aux=True)(
            params)
    new = jax.tree_util.tree_map(lambda p, g: p - LR * (g / count), params,
                                 grads)
    return _np(new), float(loss_sum / count)


def _jax_mesh_step(params, tokens, cfg, axes):
    mesh = jax_make_mesh(**axes)
    step, (_specs, tok_spec) = JT.make_train_step(mesh, cfg, lr=LR)
    new, loss = step(JT.shard_params(params, mesh, cfg),
                     jax.device_put(jnp.asarray(tokens),
                                    NamedSharding(mesh, tok_spec)))
    return _np(new), float(loss)


def _port_step(params, tokens, cfg, axes):
    mesh = make_mesh(**axes, device="cpu")
    p = model_params_from_jax(_np(params), cfg, axes.get("tp", 1),
                              device="cpu")
    step, (specs, tok_spec) = TT.make_train_step(mesh, cfg, lr=LR)
    assert tok_spec == ("dp" if "dp" in axes else None,
                        "sp" if "sp" in axes else None)
    assert specs == TT.param_specs(cfg)
    new, loss = step(p, torch.from_numpy(tokens))
    assert new is p  # updated in place
    return model_params_to_numpy(new, cfg), float(loss)


def _hold(got, want, params0, what):
    (gp, gl), (wp, wl) = got, want
    np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"{what} loss")
    flat0 = jax.tree_util.tree_leaves(_np(params0))
    for i, (a, b, p0) in enumerate(zip(jax.tree_util.tree_leaves(gp),
                                       jax.tree_util.tree_leaves(wp), flat0)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5,
                                   err_msg=f"{what} leaf {i}")
        du, dw = a.astype(np.float64) - p0, b.astype(np.float64) - p0
        rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
        assert rel <= UPDATE_TOL, f"{what} leaf {i}: update off by {rel}"


def _train_case(kw, axes, schedule, seed):
    jcfg = JT.ModelConfig(**BASE, **kw)
    tcfg = TT.ModelConfig(**BASE, **kw, sp_schedule=schedule)
    params = JT.init_params(np.random.default_rng(seed), jcfg)
    tokens = _tokens(seed + 1)
    single = _jax_single_step(params, tokens, jcfg)
    laid = _zigzag(tokens, axes, schedule)
    got = _port_step(params, laid, tcfg, axes)
    _hold(got, single, params, "vs the JAX single-device step")
    mesh = _jax_mesh_step(params, laid, dataclasses.replace(
        jcfg, sp_schedule=schedule), axes)
    _hold(got, mesh, params, "vs the JAX dense sp mesh step")


@pytest.mark.parametrize("axes,schedule", AXES, ids=str)
def test_sp_train_step_matches_jax(axes, schedule, ring_impl):
    _train_case({}, axes, schedule, seed=1)


@pytest.mark.parametrize("axes,schedule", ROPE_AXES, ids=str)
def test_rope_sp_train_step_matches_jax(axes, schedule, ring_impl):
    # each shard rotates by its own global positions (zigzag shards by
    # their split chunks' positions)
    _train_case(dict(rope=True, n_kv_heads=2), axes, schedule, seed=1)


def test_swiglu_sp_train_step_matches_jax(ring_impl):
    # tests/test_model.py:357 at dp 2 x tp 2 x sp 2
    _train_case(dict(mlp="swiglu"), dict(dp=2, tp=2, sp=2), "contiguous",
                seed=17)


def test_windowed_sp_train_step_matches_jax(ring_impl):
    # the local windowed block plus one neighbour hop, inside the model
    _train_case(dict(attn_window=5, n_kv_heads=2, rope=True),
                dict(dp=2, sp=2), "contiguous", seed=5)


@pytest.mark.parametrize("schedule,sp", [("contiguous", 2),
                                         ("contiguous", 4), ("zigzag", 2),
                                         ("zigzag", 4)])
def test_sp_forward_matches_jax(schedule, sp, ring_impl):
    # the logits in the schedule's layout: un-permuted, the single-device
    # forward's
    kw = dict(n_kv_heads=2, rope=True, mlp="swiglu")
    jcfg = JT.ModelConfig(**BASE, **kw)
    tcfg = TT.ModelConfig(**BASE, **kw, sp_schedule=schedule)
    params = JT.init_params(np.random.default_rng(3), jcfg)
    tokens = _tokens(4)
    want = np.asarray(JT.forward(params, jnp.asarray(tokens), jcfg))
    laid = _zigzag(tokens, dict(sp=sp), schedule)
    p = model_params_from_jax(_np(params), tcfg, 2, device="cpu")
    got = TT.forward(p, torch.from_numpy(laid), tcfg, sp=sp).numpy()
    if schedule == "zigzag":
        got = got[:, RA.zigzag_indices_inverse(T, sp).numpy()]
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_sp_refusals_match_jax():
    # attn="flash" with sp, attn_window with zigzag: the JAX package's
    # errors; the sequence must split over the members
    params = TT.init_params(np.random.default_rng(0), TT.ModelConfig(**BASE),
                            device="cpu")
    jparams = JT.init_params(np.random.default_rng(0),
                             JT.ModelConfig(**BASE))
    mesh = jax_make_mesh(sp=2)
    tokens = _tokens()
    for kw in (dict(attn="flash"),
               dict(attn_window=4, sp_schedule="zigzag")):
        with pytest.raises(ValueError) as te:
            TT.forward(params, torch.from_numpy(tokens),
                       TT.ModelConfig(**BASE, **kw), sp=2)
        step, (_s, tok_spec) = JT.make_train_step(
            mesh, JT.ModelConfig(**BASE, **kw))
        with pytest.raises(ValueError) as je:
            step(JT.shard_params(jparams, mesh, JT.ModelConfig(**BASE)),
                 jax.device_put(jnp.asarray(tokens),
                                NamedSharding(mesh, tok_spec)))
        assert str(te.value) == str(je.value), kw
    with pytest.raises(ValueError, match="does not split"):
        TT.forward(params, torch.zeros((1, 10), dtype=torch.long),
                   TT.ModelConfig(**BASE), sp=4)
