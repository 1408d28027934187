"""The port's training path (accl_tpu_torch/models/transformer.py:
``loss_fn``, ``_mean_grads``, ``make_train_step``, ``remat``) against the
JAX package's (accl_tpu/models/transformer.py).

Both packages start from the same numpy-seeded parameters
(``model_params_from_jax``) and tokens.  The JAX side runs as
tests/test_model.py runs it on the CPU: ``make_train_step`` under
``shard_map`` over the virtual CPU devices of tests/conftest.py, flash in
Pallas interpret mode.  Its flash train step on a mesh is not the
reference here: on the CPU it turns ``check_vma`` off (the Pallas
interpreter inside ``shard_map`` fails the check), and with the check
off the replicated parameters' gradients come out wrong (updates off by
30-150 % of their size at dp = 2 and tp = 2, hidden under
tests/test_model.py's absolute tolerances by its 1e-3 learning rate; see
ROADMAP.md Queue 3).  Flash steps are held instead to the JAX package's
single-device step (``jax.grad`` of ``loss_fn`` outside ``shard_map``,
the reference tests/test_model.py uses), which the mesh step must equal.

Tolerances: loss rtol 1e-5, updated parameters rtol 5e-4 / atol 5e-5
(tests/test_model.py:76-82).  Because an update at lr 0.05 is small
against the parameters, each leaf's update (new - old) is also held to a
relative L2 error of 2e-4 (readings up to 4.0e-5; float32 sums in other
orders).  remat: gradients within rtol 1e-6 / atol 1e-7 of the exact
ones (tests/test_model.py:117).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import accl_tpu.models.transformer as JT
from accl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from accl_tpu_torch import model_params_from_jax, \
    model_params_to_numpy
from accl_tpu_torch.models import transformer as TT
from accl_tpu_torch.ops import flash as TFL
from accl_tpu_torch.parallel import make_mesh

LR = 0.05
B, T = 4, 16
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=64)
FLASH = dict(attn="flash", n_kv_heads=2, mlp="swiglu", rope=True)
AXES = [dict(dp=2), dict(tp=2), dict(dp=2, tp=2)]
UPDATE_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(**kw):
    return JT.ModelConfig(**BASE, **kw), TT.ModelConfig(**BASE, **kw)


def _setup(jcfg, seed=1):
    params = JT.init_params(np.random.default_rng(seed), jcfg)
    tokens = np.random.default_rng(seed + 1).integers(
        0, BASE["vocab"], size=(B, T)).astype(np.int32)
    return params, tokens


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_single_step(params, tokens, cfg):
    (loss_sum, count), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jnp.asarray(tokens), cfg), has_aux=True)(
            params)
    new = jax.tree_util.tree_map(lambda p, g: p - LR * (g / count), params,
                                 grads)
    return _np(new), float(loss_sum / count)


def _jax_mesh_step(params, tokens, cfg, axes, fused=False):
    mesh = jax_make_mesh(**axes)
    step, (_specs, tok_spec) = JT.make_train_step(mesh, cfg, lr=LR,
                                                  fused=fused)
    new, loss = step(JT.shard_params(params, mesh, cfg),
                     jax.device_put(jnp.asarray(tokens),
                                    NamedSharding(mesh, tok_spec)))
    return _np(new), float(loss)


def _port_step(params, tokens, cfg, axes, fused=False):
    mesh = make_mesh(**axes, device="cpu")
    p = model_params_from_jax(_np(params), cfg, axes.get("tp", 1),
                              device="cpu")
    step, (specs, tok_spec) = TT.make_train_step(mesh, cfg, lr=LR,
                                                 fused=fused)
    assert tok_spec == ("dp" if "dp" in axes else None, None)
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


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_dense_train_step_matches_jax_mesh_step(axes):
    jcfg, tcfg = _cfgs()
    params, tokens = _setup(jcfg)
    _hold(_port_step(params, tokens, tcfg, axes),
          _jax_mesh_step(params, tokens, jcfg, axes), params, str(axes))


_FLASH_REF = {}


def _flash_ref(name, **kw):
    """The JAX single-device step of a flash configuration (cached)."""
    if name not in _FLASH_REF:
        jcfg, _ = _cfgs(**kw)
        params, tokens = _setup(jcfg)
        _FLASH_REF[name] = _jax_single_step(params, tokens, jcfg)
    return _FLASH_REF[name]


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_flash_train_step_matches_jax(axes):
    # flash with swiglu, RoPE and GQA (2 K/V heads, so 1 per rank at tp 2)
    jcfg, tcfg = _cfgs(**FLASH)
    params, tokens = _setup(jcfg)
    _hold(_port_step(params, tokens, tcfg, axes),
          _flash_ref("flash", **FLASH), params, str(axes))


def test_fused_train_step_matches_jax():
    # JAX's fused mesh step fails its own vma check on the CPU (out_specs
    # P() inferred varying over tp), so the fused lane is held to the
    # single-device step, whose math it must equal
    axes = dict(dp=2, tp=2)
    jcfg, tcfg = _cfgs(mlp="swiglu", n_kv_heads=2)
    params, tokens = _setup(jcfg)
    _hold(_port_step(params, tokens, tcfg, axes, fused=True),
          _jax_single_step(params, tokens, jcfg), params, "fused")


def test_grid_kernel_train_step_matches_jax(monkeypatch):
    """attn_window sends the forward to the grid schedule and bounds both
    backward kernels to the window's blocks."""
    calls = {"grid": 0, "dq": 0, "dkv": 0}
    for key, name in (("grid", "flash_fwd_grid_plain"),
                      ("dq", "flash_bwd_dq_plain"),
                      ("dkv", "flash_bwd_dkv_plain")):
        fn = getattr(TFL, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(TFL, name, counted)
    kw = dict(FLASH, attn_window=5)
    jcfg, tcfg = _cfgs(**kw)
    params, tokens = _setup(jcfg)
    got = _port_step(params, tokens, tcfg, dict(dp=2, tp=2))
    # 2 layers x 2 tp ranks x 2 dp members
    assert calls == {"grid": 8, "dq": 8, "dkv": 8}
    _hold(got, _flash_ref("window", **kw), params, "window")


def test_remat_matches_exact_and_jax():
    jcfg, tcfg = _cfgs(**FLASH)
    params, tokens = _setup(jcfg)
    p = model_params_from_jax(_np(params), tcfg, 2, device="cpu")
    toks = torch.from_numpy(tokens)

    def grads(cfg):
        return TT._mean_grads([lambda q: TT.loss_fn(q, toks, cfg)], p)

    (ga, la), (gb, lb) = grads(tcfg), grads(dataclasses.replace(
        tcfg, remat=True))
    assert float(la) == float(lb)
    for a, b in zip(TT.tree_leaves(ga), TT.tree_leaves(gb)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7)
    rcfg_j, rcfg_t = _cfgs(**FLASH, remat=True)
    _hold(_port_step(params, tokens, rcfg_t, dict(dp=2, tp=2)),
          _flash_ref("flash", **FLASH), params, "remat")


def test_bf16_flash_remat_training_smoke():
    # tests/test_model.py's real-chip training configuration
    _, tcfg = _cfgs(dtype="bfloat16", attn="flash", remat=True)
    params = TT.init_params(np.random.default_rng(0), tcfg, tp=2,
                            device="cpu")
    step, _ = TT.make_train_step(make_mesh(dp=2, tp=2, device="cpu"), tcfg,
                                 lr=1e-2)
    tokens = np.random.default_rng(1).integers(0, BASE["vocab"], (4, 32))
    losses = []
    for _ in range(3):
        params, loss = step(params, tokens)
        losses.append(float(loss))
    assert all(np.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses


def test_training_errors_match_jax():
    jcfg, tcfg = _cfgs()
    mesh = make_mesh(dp=2, device="cpu")
    # the optimizer path needs params, as JAX's (tests/test_torch_optim.py
    # holds the path itself to JAX's optax step)
    with pytest.raises(ValueError) as te:
        TT.make_train_step(mesh, tcfg, optimizer=object())
    with pytest.raises(ValueError) as je:
        JT.make_train_step(jax_make_mesh(dp=2), jcfg, optimizer=object())
    assert str(te.value) == str(je.value)
    assert "optimizer path needs `params`" in str(te.value)
    # an sp axis trains now (tests/test_torch_sp_model.py holds it to JAX);
    # the sequence must split over its members
    sp_step, (_s, sp_spec) = TT.make_train_step(
        make_mesh(dp=2, sp=2, device="cpu"), tcfg)
    assert sp_spec == ("dp", "sp")
    zig = dataclasses.replace(tcfg, sp_schedule="zigzag")
    with pytest.raises(ValueError) as te:
        TT.make_train_step(mesh, zig)
    with pytest.raises(ValueError) as je:
        JT.make_train_step(jax_make_mesh(dp=2),
                           dataclasses.replace(jcfg, sp_schedule="zigzag"))
    assert str(te.value) == str(je.value)
    params = TT.init_params(np.random.default_rng(0), tcfg, device="cpu")
    tokens = torch.zeros((3, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="does not split over 3 sp"):
        TT.loss_fn(params, tokens, tcfg, sp=3)
    _p, sp_loss = sp_step(params, tokens[:2])
    assert np.isfinite(float(sp_loss))
    step, _ = TT.make_train_step(mesh, tcfg, check_vma=True)
    with pytest.raises(ValueError, match="does not split"):
        step(params, tokens)
    step, _ = TT.make_train_step(make_mesh(tp=2, device="cpu"), tcfg)
    with pytest.raises(ValueError, match="tp ranks"):
        step(params, torch.zeros((2, 8), dtype=torch.long))
