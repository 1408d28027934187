"""The port's model layer (accl_tpu_torch/models) against the JAX package's
(accl_tpu/models): parameters, the tensor-parallel forward (dense and
flash attention), prefill, teacher-forced decode and generation.

The JAX side runs as tests/test_decode.py and tests/test_flash_attention.py
run it on the CPU: ``forward`` picks Pallas interpret mode by itself, and
tensor parallelism is ``shard_map`` over the CPU devices of
tests/conftest.py.  The port runs on CPU tensors (its flash wrappers take
their plain versions there), with the tensor-parallel ranks as lists.
Parameters and tokens come from numpy seeds.

Tolerance: rtol = atol = 3e-5 on logits (tests/test_decode.py's tp
bound): both sides compute in float32, with BLAS summation orders that
differ from XLA's and row-parallel partial sums over the ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as Pspec

import accl_tpu.models.decode as JD
import accl_tpu.models.transformer as JT
from accl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from accl_tpu_torch import model_params_from_jax, model_params_to_numpy
from accl_tpu_torch.models import decode as TD
from accl_tpu_torch.models import transformer as TT

TOL = 3e-5
B, T = 2, 16
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=64)
CONFIGS = {
    "dense_mha_gelu": {},
    "flash_mha_gelu": {"attn": "flash"},
    "flash_gqa_swiglu_rope": {"attn": "flash", "n_kv_heads": 2,
                              "mlp": "swiglu", "rope": True},
    "dense_gqa_swiglu_rope": {"n_kv_heads": 2, "mlp": "swiglu",
                              "rope": True},
    "flash_window": {"attn": "flash", "attn_window": 5, "n_kv_heads": 2},
    "dense_window": {"attn_window": 5},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(**kw):
    return JT.ModelConfig(**BASE, **kw), TT.ModelConfig(**BASE, **kw)


def _tokens(seed=4, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, BASE["vocab"], size=shape,
                                                dtype=np.int32)


def _jax_params(jcfg, seed=3):
    return JT.init_params(np.random.default_rng(seed), jcfg)


def _port_params(jparams, tcfg, tp):
    return model_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 tcfg, tp, device="cpu")


_JAX_LOGITS = {}


def _jax_forward(name):
    """JAX single-device logits of CONFIGS[name] (cached per module)."""
    if name not in _JAX_LOGITS:
        jcfg, _ = _cfgs(**CONFIGS[name])
        _JAX_LOGITS[name] = np.asarray(JT.forward(
            _jax_params(jcfg), jnp.asarray(_tokens()), jcfg))
    return _JAX_LOGITS[name]


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL,
                               err_msg=what)


def test_same_seed_same_params_and_roundtrip():
    jcfg, tcfg = _cfgs(n_kv_heads=2, mlp="swiglu")
    jp = jax.tree_util.tree_map(np.asarray, _jax_params(jcfg))
    mine = model_params_to_numpy(
        TT.init_params(np.random.default_rng(3), tcfg, device="cpu"), tcfg)
    flat_j, tree_j = jax.tree_util.tree_flatten(jp)
    flat_t, tree_t = jax.tree_util.tree_flatten(mine)
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    # carried over split in two, and back
    p2 = model_params_from_jax(jp, tcfg, tp=2, device="cpu")
    blk = p2["blocks"][0]
    assert [tuple(w.shape) for w in blk["wq"]] == [(32, 2, 8)] * 2
    assert [tuple(w.shape) for w in blk["wk"]] == [(32, 1, 8)] * 2
    assert [tuple(w.shape) for w in blk["w2"]] == [(32, 32)] * 2
    assert isinstance(blk["ln1"], torch.Tensor) and p2["embed"].shape == \
        (64, 32)
    np.testing.assert_array_equal(blk["wq"][1].numpy(),
                                  jp["blocks"][0]["wq"][:, 2:])
    back = model_params_to_numpy(p2, tcfg)
    for a, b in zip(flat_j, jax.tree_util.tree_flatten(back)[0]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="must divide n_kv_heads"):
        TT.shard_params(p2, tcfg, 4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    jcfg, tcfg = _cfgs(**CONFIGS[name])
    got = TT.forward(_port_params(_jax_params(jcfg), tcfg, 1),
                     torch.from_numpy(_tokens()), tcfg)
    _close(got, _jax_forward(name), name)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_forward_matches_jax(tp, fused):
    name = "flash_mha_gelu" if tp == 4 else "flash_gqa_swiglu_rope"
    jcfg, tcfg = _cfgs(**CONFIGS[name])
    params = _port_params(_jax_params(jcfg), tcfg, tp)
    got = TT.forward(params, torch.from_numpy(_tokens()), tcfg, fused=fused)
    _close(got, _jax_forward(name), f"tp={tp} fused={fused}")
    if fused:
        _close(got, TT.forward(params, torch.from_numpy(_tokens()), tcfg),
               "fused against unfused")


@pytest.mark.parametrize("fused", [False, True])
def test_tp2_matches_jax_shard_map(fused):
    jcfg, tcfg = _cfgs(**CONFIGS["flash_gqa_swiglu_rope"])
    params = _jax_params(jcfg)
    mesh = jax_make_mesh(tp=2)
    specs = JT.param_specs(jcfg, tp="tp")
    f = jax.jit(jax.shard_map(
        lambda p, t: JT.forward(p, t, jcfg, tp_axis="tp", fused=fused),
        mesh=mesh, in_specs=(specs, Pspec()), out_specs=Pspec(),
        check_vma=False))
    want = np.asarray(f(JT.shard_params(params, mesh, jcfg, tp="tp"),
                        jnp.asarray(_tokens())))
    got = TT.forward(_port_params(params, tcfg, 2),
                     torch.from_numpy(_tokens()), tcfg, fused=fused)
    _close(got, want, f"shard_map tp=2 fused={fused}")


@pytest.mark.parametrize("name,tp", [("dense_gqa_swiglu_rope", 2),
                                     ("flash_window", 1),
                                     ("dense_mha_gelu", 4)])
def test_prefill_and_teacher_forced_decode_match_forward(name, tp):
    jcfg, tcfg = _cfgs(**CONFIGS[name])
    params = _port_params(_jax_params(jcfg), tcfg, tp)
    want = _jax_forward(name)
    toks = torch.from_numpy(_tokens()).long()
    cache = TD.init_kv_cache(tcfg, B, T + 4, tp=tp, device="cpu")
    got, cache2 = TD.prefill(params, toks, cache, tcfg)
    _close(got, want, "prefill")
    assert cache2["pos"] == T
    cache = TD.init_kv_cache(tcfg, B, T, tp=tp, device="cpu")
    for t in range(T):
        lg, cache = TD.decode_step(params, toks[:, t], cache, tcfg,
                                   fused=tp > 1)
        _close(lg, want[:, t], f"decode t={t}")
    # a prefill continued by decode steps: the same positions
    cache = TD.init_kv_cache(tcfg, B, T, tp=tp, device="cpu")
    _, cache = TD.prefill(params, toks[:, :10], cache, tcfg)
    lg, cache = TD.decode_step(params, toks[:, 10], cache, tcfg)
    _close(lg, want[:, 10], "prefill then decode")


def _gen_setup():
    jcfg, tcfg = _cfgs(**CONFIGS["flash_gqa_swiglu_rope"])
    jp = JT.init_params(np.random.default_rng(11), jcfg)
    # larger weights than init_params' 0.02 give a peaked distribution,
    # so the greedy choice is far from ties
    jp = jax.tree_util.tree_map(lambda a: a * 8 if a.ndim > 1 else a, jp)
    return jcfg, tcfg, jp, _tokens(seed=12, shape=(B, 6))


def test_generate_greedy_matches_jax():
    jcfg, tcfg, jp, prompt = _gen_setup()
    new = 6
    want = np.asarray(JD.generate(jp, jnp.asarray(prompt), jcfg, max_new=new))
    assert len(set(want.ravel().tolist())) > 2  # not one repeated token
    # every greedy choice was decided by more than the tolerance
    seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    lg = np.asarray(JT.forward(jp, jnp.asarray(seq), jcfg))[:, 5:]
    top2 = np.sort(lg, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * TOL
    for tp in (1, 2):
        got = TD.generate(_port_params(jp, tcfg, tp), torch.from_numpy(prompt),
                          tcfg, max_new=new, fused=tp > 1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_top_k_and_reproducible():
    jcfg, tcfg, jp, prompt = _gen_setup()
    params = _port_params(jp, tcfg, 2)
    pr = torch.from_numpy(prompt)

    def sample(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return TD.generate(params, pr, tcfg, max_new=5, temperature=1.0,
                           generator=g, **kw)

    a, b = sample(5, top_k=3), sample(5, top_k=3)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab
    # every sampled token is among the top 3 of its step's logits
    seq = torch.cat([pr.long(), a[:, :-1]], dim=1)
    lg = TT.forward(params, seq, tcfg)[:, prompt.shape[1] - 1:]
    top3 = torch.topk(lg, 3, dim=-1).indices
    assert bool((top3 == a[..., None]).any(-1).all())
    greedy = TD.generate(params, pr, tcfg, max_new=5)
    assert torch.equal(sample(9, top_k=1), greedy)
    draws = {tuple(sample(s).ravel().tolist()) for s in range(4)}
    assert len(draws) > 1


def test_capacity_and_top_k_errors():
    _, tcfg = _cfgs()
    params = TT.init_params(np.random.default_rng(0), tcfg, device="cpu")
    toks = torch.from_numpy(_tokens()).long()
    cache = TD.init_kv_cache(tcfg, B, T - 1, device="cpu")
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        TD.prefill(params, toks, cache, tcfg)
    cache = TD.init_kv_cache(tcfg, B, T, device="cpu")
    _, cache = TD.prefill(params, toks[:, :10], cache, tcfg)
    with pytest.raises(ValueError, match="past cache capacity"):
        TD.prefill(params, toks[:, :7], cache, tcfg)
    for bad in (0, -3, tcfg.vocab + 1):
        with pytest.raises(ValueError, match="top_k"):
            TD.generate(params, toks[:, :4], tcfg, max_new=2,
                        temperature=1.0, top_k=bad)
    with pytest.raises(ValueError, match="top_k"):
        TD._select(torch.zeros(B, 8), None, 1.0, 9)
    assert TD.generate(params, toks[:, :4], tcfg, max_new=0).shape == (B, 0)


def test_config_validation_and_unported_axes_match_jax():
    bad = [dict(attn="ring"), dict(n_kv_heads=3), dict(attn_window=0),
           dict(mlp="relu"), dict(rope=True, d_head=7),
           dict(sp_schedule="spiral")]
    for kw in bad:
        with pytest.raises(ValueError) as je:
            JT.ModelConfig(**kw)
        with pytest.raises(ValueError) as te:
            TT.ModelConfig(**kw)
        assert str(je.value) == str(te.value)
    # sp = 2 (ring attention over two sequence shards) against the JAX
    # package's forward under shard_map on the sp axis
    jcfg, tcfg = _cfgs()
    jparams = _jax_params(jcfg)
    params = _port_params(jparams, tcfg, 1)
    jfwd = jax.jit(jax.shard_map(
        lambda p, t: JT.forward(p, t, jcfg, sp_axis="sp"),
        mesh=jax_make_mesh(sp=2), in_specs=(Pspec(), Pspec(None, "sp")),
        out_specs=Pspec(None, "sp")))
    want = np.asarray(jfwd(jparams, jnp.asarray(_tokens())))
    got = TT.forward(params, torch.from_numpy(_tokens()), tcfg, sp=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    zig = TT.ModelConfig(**BASE, sp_schedule="zigzag")
    with pytest.raises(ValueError) as te:
        TT.forward(params, torch.from_numpy(_tokens()), zig)
    with pytest.raises(ValueError) as je:
        JT.forward(jparams, jnp.asarray(_tokens()),
                   JT.ModelConfig(**BASE, sp_schedule="zigzag"))
    assert str(te.value) == str(je.value)
