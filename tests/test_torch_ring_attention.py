"""The port's sequence-parallel attention (accl_tpu_torch/parallel/
ring_attention.py) against the JAX package's (accl_tpu/parallel/
ring_attention.py), case for case with tests/test_parallel_strategies.py:
every schedule (contiguous, zigzag, windowed) x impl (dense, and flash
through the plain versions of the port's kernels) x causal, forward and
gradients, GQA, Ulysses, and the flash options.

The JAX side runs as tests/test_parallel_strategies.py runs it: under
``shard_map`` over the virtual CPU devices of tests/conftest.py, its flash
hops in Pallas interpret mode (``check_vma`` off there, as in those
tests).  The port takes one tensor per member (the sequence shards of
the same numpy-seeded global q, k, v) and runs on CPU tensors.

Tolerances: outputs rtol = atol = 2e-4 and gradients rtol = atol = 1e-4
(tests/test_parallel_strategies.py's bounds for the same comparisons);
GQA against expanded K/V rtol = atol = 1e-5; schedule bookkeeping (the
zigzag permutation, launch counts, a skipped dead hop) exact.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as Pspec

from accl_tpu.parallel import ring_attention as jax_ring
from accl_tpu.parallel import ulysses_attention as jax_ulysses
from accl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from accl_tpu.ops.flash import flash_attention as jax_flash
from accl_tpu_torch.ops import flash as TFL
from accl_tpu_torch.parallel import ring_attention, ulysses_attention

# the modules: their packages export functions under the same names
JRA = importlib.import_module("accl_tpu.parallel.ring_attention")
RA = importlib.import_module("accl_tpu_torch.parallel.ring_attention")

FWD_TOL = 2e-4
GRAD_TOL = 1e-4
SPEC = Pspec(None, "sp", None, None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(P, B, Tl, H, D, seed, G=None):
    T = P * Tl
    return (_rand((B, T, H, D), seed), _rand((B, T, G or H, D), seed + 1),
            _rand((B, T, G or H, D), seed + 2))


def _shards(x, P):
    return list(torch.from_numpy(np.ascontiguousarray(x)).chunk(P, dim=1))


def _port(fn, q, k, v, P, **kw):
    out = fn(_shards(q, P), _shards(k, P), _shards(v, P), **kw)
    return torch.cat(out, dim=1).numpy()


def _jax(fn, q, k, v, P, check_vma=True, **kw):
    f = jax.jit(jax.shard_map(
        lambda a, b, c: fn(a, b, c, axis="sp", **kw),
        mesh=jax_make_mesh(sp=P), in_specs=(SPEC,) * 3, out_specs=SPEC,
        check_vma=check_vma))
    return np.asarray(f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


# (schedule, window, causal) x impl: every case the ring accepts
CASES = [("contiguous", None, False), ("contiguous", None, True),
         ("zigzag", None, True), ("windowed", 7, True),
         ("windowed", 16, True)]
IDS = ["contiguous-noncausal", "contiguous-causal", "zigzag-causal",
       "windowed7-causal", "windowed16-causal"]


def _kwargs(schedule, window, causal, impl):
    kw = dict(causal=causal, impl=impl)
    if schedule == "zigzag":
        kw["schedule"] = "zigzag"
    if window is not None:
        kw["window"] = window
    return kw


def _layout(x, schedule, P):
    """x in the schedule's layout (zigzag: permuted), and the inverse."""
    if schedule != "zigzag":
        return x, None
    T = x.shape[1]
    return (x[:, np.asarray(RA.zigzag_indices(T, P))],
            np.asarray(RA.zigzag_indices_inverse(T, P)))


def _global_dense(q, k, v, causal, window):
    return np.asarray(JRA._dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("schedule,window,causal", CASES, ids=IDS)
def test_ring_attention_forward_matches_jax(schedule, window, causal, impl):
    P, B, Tl, H, D = 4, 2, 16, 2, 16
    q, k, v = _qkv(P, B, Tl, H, D, 11)
    kw = _kwargs(schedule, window, causal, impl)
    (qz, inv), (kz, _), (vz, _) = (_layout(x, schedule, P)
                                   for x in (q, k, v))
    got = _port(ring_attention, qz, kz, vz, P, **kw)
    want = _jax(jax_ring, qz, kz, vz, P, check_vma=impl != "flash", **kw)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    if inv is not None:
        got = got[:, inv]
    np.testing.assert_allclose(got, _global_dense(q, k, v, causal, window),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("schedule,window,causal", CASES, ids=IDS)
def test_ring_attention_grads_match_jax(schedule, window, causal, impl):
    # gradients of sum(out^2) through the hops, the lse merges (a live
    # lse cotangent into the flash backward) and the rotations, held to
    # the JAX package's dense ring (check_vma on)
    P, B, Tl, H, D = 4, 1, 16, 2, 8
    q, k, v = _qkv(P, B, Tl, H, D, 41)
    kw = _kwargs(schedule, window, causal, impl)
    (qz, _), (kz, _), (vz, _) = (_layout(x, schedule, P) for x in (q, k, v))
    ts = [torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
          for x in (qz, kz, vz)]
    out = ring_attention(*(list(t.chunk(P, dim=1)) for t in ts), **kw)
    got = torch.autograd.grad(sum((o ** 2).sum() for o in out), ts)
    jkw = {**kw, "impl": "dense"}
    fn = jax.shard_map(lambda a, b, c: jax_ring(a, b, c, axis="sp", **jkw),
                       mesh=jax_make_mesh(sp=P), in_specs=(SPEC,) * 3,
                       out_specs=SPEC)
    want = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                            argnums=(0, 1, 2)))(
        jnp.asarray(qz), jnp.asarray(kz), jnp.asarray(vz))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("schedule", ["contiguous", "zigzag", "windowed"])
def test_ring_attention_gqa_matches_expanded(schedule, impl):
    # grouped K/V: the flash hops read the grouped layout in place, the
    # dense impl expands; either way equal to the ring fed expanded K/V,
    # and to the JAX package's grouped ring
    P, B, Tl, H, G, D = 4, 1, 16, 4, 2, 16
    q, k, v = _qkv(P, B, Tl, H, D, 12, G=G)
    kw = _kwargs("zigzag" if schedule == "zigzag" else "contiguous",
                 9 if schedule == "windowed" else None, True, impl)
    (qz, _), (kz, _), (vz, _) = (_layout(x, schedule, P) for x in (q, k, v))
    grouped = _port(ring_attention, qz, kz, vz, P, **kw)
    rep = functools.partial(np.repeat, repeats=H // G, axis=2)
    expanded = _port(ring_attention, qz, rep(kz), rep(vz), P, **kw)
    np.testing.assert_allclose(grouped, expanded, rtol=1e-5, atol=1e-5)
    want = _jax(jax_ring, qz, kz, vz, P, check_vma=impl != "flash", **kw)
    np.testing.assert_allclose(grouped, want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_ring_attention_zigzag_every_ring_size(impl, P):
    # the chunk liveness algebra depends on P
    B, Tl, H, D = 2, 16, 2, 16
    q, k, v = _qkv(P, B, Tl, H, D, 12)
    (qz, inv), (kz, _), (vz, _) = (_layout(x, "zigzag", P)
                                   for x in (q, k, v))
    got = _port(ring_attention, qz, kz, vz, P, causal=True, impl=impl,
                schedule="zigzag")[:, inv]
    np.testing.assert_allclose(got, _global_dense(q, k, v, True, None),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("window", [1, 7, 16, 31, 32])
def test_windowed_ring_matches_banded_dense(window):
    # every window/shard phase, w == T_local and w = 1 included
    P, B, Tl, H, D = 4, 2, 32, 2, 16
    q, k, v = _qkv(P, B, Tl, H, D, 71)
    want = _global_dense(q, k, v, True, window)
    for impl, tol in (("dense", 2e-5), ("flash", FWD_TOL)):
        got = _port(ring_attention, q, k, v, P, causal=True, impl=impl,
                    window=window)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=impl)


def test_zigzag_indices_match_jax():
    T, P = 64, 4
    perm = RA.zigzag_indices(T, P)
    inv = RA.zigzag_indices_inverse(T, P)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(JRA.zigzag_indices(T, P)))
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(JRA.zigzag_indices_inverse(T, P)))
    x = torch.arange(T)
    assert torch.equal(x[perm][inv], x)
    with pytest.raises(ValueError) as te:
        RA.zigzag_indices(30, 4)
    with pytest.raises(ValueError) as je:
        JRA.zigzag_indices(30, 4)
    assert str(te.value) == str(je.value)


def test_ring_attention_validation_matches_jax():
    z = np.zeros((1, 16, 2, 4), np.float32)
    cases = [dict(causal=False, schedule="zigzag"),
             dict(causal=False, window=4, impl="dense"),
             dict(causal=True, window=4, impl="dense", schedule="zigzag"),
             dict(causal=True, window=9, impl="dense"),
             dict(causal=True, schedule="spiral"),
             dict(causal=True, impl="ring")]
    for kw in cases:
        with pytest.raises(ValueError) as te:
            ring_attention(_shards(z, 2), _shards(z, 2), _shards(z, 2), **kw)
        with pytest.raises(ValueError) as je:
            jax.shard_map(lambda a: jax_ring(a, a, a, axis="sp", **kw),
                          mesh=jax_make_mesh(sp=2), in_specs=SPEC,
                          out_specs=SPEC, check_vma=False)(jnp.asarray(z))
        assert str(te.value) == str(je.value), kw
    with pytest.raises(ValueError, match="GQA"):
        ring_attention([torch.zeros(1, 8, 4, 4)], [torch.zeros(1, 8, 3, 4)],
                       [torch.zeros(1, 8, 3, 4)])


def test_ring_attention_flash_opts_passthrough():
    # the resident-schedule options and static_max reach every hop
    P, B, Tl, H, D = 4, 1, 16, 2, 16
    q, k, v = _qkv(P, B, Tl, H, D, 31)
    want = _global_dense(q, k, v, True, None)
    for opts in ({"q_tiles": 2, "fuse_denom": True},
                 {"static_max": 40.0, "kernel": "resident"}):
        for sched in ("contiguous", "zigzag"):
            (qz, inv), (kz, _), (vz, _) = (_layout(x, sched, P)
                                           for x in (q, k, v))
            got = _port(ring_attention, qz, kz, vz, P, causal=True,
                        impl="flash", schedule=sched, flash_opts=opts)
            if inv is not None:
                got = got[:, inv]
            np.testing.assert_allclose(got, want, rtol=FWD_TOL,
                                       atol=FWD_TOL, err_msg=str(opts))


def test_default_impl_is_dense_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(TFL, "flash_attention_lse",
                        lambda *a, **k: calls.append(1))
    q = [torch.zeros(1, 4, 2, 8)] * 2
    ring_attention(q, q, q, causal=True)
    assert not calls
    assert RA._flash_defaults(q[0]) == (False, torch.float32)
    assert RA._flash_defaults(q[0].bfloat16())[1] == torch.bfloat16


@pytest.mark.parametrize("schedule,window,causal,launches", [
    ("contiguous", None, True, 4), ("contiguous", None, False, 4),
    ("zigzag", None, True, 5), ("windowed", 5, True, 1)])
def test_flash_hops_stack_the_live_members(schedule, window, causal,
                                           launches, monkeypatch):
    # one flash call per hop over the members live on it, stacked along
    # the batch axis: P per contiguous ring (hop s holds P - s members
    # when causal), P + 1 zigzag (hop 0: the 2P diagonal pairs causal
    # and the P (qh, kl) pairs; later hops 2P pairs), 1 windowed
    P, B = 4, 2
    seen = []
    real = TFL.flash_attention_lse

    def spy(q, k, v, causal=False, **kw):
        seen.append((q.shape[0] // B, causal))
        return real(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(TFL, "flash_attention_lse", spy)
    q, k, v = _qkv(P, B, 16, 2, 8, 5)
    ring_attention(_shards(q, P), _shards(k, P), _shards(v, P),
                   **_kwargs(schedule, window, causal, "flash"))
    assert len(seen) == launches
    if schedule == "contiguous" and causal:
        assert seen == [(4, True), (3, False), (2, False), (1, False)]
    elif schedule == "contiguous":
        assert seen == [(4, False)] * 4
    elif schedule == "zigzag":
        assert seen == [(8, True), (4, False)] + [(8, False)] * 3
    else:
        assert seen == [(4, True)]


def test_skipping_a_dead_hop_is_bitwise_merging_it():
    # _lse_merge of a dead partial (lse = -inf) leaves the live carry as it
    # was, bit for bit; and the flash ring (stacked hops, dead hops
    # skipped, the first partial taken as the carry) equals, bit for bit,
    # the JAX schedule written out per member from the zero carry with
    # every dead partial merged
    g = torch.Generator().manual_seed(3)
    o = torch.randn(2, 8, 2, 4, generator=g)
    lse = torch.randn(2, 2, 8, generator=g) * 5
    dead_o = torch.randn(2, 8, 2, 4, generator=g)
    dead_lse = torch.full((2, 2, 8), RA.NEG_INF)
    o2, lse2 = RA._lse_merge(o, lse, dead_o * 0, dead_lse)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)

    P, B = 4, 1
    q, k, v = (_shards(x, P) for x in _qkv(P, B, 16, 2, 8, 9))
    got = ring_attention(q, k, v, causal=True, impl="flash")
    for idx in range(P):
        carry = (torch.zeros(B, 16, 2, 8),
                 torch.full((B, 2, 16), RA.NEG_INF))
        for s in range(P):
            src = (idx - s) % P
            if src > idx:
                part = (torch.zeros(B, 16, 2, 8),
                        torch.full((B, 2, 16), RA.NEG_INF))
            else:
                part = TFL.flash_attention_lse(q[idx], k[src], v[src],
                                               causal=src == idx,
                                               mxu_dtype=torch.float32)
            carry = RA._lse_merge(carry[0], carry[1], *part)
        assert torch.equal(carry[0], got[idx]), idx


def test_ulysses_matches_jax():
    P, B, Tl, H, D = 4, 2, 8, 8, 16
    q, k, v = _qkv(P, B, Tl, H, D, 4)
    got = _port(ulysses_attention, q, k, v, P, causal=True)
    want = _jax(jax_ulysses, q, k, v, P, causal=True)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got, _global_dense(q, k, v, True, None),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_ulysses_flash_attn_fn_matches_jax():
    P, B, Tl, H, D = 4, 2, 16, 4, 16
    q, k, v = _qkv(P, B, Tl, H, D, 13)
    got = _port(ulysses_attention, q, k, v, P, causal=True,
                attn_fn=functools.partial(TFL.flash_attention, causal=True,
                                          mxu_dtype=torch.float32))
    want = _jax(jax_ulysses, q, k, v, P, check_vma=False, causal=True,
                attn_fn=functools.partial(jax_flash, causal=True,
                                          mxu_dtype=jnp.float32,
                                          interpret=True))
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_ulysses_grads_match_jax():
    P, B, Tl, H, D = 4, 1, 16, 4, 16
    q, k, v = _qkv(P, B, Tl, H, D, 53)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ulysses_attention(*(list(t.chunk(P, dim=1)) for t in ts),
                            causal=True,
                            attn_fn=functools.partial(
                                TFL.flash_attention, causal=True,
                                mxu_dtype=torch.float32))
    got = torch.autograd.grad(sum((o ** 2).sum() for o in out), ts)
    fn = jax.shard_map(
        lambda a, b, c: jax_ulysses(a, b, c, axis="sp", causal=True),
        mesh=jax_make_mesh(sp=P), in_specs=(SPEC,) * 3, out_specs=SPEC)
    want = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                            argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_ulysses_gqa():
    # grouped K/V reshard their own head axis; the default matches the
    # expanded run; a caller's attn_fn gets expanded K/V unless it says it
    # is GQA-aware, and then it sees G / P heads
    P, B, Tl, H, G, D = 4, 1, 16, 8, 4, 16
    q, k, v = _qkv(P, B, Tl, H, D, 21, G=G)
    rep = functools.partial(np.repeat, repeats=H // G, axis=2)
    grouped = _port(ulysses_attention, q, k, v, P, causal=True)
    np.testing.assert_allclose(
        grouped, _port(ulysses_attention, q, rep(k), rep(v), P, causal=True),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        grouped, _jax(jax_ulysses, q, k, v, P, causal=True),
        rtol=FWD_TOL, atol=FWD_TOL)
    seen = []

    def probe(qx, kx, vx):
        seen.append(kx.shape[2])
        return TFL.flash_attention(qx, kx, vx, causal=True,
                                   mxu_dtype=torch.float32)

    expanded = _port(ulysses_attention, q, k, v, P, causal=True,
                     attn_fn=probe)
    aware = _port(ulysses_attention, q, k, v, P, causal=True,
                  attn_fn=probe, attn_fn_gqa_aware=True)
    assert seen == [H // P, G // P]
    np.testing.assert_allclose(aware, expanded, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(aware, grouped, rtol=FWD_TOL, atol=FWD_TOL)
    with pytest.raises(ValueError) as te:
        ulysses_attention(_shards(q[:, :, :6], P), _shards(k, P),
                          _shards(v, P))
    with pytest.raises(ValueError) as je:
        _jax(jax_ulysses, q[:, :, :6], k, v, P)
    assert str(te.value) == str(je.value)


def test_ulysses_windowed_attn_fn_matches_banded_dense():
    P, B, Tl, H, D, W = 4, 1, 16, 4, 16, 9
    q, k, v = _qkv(P, B, Tl, H, D, 81)
    got = _port(ulysses_attention, q, k, v, P, causal=True,
                attn_fn=functools.partial(TFL.flash_attention, causal=True,
                                          window=W, mxu_dtype=torch.float32))
    np.testing.assert_allclose(got, _global_dense(q, k, v, True, W),
                               rtol=FWD_TOL, atol=FWD_TOL)
