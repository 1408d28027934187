"""The backward on each card: every card's residual stream carries its own
gradient (accl_tpu_torch/parallel/collectives.py ``spread``, ``fan_out``,
``gather_sum``, ``collect``; accl_tpu_torch/models/transformer.py), on
the CPU with faked cards (``devices=["cpu"] * P``: every rank a card of
its own, every crossing a counted ``collectives.move``).

- ``fan_out``'s backward is bitwise the fold autograd makes of one tensor
  used by the same consumers on one card, for P = 2, 3, 4 ranks and 1, 2,
  3 uses a rank, with ranks on cards of their own or sharing cards out
  of rank order, and every card's copy gets it; the crossings are
  counted as a formula.
- After ``backward()`` every card's stream gradient is bitwise the
  one-card model's, at every block (dense, flash, swiglu, fused).
- The crossings of a backward, recorded source card to destination card
  (``collectives._cross``, the one point every counted crossing goes
  through): no gradient reaches card 0 but along the ``fan_out`` chain.
- The dp x tp SGD and AdamW steps with swiglu, remat and ``fused=True``
  (pipelined and not) are bitwise the one-card steps, and against the
  JAX package's single-device step within tests/test_torch_train.py's
  tolerances (rtol 5e-4 / atol 5e-5, loss rtol 1e-5).
- The AdamW readings of chip_smoke.py (each leaf's first moment by
  relative L2 against the one-card step) read 0 for the sound step and
  catch a card whose stream gradient was dropped (planted).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accl_tpu.models.transformer as JT
from accl_tpu_torch import model_params_from_jax, model_params_to_numpy
from accl_tpu_torch import optim as TO
from accl_tpu_torch.models import transformer as TT
from accl_tpu_torch.parallel import collectives as TC
from accl_tpu_torch.parallel import make_mesh
from accl_tpu_torch.utils.tree import tree_leaves, tree_map

LR = 0.05
B, T = 4, 16
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=64)
FLASH = dict(attn="flash", n_kv_heads=2, mlp="swiglu", rope=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cpus(n):
    return ["cpu"] * n


def _same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _chain_moves(cards):
    """The fold's crossings: one wherever the next rank walking
    down from the last lies on another card, then one a card after the
    first (``cards[r]``: rank r's card)."""
    P = len(cards)
    return (sum(cards[r] != cards[r - 1] for r in range(1, P))
            + len(set(cards)) - 1)


def _recorded(monkeypatch):
    """Every counted crossing, (source card, destination card), in
    order."""
    log = []
    real = TC._cross

    def cross(t, device, src, dst):
        log.append((src, dst))
        return real(t, device, src, dst)

    monkeypatch.setattr(TC, "_cross", cross)
    return log


# ---------------------------------------------------------------------------
# fan_out's fold
# ---------------------------------------------------------------------------
LAYOUTS = {2: [(0, 1), (0, 0)], 3: [(0, 1, 2), (0, 1, 0)],
           4: [(0, 1, 2, 3), (0, 1, 0, 1), (0, 1, 1, 0)]}


@pytest.mark.parametrize("uses", [1, 2, 3])
@pytest.mark.parametrize("P,cards", [(P, c) for P in LAYOUTS
                                     for c in LAYOUTS[P]], ids=str)
def test_fan_out_fold_is_the_one_card_fold(P, cards, uses, monkeypatch):
    g = torch.Generator().manual_seed(P * 10 + uses)
    x = torch.randn(5, 7, generator=g)
    # consumers whose gradients differ in scale, so that the order of the
    # fold shows in the bits
    ws = [torch.randn(5, 7, generator=g) * 10.0 ** (i % 5 - 2)
          for i in range(P * uses)]
    one = x.clone().requires_grad_(True)
    sum((one * w).sum() for w in ws).backward()
    per_card = [x.clone().requires_grad_(True) for _ in range(max(cards) + 1)]
    copies = [per_card[c] for c in cards]
    outs = TC.fan_out(copies, uses=uses)
    assert len(outs) == P * uses
    assert all(o.data_ptr() == copies[i // uses].data_ptr()
               for i, o in enumerate(outs))
    log = _recorded(monkeypatch)
    TC.reset_moves()
    sum((o * w).sum() for o, w in zip(outs, ws)).backward()
    n_cards = len(set(cards))
    if n_cards == 1:  # one card: nothing crosses, the fold is in place
        assert TC.moves() == 0
    else:
        assert TC.moves() == _chain_moves(cards)
        # the fold walks the ranks down and crosses at every change of
        # card, then goes back along the cards 0 -> 1 -> 2 ...
        order = [c for r in reversed(range(P)) for c in [cards[r]]]
        hops = [(a, b) for a, b in zip(order, order[1:]) if a != b]
        assert log == hops + [(c - 1, c) for c in range(1, n_cards)]
    for c in per_card:
        assert torch.equal(c.grad, one.grad)


# ---------------------------------------------------------------------------
# the model: every card's stream gradient
# ---------------------------------------------------------------------------
def _streams(monkeypatch):
    """Every residual stream a forward makes (each block's attention-out
    and MLP outputs), their gradients kept: a tensor on one card, a list
    per rank over cards."""
    got = []

    def keep(real):
        def wrapped(*args, **kw):
            out = real(*args, **kw)
            for t in (out if isinstance(out, list) else [out]):
                t.retain_grad()
            got.append(out)
            return out
        return wrapped

    for name in ("block_attn_out", "block_mlp"):
        monkeypatch.setattr(TT, name, keep(getattr(TT, name)))
    return got


@pytest.mark.parametrize("kw,fused", [({}, False), (FLASH, False),
                                      (dict(mlp="swiglu"), True)], ids=str)
@pytest.mark.parametrize("tp", [2, 4])
def test_every_card_stream_gradient_is_the_one_card_gradient(kw, fused, tp,
                                                             monkeypatch):
    if tp == 4 and "n_kv_heads" in kw:
        kw = {**kw, "n_kv_heads": 4}
    cfg = TT.ModelConfig(**BASE, **kw)
    one = TT.init_params(np.random.default_rng(3), cfg, tp=tp, device="cpu")
    placed = TT.place_params(one, cfg, make_mesh(tp=tp, devices=_cpus(tp)))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, BASE["vocab"], (2, T)))
    up = torch.randn(2, T, BASE["vocab"],
                     generator=torch.Generator().manual_seed(5))
    runs = []
    for params in (one, placed):
        for p in tree_leaves(params):
            p.requires_grad_(True)
        streams = _streams(monkeypatch)
        (TT.forward(params, toks, cfg, fused=fused) * up).sum().backward()
        monkeypatch.undo()
        runs.append(streams)
    assert len(runs[0]) == len(runs[1]) == 2 * BASE["n_layers"]
    for want, per_rank in zip(*runs):
        assert len({id(t) for t in per_rank}) == tp  # a stream a card
        for t in per_rank:
            assert torch.equal(t.grad, want.grad)


def test_backward_sends_card_0_nothing_but_the_chain(monkeypatch):
    """The crossings of a forward's backward over tp = 4 cards, source to
    destination: the exit's gradient from the hub to every card once,
    then for every block, last to first, its MLP's and its q/k/v's fold
    down the cards (3 -> 2 -> 1 -> 0) and back up (0 -> 1 -> 2 -> 3).
    Card 0 receives one crossing a fold, from card 1."""
    cfg = TT.ModelConfig(**BASE)
    one = TT.init_params(np.random.default_rng(6), cfg, tp=4, device="cpu")
    placed = TT.place_params(one, cfg, make_mesh(tp=4, devices=_cpus(4)))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, BASE["vocab"], (2, T)))
    for p in tree_leaves(placed):
        p.requires_grad_(True)
    loss = TT.forward(placed, toks, cfg).sum()
    log = _recorded(monkeypatch)
    loss.backward()
    fold = [(3, 2), (2, 1), (1, 0), (0, 1), (1, 2), (2, 3)]
    assert log == [(0, 1), (0, 2), (0, 3)] + fold * 2 * BASE["n_layers"]
    into_hub = [src for src, dst in log if dst == 0]
    assert into_hub == [1] * 2 * BASE["n_layers"]


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------
STEP_CASES = [(dict(mlp="swiglu"), False, None), (dict(remat=True), False,
                                                  None),
              ({}, True, None), (dict(mlp="swiglu", remat=True), True, None),
              (FLASH, True, None), ({}, True, 1)]


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("kw,fused,chunks", STEP_CASES, ids=str)
def test_step_variants_over_cards_are_the_one_card_step(kw, fused, chunks,
                                                        opt, monkeypatch):
    if chunks is not None:  # the fused lane's unpipelined form
        monkeypatch.setattr(TT, "fused_chunks", lambda: chunks)
    jcfg = JT.ModelConfig(**BASE, **{k: v for k, v in kw.items()
                                     if k != "remat"})
    tcfg = TT.ModelConfig(**BASE, **kw)
    params = jax.tree_util.tree_map(np.asarray, JT.init_params(
        np.random.default_rng(8), jcfg))
    tokens = np.random.default_rng(9).integers(
        0, BASE["vocab"], (B, T)).astype(np.int32)
    one = model_params_from_jax(params, tcfg, 2, device="cpu")
    mesh = make_mesh(dp=2, tp=2, devices=_cpus(4))
    placed = model_params_from_jax(params, tcfg, 2, mesh=mesh)
    toks = torch.from_numpy(tokens)
    if opt == "sgd":
        s1, _ = TT.make_train_step(make_mesh(dp=2, tp=2, device="cpu"), tcfg,
                                   lr=LR, fused=fused)
        sc, _ = TT.make_train_step(mesh, tcfg, lr=LR, fused=fused)
        _, l1 = s1(one, toks)
        _, lc = sc(placed, toks)
    else:
        adamw = TO.adamw(1e-2)
        s1, _, i1 = TT.make_train_step(make_mesh(dp=2, tp=2, device="cpu"),
                                       tcfg, optimizer=adamw, params=one,
                                       fused=fused)
        sc, _, ic = TT.make_train_step(mesh, tcfg, optimizer=adamw,
                                       params=placed, fused=fused)
        _, st1, l1 = s1(one, i1(one), toks)
        _, stc, lc = sc(placed, ic(placed), toks)
        for st in stc:
            assert _same(tree_leaves(TT.shard_params(st.mu, tcfg, 2)),
                         tree_leaves(st1.mu))
    assert torch.equal(lc, l1)
    for rep in placed:
        assert _same(tree_leaves(TT.shard_params(rep, tcfg, 2)),
                     tree_leaves(one))
    if opt == "sgd":
        (loss_sum, count), grads = jax.value_and_grad(
            lambda p: JT.loss_fn(p, jnp.asarray(tokens), jcfg),
            has_aux=True)(params)
        np.testing.assert_allclose(float(lc), float(loss_sum / count),
                                   rtol=1e-5)
        want = jax.tree_util.tree_map(lambda p, g: p - LR * (g / count),
                                      params, grads)
        for a, b in zip(_flat(model_params_to_numpy(placed[1], tcfg)),
                        _flat(want)):
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


def _rel_l2(got, want):
    return [float((a.double() - b.double()).norm()
                  / max(float(b.double().norm()), 1e-300))
            for a, b in zip(tree_leaves(got), tree_leaves(want))]


def test_adamw_moments_see_a_dropped_card_stream_gradient(monkeypatch):
    """chip_smoke.py's readings of a step (each leaf's first moment, (1 -
    b1) g, by relative L2 against the one-card step's): 0 for the tp 2
    step over cards, bitwise the one-card step; more than 0.1 on some
    leaf when card 1's stream gradient is dropped at the exit (planted:
    ``collect``'s backward hands it zeros), while the parameters of the
    two first steps stay within 2.5 lr of each other (a first AdamW step
    moves every element by about lr whatever the gradient)."""
    tcfg = TT.ModelConfig(**BASE)
    base = TT.init_params(np.random.default_rng(13), tcfg, tp=2,
                          device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, BASE["vocab"], (2, T)))
    lr = 1e-4
    mesh = make_mesh(tp=2, devices=_cpus(2))

    def step(m, params):
        run, _specs, init = TT.make_train_step(
            m, tcfg, optimizer=TO.adamw(lr), params=params)
        _p, state, _loss = run(params, init(params), tokens)
        return TT.placed_trees(state)[0]

    ref = tree_map(torch.clone, base)
    rstate = step(make_mesh(tp=2, device="cpu"), ref)
    real = TC._Collect.backward
    readings = {}
    for planted in (False, True):
        placed = TT.place_params(base, tcfg, mesh)

        def dropped(ctx, g):
            return tuple(torch.zeros_like(t) if i else t
                         for i, t in enumerate(real(ctx, g)))

        if planted:
            monkeypatch.setattr(TC._Collect, "backward",
                                staticmethod(dropped))
        st = step(mesh, placed)
        monkeypatch.undo()
        readings[planted] = (
            max(_rel_l2(TT.shard_params(st.mu, tcfg, 2), rstate.mu)),
            max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(TT.shard_params(placed, tcfg, 2)),
                tree_leaves(ref))))
    assert readings[False][0] == 0.0 and readings[True][0] > 0.1, readings
    assert max(readings[False][1], readings[True][1]) < 2.5 * lr, readings
