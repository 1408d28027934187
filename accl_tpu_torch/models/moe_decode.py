"""KV-cache inference for the MoE family (``models/moe.py``).

Port of ``accl_tpu/models/moe_decode.py``: the serving structure of
``models/decode.py`` (cache prefill and single-token decode) with the
switch-routed expert FFN in place of the dense MLP.  Routing at decode is
the training path's top-1 router on the live tokens, at a drop-free
capacity (every token of the call).  Under expert parallelism (``ep`` >
1) the JAX package replicates the tokens over the members; on one card
the copies would run one after another, so the tokens are split over the
members instead, each routing its share at a drop-free capacity: the
same outputs, the same aux, 1/ep of the work.  The cache is written in
place; the returned cache shares its tensors with the one passed in.
Teacher-forced decode reproduces ``moe.forward`` position by position.
With the banks placed on several cards (``moe.place_params``) the cache
and attention stay on the hub (a decode batch need not split over the
members) and each member's share of the tokens goes to its card, is
routed there with the member's own router copy and runs the experts as
in ``moe.forward``, and comes back to the hub.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .decode import _grouped_cached_attention
from .moe import (
    MoEConfig,
    _add_aux,
    _moe_ffn,
    _places,
    _route,
    moe_block_attn_out,
    moe_block_qkv,
)
from .transformer import _mm, _rmsnorm


def init_kv_cache(cfg: MoEConfig, batch: int, max_len: int,
                  device="cuda") -> dict:
    """Empty cache: per layer, K/V of [B, max_len, H, Dh], and the fill
    position."""
    dev = resolve_device(device, "init_kv_cache")
    shape = (batch, max_len, cfg.n_heads, cfg.d_head)
    return {"pos": 0,
            "layers": [{"k": torch.zeros(shape, dtype=cfg.tdtype, device=dev),
                        "v": torch.zeros(shape, dtype=cfg.tdtype, device=dev)}
                       for _ in range(cfg.n_layers)]}


def prefill(params, tokens, cache: dict, cfg: MoEConfig, ep: int = 1):
    """Run tokens [B, Tp] once, filling the cache from its position ->
    (logits [B, Tp, vocab], aux, cache with pos + Tp)."""
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    B, Tp = tokens.shape
    pos0 = int(cache["pos"])
    L = cache["layers"][0]["k"].shape[1]
    if Tp > L:
        raise ValueError(f"prompt length {Tp} exceeds cache capacity {L}")
    if pos0 + Tp > L:
        raise ValueError(f"prefill past cache capacity: pos {pos0} "
                         f"+ {Tp} > {L}")
    dt = cfg.tdtype
    x = embed[tokens].to(dt)
    aux_total = None
    for blk, layer in zip(params["blocks"], cache["layers"]):
        h = _rmsnorm(x, blk["ln1"])
        q, k, v = moe_block_qkv(h, blk, cfg)
        layer["k"][:, pos0:pos0 + Tp] = k.to(dt)
        layer["v"][:, pos0:pos0 + Tp] = v.to(dt)
        attn = _grouped_cached_attention(q, layer["k"], layer["v"],
                                         pos0).to(dt)
        x = moe_block_attn_out(x, attn, blk, cfg)
        h = _rmsnorm(x, blk["ln2"])
        if ep > 1:
            m, aux = _moe_ffn_split(h, blk, cfg, ep,
                                          _places(params, "we1"))
        else:
            m, aux = _moe_ffn(h, blk, cfg, capacity=B * Tp)
        aux_total = _add_aux(aux_total, aux)
        x = x + m
    x = _rmsnorm(x, params["ln_f"])
    logits = _mm(x, embed.to(dt).t())
    return logits, aux_total, {"pos": pos0 + Tp, "layers": cache["layers"]}


def _moe_ffn_split(h, blk, cfg: MoEConfig, ep: int, places=None):
    """The expert FFN of the serving path over ``ep`` members: the B Tp
    tokens split evenly over the members (zero rows pad them to a
    multiple of ep and are dropped after), each member routing its share
    at a capacity of that share, which is drop-free.  The aux is the
    whole batch's, the value the JAX package's replicated members
    report."""
    B, Tp, D = h.shape
    N = B * Tp
    n = -(-N // ep)
    flat = h.reshape(N, D)
    padded = F.pad(flat, (0, 0, 0, n * ep - N)).reshape(ep, n, D)
    m, _member_aux = _moe_ffn(padded, blk, cfg, ep, capacity=n,
                              places=places)
    return m.reshape(-1, D)[:N].reshape(B, Tp, D), _route(flat, blk, cfg)[2]


def decode_step(params, token, cache: dict, cfg: MoEConfig, ep: int = 1):
    """One step: token [B] -> (logits [B, vocab], cache advanced by one)."""
    logits, _aux, cache = prefill(params, torch.as_tensor(token)[:, None],
                                  cache, cfg, ep=ep)
    return logits[:, 0], cache
