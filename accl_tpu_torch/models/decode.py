"""Autoregressive inference: KV-cache prefill, single-token decode and
generation.

Port of ``accl_tpu/models/decode.py``.  ``prefill`` runs the prompt once
and banks each layer's K/V; ``decode_step`` extends the cache one token;
``generate`` is prefill then an eager loop of decode steps (the JAX
package compiles it as one program; CUDA graphs come later).  The cache
holds the grouped K/V layout, [B, L, G_r, Dh] per tensor-parallel rank
(each rank banks its own K/V heads), and attention against it is the
dense grouped softmax of ``_grouped_cached_attention``, as in the JAX
package.  Unlike the JAX package, the cache is written in place: the
returned cache shares its tensors with the one passed in and only its
``pos`` is new.  The per-block projections and MLP are the training
forward's (``block_qkv``, ``block_attn_out``, ``block_mlp``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .transformer import (
    ModelConfig,
    _mm,
    _rmsnorm,
    block_attn_out,
    block_mlp,
    block_qkv,
    tp_size,
)

NEG_INF = -1e30


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1,
                  device="cuda") -> dict:
    """Empty cache: per layer, per rank, K/V of [B, max_len, G / tp, Dh],
    and the fill position."""
    dev = resolve_device(device, "init_kv_cache")
    if cfg.kv_heads % tp != 0:
        raise ValueError(f"tensor-parallel extent {tp} must divide "
                         f"n_kv_heads={cfg.kv_heads}")
    shape = (batch, max_len, cfg.kv_heads // tp, cfg.d_head)

    def zeros():
        return [torch.zeros(shape, dtype=cfg.tdtype, device=dev)
                for _ in range(tp)]

    return {"pos": 0,
            "layers": [{"k": zeros(), "v": zeros()}
                       for _ in range(cfg.n_layers)]}


def _grouped_cached_attention(q, kc, vc, pos: int, window=None):
    """One query block against the cache without K/V expansion.  q [B,
    Tq, H, Dh]; kc/vc [B, L, G, Dh]; ``pos`` is the absolute position of
    q's first row, and row i attends slots [0, pos + i] (the trailing
    ``window`` of them)."""
    B, Tq, H, Dh = q.shape
    L, G = kc.shape[1], kc.shape[2]
    scale = torch.tensor(np.float32(1.0) / np.sqrt(Dh).astype(np.float32))
    q5 = q.reshape(B, Tq, G, H // G, Dh).float() * scale
    s = torch.einsum("bqgrd,blgd->bqgrl", q5, kc.float())
    slots = torch.arange(L, device=q.device)[None, :]
    rows = pos + torch.arange(Tq, device=q.device)[:, None]
    keep = slots <= rows
    if window is not None:
        keep = keep & (slots > rows - window)
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqgrl,blgd->bqgrd", p, vc.float())
    return out.reshape(B, Tq, H, Dh)


def prefill(params, tokens, cache: dict, cfg: ModelConfig,
            fused: bool = False):
    """Run tokens [B, Tp] once, filling the cache from its position ->
    (logits [B, Tp, vocab], cache with pos + Tp).  A non-zero starting
    position appends after the cached context and attends to all of it."""
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    B, Tp = tokens.shape
    pos0 = int(cache["pos"])
    L = cache["layers"][0]["k"][0].shape[1]
    if Tp > L:
        raise ValueError(f"prompt length {Tp} exceeds cache capacity {L}")
    if pos0 + Tp > L:
        raise ValueError(f"prefill past cache capacity: pos {pos0} "
                         f"+ {Tp} > {L}")
    dt = cfg.tdtype
    x = embed[tokens].to(dt)
    positions = (pos0 + torch.arange(Tp, device=embed.device)
                 if cfg.rope else None)
    for blk, layer in zip(params["blocks"], cache["layers"]):
        h = _rmsnorm(x, blk["ln1"])
        qs, ks, vs = block_qkv(h, blk, cfg, positions)
        attn = []
        for q, k, v, kc, vc in zip(qs, ks, vs, layer["k"], layer["v"]):
            kc[:, pos0:pos0 + Tp] = k.to(dt)
            vc[:, pos0:pos0 + Tp] = v.to(dt)
            attn.append(_grouped_cached_attention(
                q, kc, vc, pos0, window=cfg.attn_window).to(dt))
        x = block_attn_out(x, attn, blk, cfg, fused=fused)
        x = block_mlp(x, blk, cfg, fused=fused)
    x = _rmsnorm(x, params["ln_f"])
    logits = _mm(x, embed.to(dt).t())
    return logits, {"pos": pos0 + Tp, "layers": cache["layers"]}


def decode_step(params, token, cache: dict, cfg: ModelConfig,
                fused: bool = False):
    """One autoregressive step: token [B] -> (logits [B, vocab], cache
    advanced by one)."""
    logits, cache = prefill(params, torch.as_tensor(token)[:, None], cache,
                            cfg, fused=fused)
    return logits[:, 0], cache


def _select(lg, generator, temperature: float, top_k):
    """Next token from logits [B, vocab]: greedy at temperature 0, else
    temperature-scaled (optionally top-k truncated) sampling, Gumbel-max
    over the generator's uniforms (JAX's categorical draws the same way,
    from its own stream)."""
    if temperature == 0.0:
        return torch.argmax(lg, dim=-1)
    lg = lg.float() / temperature
    if top_k is not None:
        if not 1 <= top_k <= lg.shape[-1]:
            raise ValueError(
                f"top_k must be in [1, {lg.shape[-1]}], got {top_k}")
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = torch.where(lg < kth, NEG_INF, lg)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)


def generate(params, prompt, cfg: ModelConfig, max_new: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             fused: bool = False):
    """prompt [B, Tp] -> generated [B, max_new] (int64), on the device the
    parameters live on; the cache holds exactly Tp + max_new positions.
    Greedy at ``temperature=0``; otherwise sampled from ``generator`` (a
    ``torch.Generator`` on that device; seeded 0 when None)."""
    if top_k is not None and not 1 <= top_k <= cfg.vocab:
        raise ValueError(
            f"top_k must be in [1, vocab={cfg.vocab}], got {top_k}")
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev)
    B, Tp = prompt.shape
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = init_kv_cache(cfg, B, Tp + max_new, tp_size(params), device=dev)
    logits, cache = prefill(params, prompt, cache, cfg, fused=fused)
    toks = []
    if max_new > 0:
        toks.append(_select(logits[:, -1], generator, temperature, top_k))
    for _ in range(max_new - 1):
        lg, cache = decode_step(params, toks[-1], cache, cfg, fused=fused)
        toks.append(_select(lg, generator, temperature, top_k))
    if not toks:
        return torch.empty((B, 0), dtype=torch.int64, device=dev)
    return torch.stack(toks, dim=1)
