"""Autoregressive inference: KV-cache prefill, single-token decode and
generation.

Port of ``accl_tpu/models/decode.py``.  ``prefill`` runs the prompt once
and banks each layer's K/V; ``decode_step`` extends the cache one token;
``generate`` is prefill then the decode steps.  The JAX package compiles
``generate`` as one program (prefill, then a ``lax.scan`` of steps); its
counterpart here is ``DecodeGraph``: one decode step made static (the
position a device int tensor, the cache written with ``index_copy_`` at
it, the token a buffer the step overwrites with its choice), captured
in a ``torch.cuda.CUDAGraph`` after a warm-up step and replayed once per
new token.  On the CPU the same static step runs eagerly; ``graph=False``
keeps the eager loop of ``decode_step`` with a Python position.  Either
way the cache is written with ``index_copy_`` at the position.  The cache
holds the grouped K/V layout, [B, L, G_r, Dh] per tensor-parallel rank
(each rank banks its own K/V heads), and attention against it is the
dense grouped softmax of ``_grouped_cached_attention``, as in the JAX
package.  Unlike the JAX package, the cache is written in place: the
returned cache shares its tensors with the one passed in and only its
``pos`` is new.  The per-block projections and MLP are the training
forward's (``block_qkv``, ``block_attn_out``, ``block_mlp``).

Parameters placed on several cards (``transformer.place_params``): the
cache is sharded over the kv heads as on one card, rank r's K/V on rank
r's card (``init_kv_cache(devices=)``), each rank banks and attends
there, and every card holds a residual stream of its own, as in the
training forward; the logits are bitwise the one-card model's.
``DecodeGraph`` captures that step too, over every card of the
placement, as one CUDA graph (the ring kernels' cross-card launches
count their handshake on the card, so a replay waits for its own), and
``generate`` replays it there as on one card.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .transformer import (
    ModelConfig,
    _mm,
    _norm,
    _places,
    _rmsnorm,
    _spread,
    block_attn_out,
    block_mlp,
    block_qkv,
    tp_size,
)

NEG_INF = -1e30


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1,
                  device="cuda", devices=None) -> dict:
    """Empty cache: per layer, per rank, K/V of [B, max_len, G / tp, Dh],
    and the fill position.  ``devices``: rank r's device, for ranks on
    several cards (the ``places.devices`` of placed parameters)."""
    if cfg.kv_heads % tp != 0:
        raise ValueError(f"tensor-parallel extent {tp} must divide "
                         f"n_kv_heads={cfg.kv_heads}")
    if devices is None:
        devs = [resolve_device(device, "init_kv_cache")] * tp
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != tp:
            raise ValueError(f"{len(devs)} devices for {tp} ranks")
    shape = (batch, max_len, cfg.kv_heads // tp, cfg.d_head)

    def zeros():
        return [torch.zeros(shape, dtype=cfg.tdtype, device=d)
                for d in devs]

    return {"pos": 0,
            "layers": [{"k": zeros(), "v": zeros()}
                       for _ in range(cfg.n_layers)]}


def _grouped_cached_attention(q, kc, vc, pos, window=None):
    """One query block against the cache without K/V expansion.  q [B,
    Tq, H, Dh]; kc/vc [B, L, G, Dh]; ``pos`` (an int, or a 0-dim device
    int tensor, as JAX's traced position) is the absolute position of q's
    first row, and row i attends slots [0, pos + i] (the trailing
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


def _cached_forward(params, tokens, layers, pos0, cfg: ModelConfig,
                    fused: bool):
    """The blocks over tokens [B, Tp] from position ``pos0`` (an int, or
    the static step's 0-dim device int tensor), banking their K/V in the
    cache ``layers`` in place with ``index_copy_`` at ``pos0 +
    arange(Tp)`` -> logits [B, Tp, vocab].  Placed parameters bank and
    attend on each rank's card."""
    places = _places(params)
    embed = params["embed"]
    Tp = tokens.shape[1]
    dt = cfg.tdtype
    x = embed[tokens].to(dt)
    if places is not None:
        x = _spread(x, places)
    offsets = pos0 + torch.arange(Tp, device=embed.device)
    for blk, layer in zip(params["blocks"], layers):
        h = _norm(x, blk["ln1"], places)
        qs, ks, vs = block_qkv(h, blk, cfg, offsets if cfg.rope else None,
                               places)
        attn = []
        for q, k, v, kc, vc in zip(qs, ks, vs, layer["k"], layer["v"]):
            at = offsets.to(kc.device)
            kc.index_copy_(1, at, k.to(dt))
            vc.index_copy_(1, at, v.to(dt))
            attn.append(_grouped_cached_attention(
                q, kc, vc, pos0 if not isinstance(pos0, torch.Tensor)
                else pos0.to(kc.device), window=cfg.attn_window).to(dt))
        x = block_attn_out(x, attn, blk, cfg, fused=fused, places=places)
        x = block_mlp(x, blk, cfg, fused=fused, places=places)
    if places is not None:
        x = x[0]
    x = _rmsnorm(x, params["ln_f"])
    return _mm(x, embed.to(dt).t())


def prefill(params, tokens, cache: dict, cfg: ModelConfig,
            fused: bool = False):
    """Run tokens [B, Tp] once, filling the cache from its position ->
    (logits [B, Tp, vocab], cache with pos + Tp).  A non-zero starting
    position appends after the cached context and attends to all of it.
    The position may be a 0-dim device int tensor; the caller then owns
    the capacity budget, as under jit in the JAX package."""
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    Tp = tokens.shape[1]
    pos0 = cache["pos"]
    L = cache["layers"][0]["k"][0].shape[1]
    if Tp > L:
        raise ValueError(f"prompt length {Tp} exceeds cache capacity {L}")
    if not isinstance(pos0, torch.Tensor):
        pos0 = int(pos0)
        if pos0 + Tp > L:
            raise ValueError(f"prefill past cache capacity: pos {pos0} "
                             f"+ {Tp} > {L}")
    logits = _cached_forward(params, tokens, cache["layers"], pos0, cfg,
                             fused)
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


class DecodeGraph:
    """One decode step made static, for replay as a CUDA graph.

    ``cache`` is a filled cache (``prefill``'s); its tensors are written in
    place and its position moves to the device, as a 0-dim int64 tensor
    that each step advances in place.  ``token`` [B] is the first token to
    decode; ``self.token`` is the step's input buffer, and each step
    overwrites it with the token ``_select`` chose, so steps chain with
    no host work between them.  ``self.logits`` [B, vocab] holds the last
    step's logits.

    ``step()`` runs the step eagerly (any device).  ``capture()`` (a CUDA
    device) runs the step once as a warm-up on a side stream, so that
    first-call work (kernel builds, cached plans, cuBLAS workspaces, the
    cross-card kernels' tables) is done outside the capture, restores the
    position, the token and the generator state the warm-up consumed, and
    captures one step into ``self.graph`` on that stream; ``replay()``
    then runs it on the current stream.  The warm-up's cache write is
    rewritten by the first replay with the same values.  A capture that
    fails raises: nothing falls back to eager steps.  Parameters placed
    on several cards are captured over every card of the placement in
    one graph: each card gets a side stream, current there for the
    warm-up and the capture, forked from the first card's at the start
    of the capture and joined back to it at its end; what the step
    allocates on the other cards comes from a ``torch.cuda.MemPool`` of
    each card (``use_mem_pool``), held with the graph, so that no
    allocation outside the graph reuses it while the graph lives.  With
    ``ACCL_DEVICE_TRACE`` set, a ring kernel launched in the step raises
    at capture (its stamp rows land after a synchronize).  Kernel
    wrappers count their launches only at capture, so a replayed step's
    launches are the captured step's, ``replays`` times.
    Sampling with a generator needs
    ``CUDAGraph.register_generator_state`` (recent PyTorch) and raises
    without it; greedy decoding needs nothing."""

    def __init__(self, params, cache: dict, cfg: ModelConfig, token,
                 fused: bool = False, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        self.params, self.cfg, self.fused = params, cfg, fused
        self.temperature, self.top_k, self.generator = (temperature, top_k,
                                                        generator)
        dev = params["embed"].device
        self.cache = {"pos": torch.tensor(int(cache["pos"]),
                                          dtype=torch.int64, device=dev),
                      "layers": cache["layers"]}
        self.token = torch.as_tensor(token, device=dev).to(
            torch.int64).clone()
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: the cards of the captured step (the hub's first), and the other
        #: cards' memory pools
        self._cards: list = []
        self._pools: dict = {}
        self.replays = 0

    def _step(self) -> torch.Tensor:
        lg = _cached_forward(self.params, self.token[:, None],
                             self.cache["layers"], self.cache["pos"],
                             self.cfg, self.fused)[:, 0]
        self.cache["pos"].add_(1)
        self.token.copy_(_select(lg, self.generator, self.temperature,
                                 self.top_k))
        return lg

    def step(self) -> torch.Tensor:
        """One eager step: advances the position and the token."""
        self.logits = self._step()
        return self.logits

    def capture(self) -> "DecodeGraph":
        """Warm up, then capture one step (see the class docstring)."""
        dev = self.token.device
        if dev.type != "cuda":
            raise ValueError(f"DecodeGraph.capture: CUDA graphs need a CUDA "
                             f"device, the parameters are on {dev}")
        graph = torch.cuda.CUDAGraph()
        if self.temperature != 0.0:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "DecodeGraph.capture: sampling needs "
                    "CUDAGraph.register_generator_state, which this "
                    "PyTorch lacks; decode greedily or with graph=False")
            graph.register_generator_state(self.generator)
        cards = _cards(self.params, dev)
        pools = _card_pools(cards[1:])
        pos, token = self.cache["pos"].clone(), self.token.clone()
        gen_state = (self.generator.get_state()
                     if self.generator is not None else None)
        sides = {d: torch.cuda.Stream(d) for d in cards}
        for d, side in sides.items():
            side.wait_stream(torch.cuda.current_stream(d))
        with _current(sides, dev):
            self._step()
            self.cache["pos"].copy_(pos)
            self.token.copy_(token)
        for side in sides.values():
            side.synchronize()
        if gen_state is not None:
            self.generator.set_state(gen_state)
        hub = sides[dev]
        with torch.cuda.graph(graph, stream=hub):
            with _current(sides, dev), contextlib.ExitStack() as stack:
                for d, pool in pools.items():
                    stack.enter_context(torch.cuda.use_mem_pool(pool, d))
                for d in cards[1:]:
                    sides[d].wait_stream(hub)
                self.logits = self._step()
                for d in cards[1:]:
                    hub.wait_stream(sides[d])
        for d, side in sides.items():
            torch.cuda.current_stream(d).wait_stream(side)
        self.graph, self._cards, self._pools = graph, cards, pools
        return self

    def replay(self) -> torch.Tensor:
        """One replayed step: advances the position and the token.  Over
        several cards, each other card's current stream then waits for
        the hub's (the graph's end follows every card's work), so what
        is queued there next follows the step."""
        self.graph.replay()
        hub = torch.cuda.current_stream(self._cards[0])
        for d in self._cards[1:]:
            torch.cuda.current_stream(d).wait_stream(hub)
        self.replays += 1
        return self.logits


def _cards(params, dev: torch.device) -> list:
    """The CUDA devices a decode step of ``params`` runs on: ``dev`` (the
    hub's) first, then the other cards of their placement, in order."""
    places = _places(params)
    devs = [dev] if places is None else [places.devices[c]
                                          for c in places.cards]
    return list(dict.fromkeys(torch.device(d) for d in [dev, *devs]))


def _card_pools(cards: list) -> dict:
    """A ``torch.cuda.MemPool`` made on each of ``cards`` (a pool belongs
    to the device current when it is made), or raise where this PyTorch
    has none."""
    if cards and not (hasattr(torch.cuda, "MemPool")
                      and hasattr(torch.cuda, "use_mem_pool")):
        raise RuntimeError(
            "DecodeGraph.capture: a step over several cards needs "
            "torch.cuda.MemPool and torch.cuda.use_mem_pool, which this "
            "PyTorch lacks; decode with graph=False")
    pools = {}
    for d in cards:
        with torch.cuda.device(d):
            pools[d] = torch.cuda.MemPool()
    return pools


@contextlib.contextmanager
def _current(sides: dict, dev: torch.device):
    """Each card's side stream made current on its card, ``dev`` the
    current device."""
    with contextlib.ExitStack() as stack:
        for d, side in sides.items():
            if d != dev:
                stack.enter_context(torch.cuda.stream(side))
        stack.enter_context(torch.cuda.stream(sides[dev]))
        yield


def _captures(dev: torch.device) -> bool:
    """Whether ``generate`` captures its decode step: on a CUDA device."""
    return dev.type == "cuda"


def generate(params, prompt, cfg: ModelConfig, max_new: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             fused: bool = False, graph: bool = True):
    """prompt [B, Tp] -> generated [B, max_new] (int64), on the device the
    parameters live on; the cache holds exactly Tp + max_new positions.
    Greedy at ``temperature=0``; otherwise sampled from ``generator`` (a
    ``torch.Generator`` on that device; seeded 0 when None).

    After the prefill, the max_new - 1 decode steps run as ``DecodeGraph``
    steps: on a CUDA device one captured step replayed max_new - 1 times
    (over every card, for parameters placed on several), on the CPU the
    static step eagerly.  ``graph=False`` runs the eager loop of
    ``decode_step`` instead."""
    if top_k is not None and not 1 <= top_k <= cfg.vocab:
        raise ValueError(
            f"top_k must be in [1, vocab={cfg.vocab}], got {top_k}")
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev)
    B, Tp = prompt.shape
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    places = _places(params)
    cache = init_kv_cache(cfg, B, Tp + max_new, tp_size(params), device=dev,
                          devices=None if places is None else places.devices)
    logits, cache = prefill(params, prompt, cache, cfg, fused=fused)
    if max_new == 0:
        return torch.empty((B, 0), dtype=torch.int64, device=dev)
    toks = [_select(logits[:, -1], generator, temperature, top_k)]
    if not graph:
        for _ in range(max_new - 1):
            lg, cache = decode_step(params, toks[-1], cache, cfg,
                                    fused=fused)
            toks.append(_select(lg, generator, temperature, top_k))
        return torch.stack(toks, dim=1)
    if max_new > 1:
        stepper = DecodeGraph(params, cache, cfg, toks[0], fused=fused,
                              temperature=temperature, top_k=top_k,
                              generator=generator)
        if _captures(dev):
            stepper.capture()
        advance = stepper.step if stepper.graph is None else stepper.replay
        for _ in range(max_new - 1):
            advance()
            toks.append(stepper.token.clone())
    return torch.stack(toks, dim=1)
