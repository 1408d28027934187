"""The flagship transformer LM: forward, loss and the train step.

Port of ``accl_tpu/models/transformer.py``.  Tensor parallelism runs over
P ranks held as lists (the convention of ``ops/fused.py``): the head and
hidden shards of each block (q/k/v, attention, ``wo``, ``w1``, ``w3``,
``w2``) are one tensor per rank, split as ``param_specs`` says.  The
values JAX replicates over the ``tp`` axis (the residual stream, the
norms, the embedding and the logits) are held once.  The row-parallel
combine after the attention-out and MLP-down projections is the sum over
the rank list (``lax.psum``'s role), or with ``fused=True`` the pipelined
``ops.fused.fused_matmul_allreduce``.  The projections are
``torch.matmul``, as the JAX package leaves them to XLA.

Parameters are a plain dict in the JAX pytree's layout, the sharded
leaves replaced by rank lists (``shard_params``).  ``attn="flash"`` runs
the flash kernels of ``ops/flash.py``, backward included; ``attn="dense"``
the dense reference.  ``remat`` checkpoints each block.

Training (``make_train_step``) holds the parameters once for all data
members: each member's local ``(loss_sum, count)`` is backpropagated in
turn, and autograd's accumulation into the shared leaves sums the
replicated gradients over the members, the role JAX's replication-aware
transpose plays; the tp-sharded leaves keep per-shard gradients.  The SGD
update is applied in place.  Sequence parallelism comes in a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..constants import ACCLError
from ..ops.flash import flash_attention
from ..ops.fused import fused_chunks, fused_matmul_allreduce
from ..parallel.collectives import all_reduce
from ..parallel.ring_attention import _dense_attention, expand_gqa_kv
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class ModelConfig:
    """The JAX package's ModelConfig, with the same fields, defaults and
    validation.  ``sp_schedule`` matters only to the slice that ports
    sequence parallelism."""

    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: Optional[int] = None
    d_head: int = 32
    d_ff: int = 512
    dtype: str = "float32"
    attn: str = "dense"
    sp_schedule: str = "contiguous"
    attn_window: Optional[int] = None
    mlp: str = "gelu"
    rope: bool = False
    rope_theta: float = 10000.0
    remat: bool = False

    def __post_init__(self):
        if self.attn not in ("dense", "flash"):
            raise ValueError(f"unknown attn implementation {self.attn!r}")
        if self.sp_schedule not in ("contiguous", "zigzag"):
            raise ValueError(f"unknown sp schedule {self.sp_schedule!r}")
        if self.n_kv_heads is not None and (
                self.n_kv_heads <= 0
                or self.n_heads % self.n_kv_heads != 0):
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must divide "
                f"n_heads={self.n_heads}")
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(f"attn_window={self.attn_window} must be "
                             f">= 1")
        if self.mlp not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp flavor {self.mlp!r}")
        if self.rope and self.d_head % 2 != 0:
            raise ValueError(
                f"rope rotates feature PAIRS; d_head={self.d_head} "
                f"must be even")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def param_specs(cfg: ModelConfig) -> dict:
    """Per leaf, the axis split over the tp ranks (None = replicated): the
    positions of ``tp`` in the JAX package's PartitionSpecs."""
    block = {"ln1": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0, "ln2": None,
             "w1": 1, "w2": 0}
    if cfg.mlp == "swiglu":
        block["w3"] = 1
    return {"embed": None, "ln_f": None,
            "blocks": [dict(block) for _ in range(cfg.n_layers)]}


def tp_size(params: dict) -> int:
    """The number of tensor-parallel ranks ``params`` is split over."""
    return len(params["blocks"][0]["wq"]) if params["blocks"] else 1


def shard_params(params: dict, cfg: ModelConfig, tp: int) -> dict:
    """Split ``params`` over ``tp`` ranks: each sharded leaf becomes a list
    of ``tp`` contiguous tensors (rank r holds the r-th slice of its
    split axis), replicated leaves stay single.  ``params`` may be the
    full layout (tensors everywhere) or already split over any rank
    count.  tp must divide n_kv_heads, as ``shard_params`` requires in
    the JAX package."""
    if cfg.kv_heads % tp != 0:
        raise ValueError(
            f"tensor-parallel extent {tp} must divide "
            f"n_kv_heads={cfg.kv_heads} (the grouped K/V "
            f"projections shard their head axis over 'tp')")
    if cfg.d_ff % tp != 0:
        raise ValueError(f"tensor-parallel extent {tp} must divide "
                         f"d_ff={cfg.d_ff}")

    def split(leaf, axis):
        if axis is None:
            return leaf
        full = leaf
        if isinstance(leaf, list):
            full = leaf[0] if len(leaf) == 1 else torch.cat(leaf, dim=axis)
        if tp == 1:
            return [full]
        return [c.contiguous() for c in torch.chunk(full, tp, dim=axis)]

    specs = param_specs(cfg)
    return {
        "embed": params["embed"],
        "ln_f": params["ln_f"],
        "blocks": [{k: split(blk[k], spec[k]) for k in spec}
                   for blk, spec in zip(params["blocks"], specs["blocks"])],
    }


def init_params(rng, cfg: ModelConfig, tp: int = 1, device="cuda") -> dict:
    """Parameters split over ``tp`` ranks, in the JAX package's draw
    order.  ``rng`` a ``numpy.random.Generator``: the JAX package's
    numbers (the same seed gives the same weights), drawn on the host;
    ``rng`` a ``torch.Generator`` on ``device``: drawn there, at the same
    0.02 scale (the way to make a full-width model on the card)."""
    dev = resolve_device(device, "init_params")

    def g(*shape, scale=0.02):
        if isinstance(rng, np.random.Generator):
            draw = rng.standard_normal(shape) * scale
            return torch.from_numpy(draw.astype(np.float32)).to(dev)
        return torch.randn(shape, generator=rng, device=dev) * scale

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    D, H, Dh, Fd = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    G = cfg.kv_heads
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {"ln1": ones(D)}
        blk["wq"] = g(D, H, Dh)
        blk["wk"] = g(D, G, Dh)
        blk["wv"] = g(D, G, Dh)
        blk["wo"] = g(H, Dh, D)
        blk["ln2"] = ones(D)
        blk["w1"] = g(D, Fd)
        blk["w2"] = g(Fd, D)
        if cfg.mlp == "swiglu":
            blk["w3"] = g(D, Fd)
        blocks.append(blk)
    params = {"embed": g(cfg.vocab, D), "blocks": blocks, "ln_f": ones(D)}
    return shard_params(params, cfg, tp)


def _mm(a, b):
    """a @ b with jnp's type promotion (einsum promotes mixed operands)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _rmsnorm(x, scale):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _rope(x, positions, theta: float):
    """Rotary position embedding on [B, T, h, Dh]: feature pairs (i, i +
    Dh/2) rotated by position-dependent angles, in float32, cast back."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _global_positions(Tl: int, device) -> torch.Tensor:
    """Token positions of the local sequence: without sequence
    parallelism, 0..Tl-1."""
    return torch.arange(Tl, device=device)


def block_qkv(h, blk, cfg: ModelConfig, positions):
    """Per-rank q/k/v projections of one block's normed input [B, T, D]
    (+ RoPE when ``positions`` is given): lists of [B, T, h_r, Dh]."""
    B, T, D = h.shape
    dt = cfg.tdtype
    qs, ks, vs = [], [], []
    for wq, wk, wv in zip(blk["wq"], blk["wk"], blk["wv"]):
        q = _mm(h, wq.to(dt).reshape(D, -1)).reshape(B, T, wq.shape[1], -1)
        k = _mm(h, wk.to(dt).reshape(D, -1)).reshape(B, T, wk.shape[1], -1)
        v = _mm(h, wv.to(dt).reshape(D, -1)).reshape(B, T, wv.shape[1], -1)
        if positions is not None:
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    return qs, ks, vs


def _fused_row_combine(hs, ws, out_shape, dtype):
    """The fused lane of the row-parallel projections: sum_r hs[r] @ ws[r]
    through the pipelined ``fused_matmul_allreduce`` (chunked ring, plain
    matmuls), as the JAX package's ``_fused_row_combine``."""
    out = fused_matmul_allreduce(hs, ws, use_pallas=False,
                                 chunks=fused_chunks())[0]
    return out.reshape(out_shape).to(dtype)


def block_attn_out(x, attn, blk, cfg: ModelConfig, fused: bool = False):
    """Attention-out projection of the per-rank attention [B, T, h_r, Dh],
    the row-parallel combine over the ranks, and the residual."""
    dt = cfg.tdtype
    wo = [w.to(dt) for w in blk["wo"]]
    B, T = x.shape[0], x.shape[1]
    if fused and len(wo) > 1:
        hs = [a.reshape(B * T, -1) for a in attn]
        ws = [w.reshape(-1, w.shape[-1]) for w in wo]
        return x + _fused_row_combine(hs, ws, (B, T, wo[0].shape[-1]), dt)
    parts = [_mm(a.reshape(B, T, -1), w.reshape(-1, w.shape[-1]))
             for a, w in zip(attn, wo)]
    return x + all_reduce(parts)[0]


def block_mlp(x, blk, cfg: ModelConfig, fused: bool = False):
    """Post-attention MLP (gelu or swiglu) per rank over its hidden shard,
    the row-parallel combine, and the residual."""
    dt = cfg.tdtype
    h = _rmsnorm(x, blk["ln2"])
    ms = []
    for r, w1 in enumerate(blk["w1"]):
        m = _mm(h, w1.to(dt))
        if cfg.mlp == "swiglu":
            m = F.silu(m) * _mm(h, blk["w3"][r].to(dt))
        else:
            m = F.gelu(m, approximate="tanh")
        ms.append(m)
    w2 = [w.to(dt) for w in blk["w2"]]
    B, T = x.shape[0], x.shape[1]
    if fused and len(w2) > 1:
        hs = [m.reshape(B * T, -1) for m in ms]
        return x + _fused_row_combine(hs, w2, (B, T, w2[0].shape[-1]), dt)
    return x + all_reduce([_mm(m, w) for m, w in zip(ms, w2)])[0]


def _local_attention(q, k, v, cfg: ModelConfig):
    """One rank's causal attention over its heads [B, T, h_r, Dh]."""
    if cfg.attn == "flash":
        # the matmul input format follows the activations: bf16 stays on
        # the fast format, float32 keeps exact float32 numerics
        mxu = q.dtype if q.dtype in (torch.bfloat16, torch.float16) \
            else torch.float32
        return flash_attention(q, k, v, causal=True, mxu_dtype=mxu,
                               window=cfg.attn_window)
    if k.shape[2] != q.shape[2]:
        k, v = expand_gqa_kv(k, v, q.shape[2])
    return _dense_attention(q, k, v, causal=True, window=cfg.attn_window)


def _no_sp(sp: int) -> None:
    if sp > 1:
        raise ACCLError("sequence parallelism needs ring_attention "
                        "(accl_tpu/parallel/ring_attention.py), which is "
                        "not part of accl_tpu_torch yet")


def _block(x, blk, cfg: ModelConfig, rope_pos, fused: bool):
    """One transformer block on the residual stream [B, T, D]."""
    h = _rmsnorm(x, blk["ln1"])
    qs, ks, vs = block_qkv(h, blk, cfg, rope_pos)
    attn = [_local_attention(q, k, v, cfg) for q, k, v in zip(qs, ks, vs)]
    x = block_attn_out(x, attn, blk, cfg, fused=fused)
    return block_mlp(x, blk, cfg, fused=fused)


def forward(params, tokens, cfg: ModelConfig, fused: bool = False,
            sp: int = 1):
    """Token ids [B, T] -> logits [B, T, vocab], tensor-parallel over the
    ranks ``params`` is split over (``shard_params``), on the device the
    parameters live on.  ``fused=True`` pipelines the row-parallel
    combines (the fused lane; no effect at tp = 1).  With ``cfg.remat``
    each block is recomputed on the backward pass
    (``torch.utils.checkpoint``, ``jax.checkpoint``'s role): only the
    block inputs stay live across layers.  ``sp`` > 1 needs ring
    attention, not ported yet."""
    _no_sp(sp)
    if cfg.sp_schedule == "zigzag":
        raise ValueError("sp_schedule='zigzag' requires an sp axis "
                         "(tokens are in zigzag order)")
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    x = embed[tokens].to(cfg.tdtype)
    rope_pos = (_global_positions(tokens.shape[1], embed.device)
                if cfg.rope else None)
    for blk in params["blocks"]:
        if cfg.remat:
            x = checkpoint(_block, x, blk, cfg, rope_pos, fused,
                           use_reentrant=False)
        else:
            x = _block(x, blk, cfg, rope_pos, fused)
    x = _rmsnorm(x, params["ln_f"])
    return _mm(x, embed.to(cfg.tdtype).t())


def loss_fn(params, tokens, cfg: ModelConfig, fused: bool = False,
            sp: int = 1):
    """Next-token cross entropy on [B, T] tokens: the last position has no
    label and is masked.  Returns (sum_loss, count), float32 scalars local
    to the caller (the sum-and-count discipline).  ``sp`` > 1 needs ring
    attention, not ported yet."""
    _no_sp(sp)
    logits = forward(params, tokens, cfg, fused=fused).float()
    tokens = torch.as_tensor(tokens, device=logits.device).long()
    B, Tl = tokens.shape
    labels = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    valid = torch.ones((B, Tl), dtype=torch.bool, device=logits.device)
    valid[:, -1] = False
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return torch.sum(nll), torch.sum(valid.float())


def _mean_grads(loss_closures: Sequence[Callable], params):
    """Mean gradients for loss closures returning a LOCAL ``(loss_sum,
    count)`` pair, one closure per data-parallel member (the
    sum-and-count discipline of the JAX package's ``_mean_grads``).

    Each member's loss_sum is backpropagated into the shared leaves in
    turn, so a leaf's gradient is the sum over the members (JAX's psum
    of replicated gradients) and a tp-sharded leaf keeps its shard's.
    The counts and losses sum over the members; gradients are divided by
    the total.  Returns ``(g_mean, mean_loss)``, g_mean in ``params``'s
    structure; the leaves are left without gradients."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    total = loss_tot = None
    try:
        for closure in loss_closures:
            loss_sum, count = closure(params)
            loss_sum.backward()
            loss_sum, count = loss_sum.detach(), count.detach()
            total = count if total is None else total + count
            loss_tot = loss_sum if loss_tot is None else loss_tot + loss_sum
        denom = torch.clamp_min(total, 1.0)
        grads = {id(p): (p.grad.div_(denom) if p.grad is not None
                         else torch.zeros_like(p)) for p in leaves}
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    return tree_map(lambda p: grads[id(p)], params), loss_tot / denom


def sum_count_device_step(loss_closures: Sequence[Callable], params,
                          lr: float):
    """Plain SGD over :func:`_mean_grads`: p - lr g_mean for every leaf,
    in place (the parameters are updated, not copied).  Returns
    ``(params, mean_loss)``."""
    g_mean, mean_loss = _mean_grads(loss_closures, params)
    with torch.no_grad():
        for p, g in zip(tree_leaves(params), tree_leaves(g_mean)):
            p.sub_(g.mul_(lr))
    return params, mean_loss


def make_train_step(mesh, cfg: ModelConfig, lr: float = 1e-3,
                    dp: Optional[str] = "dp", tp: Optional[str] = "tp",
                    sp: Optional[str] = "sp", optimizer=None, params=None,
                    check_vma: Optional[bool] = None, fused: bool = False):
    """The train step over ``mesh`` (a ``parallel.mesh.RankMesh``), plain
    SGD at ``lr``.  Returns ``(step_fn, (param_specs, token_spec))`` with
    ``step_fn(params, tokens) -> (params, mean_loss)``: the token batch
    [B, T] split over the ``dp`` members (B divisible by dp), each
    member's ``loss_fn`` over the tp rank lists, the mean gradient as
    ``_mean_grads`` forms it, and the update applied to ``params`` in
    place.  ``params`` must be split over the mesh's tp extent
    (``shard_params``) and live on its device.  ``token_spec`` names the
    axes the token dimensions split over, as ``P(dp, sp)``.

    Axes not in the mesh are dropped.  An sp extent above 1 needs ring
    attention (raises); ``optimizer`` (optax) raises; ``check_vma`` is
    accepted and changes nothing."""
    if optimizer is not None:
        raise ACCLError("make_train_step(optimizer=...): the optax optimizer "
                        "path is not part of accl_tpu_torch (the card has no "
                        "optax); plain SGD only")
    shape = mesh.shape
    dp = dp if dp in shape else None
    tp = tp if tp in shape else None
    sp = sp if sp in shape else None
    if cfg.sp_schedule == "zigzag" and sp is None:
        raise ValueError("ModelConfig(sp_schedule='zigzag') needs an 'sp' "
                         "axis in the mesh — zigzag-ordered tokens train "
                         "on wrong labels without the zigzag ring")
    n_dp = shape[dp] if dp else 1
    n_tp = shape[tp] if tp else 1
    _no_sp(shape[sp] if sp else 1)

    def step_fn(params, tokens):
        if tp_size(params) != n_tp:
            raise ValueError(f"params are split over {tp_size(params)} tp "
                             f"ranks, the mesh has {n_tp}")
        if params["embed"].device != mesh.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"mesh on {mesh.device}")
        tokens = torch.as_tensor(tokens, device=mesh.device)
        B = tokens.shape[0]
        if B % n_dp:
            raise ValueError(f"batch {B} does not split over {n_dp} dp "
                             f"members")
        b = B // n_dp
        closures = [
            (lambda p, t=tokens[d * b:(d + 1) * b]:
             loss_fn(p, t, cfg, fused=fused)) for d in range(n_dp)]
        return sum_count_device_step(closures, params, lr)

    return step_fn, (param_specs(cfg), (dp, sp))
