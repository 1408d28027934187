"""Attention across sequence shards, and the dense reference.

Port of the dense half of ``accl_tpu/parallel/ring_attention.py``:
``expand_gqa_kv`` and ``_dense_attention``, the reference path of the
model's ``forward``.  The sequence-parallel schedules (ring, zigzag,
windowed and Ulysses attention over ``flash_attention_lse``) come with
the sequence-parallel slice; until then they raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..constants import ACCLError

NEG_INF = -1e30


def expand_gqa_kv(k, v, n_q_heads: int):
    """Grouped K/V [B, T, G, D] -> one head per q head, each K/V head
    repeated across its consecutive group (q head n reads K/V head
    n // (H / G), the flash kernels' row sharing)."""
    group = n_q_heads // k.shape[2]
    if group == 1:
        return k, v
    return (k.repeat_interleave(group, dim=2),
            v.repeat_interleave(group, dim=2))


def _dense_attention(q, k, v, causal: bool = False,
                     window: Optional[int] = None):
    """Reference dense attention on [B, T, H, D] with float32
    accumulation; ``window`` (causal) keeps each row's trailing
    ``window`` columns."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))  # float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        T = q.shape[1]
        qpos = torch.arange(T, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        keep = qpos >= kpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def ring_attention(*args, **kwargs):
    """Not ported yet: it comes with sequence parallelism."""
    raise ACCLError("ring_attention is not part of accl_tpu_torch yet (it "
                    "comes with sequence parallelism)")


def ulysses_attention(*args, **kwargs):
    """Not ported yet: it comes with sequence parallelism."""
    raise ACCLError("ulysses_attention is not part of accl_tpu_torch yet "
                    "(it comes with sequence parallelism)")
