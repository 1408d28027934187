"""Fused compute/communication: chunked ring pipelines and the
tensor-parallel matmul whose partial products are reduce-scattered
around the ring.

Port of ``accl_tpu/ops/fused.py``, in its three tiers, over P ranks held
as separate tensors (every function takes a list with one tensor per
rank, in ring order, and returns one per rank):

1. ``chunked_ring_*`` — the driver's fused lane (``ACCL_FUSED=1`` or
   per-call ``fused=``).  The flat payload splits into C independent
   per-chunk ring chains.  The fp32 fold is the ring's, ``local +
   incoming`` with chunk ``(my - 2 - step) % P`` at step ``step``, so the
   lane is bitwise equal to the ring lane whenever the payload divides
   P*C and the ring runs as one segment.  ``wire=(block, error_feedback)``
   runs the int8 quantize/dequantize of ``ops/quantized.py`` inside the
   chunk loop.  These are jnp in the JAX package, not Pallas, so here
   they are torch ops.

2. ``fused_matmul_allreduce`` — allreduce-into-matmul: with ``chunks=C``
   the reduce-scatter computes each local partial product just in time
   and the all-gather relays reduced product rows.  ``pallas_matmul`` is
   its compute half: the hand-written CUDA kernel ``accl_matmul``
   (``csrc/fused.cu``) on the card, launched under ``matmul_plan``
   (tile rows and split of K from the shape and the card's SM count).

3. ``fused_matmul_reduce_scatter`` — the hand-scheduled kernel
   ``accl_fused_matmul_rs`` (``csrc/fused.cu``): the ring reduce-scatter
   of sum_r x_r @ w_r with each hop's partial matmul inside the ring
   loop.  ``fused_matmul_allreduce_pallas`` is that kernel followed by
   the ring all-gather kernel of ``ops/ring.py``.

Beside each kernel wrapper sits its plain PyTorch version.  A wrapper
runs the plain version only when it is given CPU tensors; given CUDA
tensors it launches its kernel or raises.  Each wrapper counts its
launches in its ``launches`` attribute.  The plain versions multiply
with ``torch.matmul`` in float32, which on the card is a full fp32
product only while ``torch.backends.cuda.matmul.allow_tf32`` is False
(PyTorch's default); the kernels never use TF32.

Not ported here: ``fused_expert_ffn`` (it comes with the MoE model
layer) and the device-trace stamp rows (with observability).
"""
from __future__ import annotations

import functools
import os
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from ..constants import ACCLError
from . import _build
from . import quantized as q_ops
from .ring import _fold, _ptrs, ring_all_gather

#: default pipeline depth of the fused lane — chunks per ring step
DEFAULT_FUSED_CHUNKS = 4

#: ACCL_FUSED_CHUNKS, read once (None = not read yet), so the chunking
#: stays stable across calls
_FUSED_CHUNKS: Optional[int] = None


def fused_chunks() -> int:
    """The ``ACCL_FUSED_CHUNKS`` pipeline depth, cached at first use."""
    global _FUSED_CHUNKS
    if _FUSED_CHUNKS is None:
        try:
            _FUSED_CHUNKS = max(1, int(os.environ.get(
                "ACCL_FUSED_CHUNKS", str(DEFAULT_FUSED_CHUNKS))))
        except ValueError:
            _FUSED_CHUNKS = DEFAULT_FUSED_CHUNKS
    return _FUSED_CHUNKS


def _reset_fused_chunks_cache() -> None:
    """Test hook: force the next call to re-read the env."""
    global _FUSED_CHUNKS
    _FUSED_CHUNKS = None


def _pick_chunks(n: int, requested: Optional[int]) -> int:
    """Largest chunk count <= requested that divides n (>= 1)."""
    c = max(1, min(requested or fused_chunks(), n))
    while n % c:
        c -= 1
    return c


def _pad_flat(x: torch.Tensor, length: int) -> torch.Tensor:
    if x.shape[0] == length:
        return x
    return torch.cat([x, x.new_zeros((length - x.shape[0],) + x.shape[1:])])


# ---------------------------------------------------------------------------
# tier 1: chunked ring collectives — the driver's fused lane
# ---------------------------------------------------------------------------
def _rs_chains_fp(views, op: str, P: int, C: int) -> list:
    """C reduce-scatter chains per rank over views[r] [P, C, m]; returns
    rank r's list of C reduced accumulators."""
    fold = _fold(op)
    accs = [[views[r][(r - 1) % P, c] for c in range(C)] for r in range(P)]
    for s in range(P - 1):
        landed = [accs[(r - 1) % P] for r in range(P)]
        # local + incoming: the ring's fold order
        accs = [[fold(views[r][(r - 2 - s) % P, c], landed[r][c])
                 for c in range(C)] for r in range(P)]
    return accs


def _rs_chains_q(views, C: int, block: int, error_feedback: bool) -> list:
    """C quantized reduce-scatter chains over views[r] [P, C, m]: chunk c
    is one ring of ops/quantized.py over the ranks' [P, m] slices.
    Returns, per chunk, the ranks' wire-form (q, scale) carries, the seam
    feed for the gather."""
    return [q_ops._ring_reduce_scatter_q([v[:, c].reshape(-1) for v in views],
                                         block, error_feedback)[0]
            for c in range(C)]


def _ag_chains(parts) -> torch.Tensor:
    """C all-gather chains: parts[r] is rank r's list of C per-chunk
    tensors; the result is [P, C, ...] with origin-major placement.  The
    relay moves values unchanged, so every rank ends with this same
    tensor whatever the hop order: it is built once and shared."""
    return torch.stack([torch.stack(list(row)) for row in parts])


def _deq_gathered(per_chunk, m: int) -> torch.Tensor:
    """Gather each chunk's wire-form carries and dequantize once -> flat
    [P * C * m] (origin-major, then chunk)."""
    P = len(per_chunk[0])
    return torch.stack([q_ops._ring_all_gather_q(carries, m)[0].view(P, m)
                        for carries in per_chunk], dim=1).reshape(-1)


def chunked_ring_reduce_scatter(xs: Sequence[torch.Tensor], op: str = "sum",
                                chunks: Optional[int] = None,
                                wire: Optional[tuple] = None) -> list:
    """Per rank flat [P * n] -> that rank's reduced [n], as C per-chunk
    ring chains.  ``wire=(block, error_feedback)`` rides the int8 wire
    with per-hop requantization inside the loop."""
    P = len(xs)
    if P == 1:
        return list(xs)
    N = xs[0].shape[0]
    if N % P:
        raise ValueError(f"fused reduce-scatter needs the payload ({N}) "
                         f"divisible by the ring size ({P})")
    n = N // P
    C = _pick_chunks(n, chunks)
    m = n // C
    if wire is not None:
        if op == "max":
            raise ValueError("int8 wire lane carries sums, not max")
        block, ef = wire
        views = [x.to(torch.float32).reshape(P, C, m) for x in xs]
        per_chunk = _rs_chains_q(views, C, block, ef)
        return [torch.cat([q_ops.dequantize_blockwise(*chunk[r], m)
                           for chunk in per_chunk]) for r in range(P)]
    views = [x.reshape(P, C, m) for x in xs]
    return [torch.cat(row) for row in _rs_chains_fp(views, op, P, C)]


def chunked_ring_all_gather(xs: Sequence[torch.Tensor],
                            chunks: Optional[int] = None,
                            wire: Optional[tuple] = None) -> list:
    """Per rank flat [n] -> [P * n] (rank-major), as C per-chunk relay
    chains.  On the int8 lane each contribution is quantized once and
    relayed in wire form."""
    P = len(xs)
    if P == 1:
        return list(xs)
    n = xs[0].shape[0]
    C = _pick_chunks(n, chunks)
    m = n // C
    if wire is not None:
        block = wire[0]
        rows = [x.to(torch.float32).reshape(C, m) for x in xs]
        per_chunk = [[q_ops.quantize_blockwise(v, block)[:2] for v in col]
                     for col in zip(*rows)]
        return [_deq_gathered(per_chunk, m)] * P
    out = _ag_chains([list(x.reshape(C, m)) for x in xs]).reshape(-1)
    return [out] * P


def chunked_ring_all_reduce(xs: Sequence[torch.Tensor], op: str = "sum",
                            chunks: Optional[int] = None,
                            wire: Optional[tuple] = None) -> list:
    """Per rank flat [N] -> [N] allreduced: chunked reduce-scatter
    feeding chunked all-gather, padded internally to a P*C multiple; on
    the int8 lane the wire-form carry crosses the seam without a
    dequantize/requantize round."""
    P = len(xs)
    if P == 1:
        return list(xs)
    N = xs[0].shape[0]
    C = max(1, chunks or fused_chunks())
    padN = -(-N // (P * C)) * (P * C)
    m = padN // P // C
    if wire is not None:
        if op == "max":
            raise ValueError("int8 wire lane carries sums, not max")
        block, ef = wire
        views = [_pad_flat(x, padN).to(torch.float32).reshape(P, C, m)
                 for x in xs]
        out = _deq_gathered(_rs_chains_q(views, C, block, ef), m)[:N]
        if xs[0].is_floating_point():
            out = out.to(xs[0].dtype)
        return [out] * P
    views = [_pad_flat(x, padN).reshape(P, C, m) for x in xs]
    parts = _rs_chains_fp(views, op, P, C)
    return [_ag_chains(parts).reshape(-1)[:N]] * P


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------
#: input dtypes the CUDA kernels take, with their code in csrc/fused.cu
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: ranks one fused launch can hold (MAXP in csrc/ring_sync.cuh)
MAX_RANKS = 32
#: the tile geometry of csrc/fused.cu: output tile columns (BN), k per
#: pipeline stage (BK), the fused kernel's tile rows (FUSED_BM) and the
#: row counts accl_matmul is built for, largest first
TILE_N = 128
TILE_K = 16
FUSED_TILE_M = 128
TILE_MS = (128, 64)
#: blocks of accl_matmul that one SM holds (__launch_bounds__(256, 2), at
#: most 64 KB of shared memory each; the fused kernel holds one per SM)
BLOCKS_PER_SM = 2
#: the most ranges K is split into, and the fewest TILE_K slices in one
MAX_SPLIT = 16
MIN_SPLIT_SLICES = 4


class MatmulPlan(NamedTuple):
    """One ``accl_matmul`` launch: output tiles of ``bm`` x TILE_N, a grid
    of (tiles along n, tiles along m, ``split``) blocks, block z taking k
    in [z k_per_split, (z + 1) k_per_split) (the last range is cut at
    k).  A split tile's partials are summed in the order z = 0, 1, ...."""
    bm: int
    split: int
    k_per_split: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def matmul_plan(m: int, n: int, k: int, sms: int) -> MatmulPlan:
    """Tile rows and split of K for ``[m, k] @ [k, n]`` on a card of
    ``sms`` SMs.  128-row tiles when they alone give every SM a block;
    else 64-row tiles, and when those are still fewer than the SMs, K is
    split so that tiles x split fills the BLOCKS_PER_SM blocks every SM
    holds without starting a second wave (each range at least
    MIN_SPLIT_SLICES slices of TILE_K, at most MAX_SPLIT ranges).  At
    [128, 1792] @ [1792, 4096] on 132 SMs: 64 tiles of 64 x 128, K split
    in 4 ranges of 448, 256 blocks."""
    tiles_n = _cdiv(n, TILE_N)
    big, small = TILE_MS
    bm = big if _cdiv(m, big) * tiles_n >= sms else small
    tiles = max(1, _cdiv(m, bm) * tiles_n)
    slices = _cdiv(k, TILE_K)
    split = 1
    if tiles < sms:
        split = max(1, min(sms * BLOCKS_PER_SM // tiles,
                           slices // MIN_SPLIT_SLICES, MAX_SPLIT))
    per = max(1, _cdiv(slices, split))
    return MatmulPlan(bm, max(1, _cdiv(slices, per)), per * TILE_K)


def stripe_tiles(tiles: int, stripes: int, st: int) -> tuple:
    """[first, last) of the row-major FUSED_TILE_M x TILE_N output tiles
    that stripe ``st`` of the fused kernel owns on every rank."""
    return st * tiles // stripes, (st + 1) * tiles // stripes


def fused_stripes(P: int, tiles: int, resident: int) -> int:
    """Tile stripes per rank of one fused launch: as many as fit
    co-resident (``resident`` blocks over P ranks), at most one per
    output tile, so that every stripe holds a tile."""
    fit = resident // P
    if fit < 1:
        raise RuntimeError(f"fused matmul kernel: {P} ranks do not fit "
                           f"co-resident on this card")
    return min(fit, max(1, tiles))


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.accl_fused_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _check_operands(ts, what: str) -> None:
    dev, dt = ts[0].device, ts[0].dtype
    for t in ts:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{what}: every tensor must share device {dev} "
                             f"and dtype {dt}, got {t.device} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {dev} (cpu or cuda only)")
    if dev.type == "cuda" and dt not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the CUDA kernel takes float32 or "
                         f"bfloat16, not {dt}")


def _vec(ts, k: int, n: int, elem: int) -> bool:
    """Whether the kernels may move 16 bytes at a time: every row of
    every operand and result starts on 16 bytes."""
    v = 16 // elem
    return k % v == 0 and n % v == 0 and all(t.data_ptr() % 16 == 0
                                             for t in ts)


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan(m: int, n: int, k: int, device: int) -> MatmulPlan:
    return matmul_plan(m, n, k, _sms(device))


@functools.lru_cache(maxsize=None)
def _resident(dtype_code: int, device: int) -> int:
    """Blocks of the fused kernel that fit on the card together (cached
    per device and dtype)."""
    lib = _build.load("fused")
    got = lib.accl_fused_resident(dtype_code, device)
    if got < 0:
        _raise_on(lib, -got, "accl_fused_resident")
    return got


_scratch_lock = threading.Lock()
#: (device, stream, name) -> scratch tensor, reused in stream order: the
#: split-K partials ("ws", float32) and the split-K counters and ring
#: flags ("counters", "flags", int32, which the kernels leave at zero)
_scratch: dict = {}


def _scratch_for(dev: torch.device, stream, name: str, numel: int):
    key = (dev.index, stream.cuda_stream, name)
    with _scratch_lock:
        cur = _scratch.get(key)
        if cur is None or cur.numel() < numel:
            if name == "ws":
                cur = torch.empty(numel, dtype=torch.float32, device=dev)
            else:
                cur = torch.zeros(numel, dtype=torch.int32, device=dev)
            _scratch[key] = cur
        return cur


# ---------------------------------------------------------------------------
# tier 2: matmul and allreduce-into-matmul
# ---------------------------------------------------------------------------
def pallas_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[m, k] @ [k, n] -> [m, n] float32, through torch.matmul."""
    return x.float() @ w.float()


def pallas_matmul(x: torch.Tensor, w: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[m, k] @ [k, n] -> [m, n] float32, with fp32 accumulation; x and w
    both float32 or both bfloat16.  On the card: the ``accl_matmul``
    kernel of csrc/fused.cu."""
    _check_operands([x, w], "pallas_matmul")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"pallas_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    m, k = x.shape
    n = w.shape[1]
    if out is not None and (tuple(out.shape) != (m, n)
                            or out.dtype != torch.float32
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"pallas_matmul: out must be contiguous float32 "
                         f"[{m}, {n}] on {x.device}")
    if x.device.type == "cpu":
        res = pallas_matmul_plain(x, w)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    dev = x.device
    device = dev.index or 0
    plan = _plan(m, n, k, device)
    stream = torch.cuda.current_stream(dev)
    ws = counters = None
    if plan.split > 1:
        ws = _scratch_for(dev, stream, "ws", plan.split * m * n).data_ptr()
        counters = _scratch_for(dev, stream, "counters",
                                _cdiv(m, plan.bm) * _cdiv(n, TILE_N)
                                ).data_ptr()
    lib = _build.load("fused")
    rc = lib.accl_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                         KERNEL_DTYPES[x.dtype], plan.bm, plan.split,
                         plan.k_per_split,
                         int(_vec((x, w, out), k, n, x.element_size())),
                         ws, counters, device, stream.cuda_stream)
    _raise_on(lib, rc, "pallas_matmul")
    pallas_matmul.launches += 1
    return out


pallas_matmul.launches = 0


def fused_matmul_allreduce(xs: Sequence[torch.Tensor],
                           ws: Sequence[torch.Tensor],
                           use_pallas: bool = True,
                           chunks: Optional[int] = None) -> list:
    """Tensor-parallel contraction: rank r holds x_r [M, K] and the
    K-shard w_r [K, N]; every rank gets sum_r x_r @ w_r, [M, N] float32.

    ``chunks=None`` (or <= 1): each rank's matmul, then a sum over the
    ranks (the JAX form's psum).  ``chunks=C``: the pipelined form — the
    reduce-scatter computes each local row-block partial just in time and
    folds ``partial + incoming``, then the all-gather relays the reduced
    product rows; rows are zero-padded to a P*C multiple internally.
    ``use_pallas`` picks the matmul kernel over the plain product."""
    P = len(xs)
    dot = pallas_matmul if use_pallas else pallas_matmul_plain
    if chunks is None or chunks <= 1:
        total = torch.stack([dot(x, w) for x, w in zip(xs, ws)]).sum(0)
        return [total] * P
    if P == 1:
        return [dot(xs[0], ws[0])]
    M, K = xs[0].shape
    N = ws[0].shape[1]
    C = chunks
    padM = -(-M // (P * C)) * (P * C)
    mrows = padM // (P * C)
    xv = [_pad_flat(x, padM).reshape(P, C, mrows, K) for x in xs]
    accs = [[dot(xv[r][(r - 1) % P, c], ws[r]) for c in range(C)]
            for r in range(P)]
    for s in range(P - 1):
        landed = [accs[(r - 1) % P] for r in range(P)]
        accs = [[dot(xv[r][(r - 2 - s) % P, c], ws[r]) + landed[r][c]
                 for c in range(C)] for r in range(P)]
    out = _ag_chains(accs).reshape(padM, N)[:M]
    return [out] * P


# ---------------------------------------------------------------------------
# tier 3: the hand-scheduled fused matmul reduce-scatter
# ---------------------------------------------------------------------------
def fused_matmul_reduce_scatter_plain(xs: Sequence[torch.Tensor],
                                      ws: Sequence[torch.Tensor]) -> list:
    """Per rank x_r [P, m, K] and w_r [K, N] -> that rank's reduced
    [m, N] float32 block, hop by hop: acc starts as x_r[r - 1] @ w_r; at
    hop s the accumulator arrives from the left and acc = x_r[r - 2 - s]
    @ w_r + arrival."""
    P = len(xs)
    acc = [pallas_matmul_plain(xs[r][(r - 1) % P], ws[r]) for r in range(P)]
    for s in range(P - 1):
        landing = [acc[(r - 1) % P] for r in range(P)]
        acc = [pallas_matmul_plain(xs[r][(r - 2 - s) % P], ws[r])
               + landing[r] for r in range(P)]
    return acc


def fused_matmul_reduce_scatter(xs: Sequence[torch.Tensor],
                                ws: Sequence[torch.Tensor],
                                out: Optional[Sequence[torch.Tensor]] = None
                                ) -> list:
    """Ring reduce-scatter of the partial products sum_r x_r @ w_r: rank
    r's x_r [P, m, K] (P row blocks of its activations) and K-shard w_r
    [K, N] -> its reduced [m, N] float32 block (row block r of the sum).
    On the card: one cooperative launch of ``accl_fused_matmul_rs``."""
    P = len(xs)
    if not 1 <= P <= MAX_RANKS or len(ws) != P:
        raise ValueError(f"fused_matmul_reduce_scatter: {P} ranks with "
                         f"{len(ws)} weights (1..{MAX_RANKS} ranks)")
    _check_operands([*xs, *ws], "fused_matmul_reduce_scatter")
    shape = tuple(xs[0].shape)
    if len(shape) != 3 or shape[0] != P:
        raise ValueError(f"fused_matmul_reduce_scatter: x must be [P={P}, "
                         f"m, K], got {shape}")
    _, m, K = shape
    N = ws[0].shape[1] if ws[0].dim() == 2 else -1
    for x, w in zip(xs, ws):
        if tuple(x.shape) != shape or tuple(w.shape) != (K, N):
            raise ValueError(f"fused_matmul_reduce_scatter: every x must be "
                             f"{shape} and every w [{K}, N]")
    if out is not None:
        for o in out:
            if (tuple(o.shape) != (m, N) or o.dtype != torch.float32
                    or o.device != xs[0].device or not o.is_contiguous()):
                raise ValueError(f"fused_matmul_reduce_scatter: outputs must "
                                 f"be contiguous float32 [{m}, {N}]")
    dev = xs[0].device
    if dev.type == "cpu":
        res = fused_matmul_reduce_scatter_plain(xs, ws)
        if out is None:
            return res
        return [o.copy_(r) for o, r in zip(out, res)]
    if P == 1:
        return [pallas_matmul(xs[0][0], ws[0],
                              None if out is None else out[0])]
    if out is None:
        out = [torch.empty((m, N), dtype=torch.float32, device=dev)
               for _ in range(P)]
    if m == 0 or N == 0:
        return list(out)
    dt = KERNEL_DTYPES[xs[0].dtype]
    device = dev.index or 0
    S = fused_stripes(P, _cdiv(m, FUSED_TILE_M) * _cdiv(N, TILE_N),
                      _resident(dt, device))
    stream = torch.cuda.current_stream(dev)
    flags = _scratch_for(dev, stream, "flags", P * S * 4)
    # the landing slots may be freed when this returns, before the kernel
    # ends: the caching allocator hands them out again only to work queued
    # after the kernel on this stream
    landing = torch.empty(P * 2 * m * N, dtype=torch.float32, device=dev)
    vec = _vec([*xs, *ws, *out, landing], K, N, xs[0].element_size())
    lib = _build.load("fused")
    rc = lib.accl_fused_matmul_rs(
        _ptrs(xs), _ptrs(ws), _ptrs(out), m, N, K, P, dt, S, int(vec),
        landing.data_ptr(), flags.data_ptr(), device, stream.cuda_stream)
    _raise_on(lib, rc, "fused_matmul_reduce_scatter")
    fused_matmul_reduce_scatter.launches += 1
    return list(out)


fused_matmul_reduce_scatter.launches = 0


def fused_matmul_allreduce_pallas(xs: Sequence[torch.Tensor],
                                  ws: Sequence[torch.Tensor]) -> list:
    """Allreduce-into-matmul, kernel form: sum_r x_r @ w_r for x_r
    [M, K] (M divisible by P) and K-shards w_r [K, N] — the fused
    reduce-scatter kernel, then the ring all-gather kernel relays the
    reduced product rows.  Every rank gets [M, N] float32."""
    P = len(xs)
    M, K = xs[0].shape
    if P == 1:
        return [pallas_matmul(xs[0], ws[0])]
    if M % P:
        raise ValueError(f"M ({M}) must divide into the ring size ({P}); "
                         f"pad the row dimension")
    m = M // P
    mine = fused_matmul_reduce_scatter([x.view(P, m, K) for x in xs], ws)
    gathered = ring_all_gather([b.view(-1) for b in mine])
    return [g.view(M, ws[0].shape[1]) for g in gathered]


def fused_expert_ffn(*args, **kwargs):
    """Not ported yet: it comes with the MoE model layer."""
    raise ACCLError("fused_expert_ffn is not part of accl_tpu_torch yet "
                    "(it comes with the MoE model layer)")
