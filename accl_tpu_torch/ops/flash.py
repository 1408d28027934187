"""Flash attention, forward and backward.

Port of ``accl_tpu/ops/flash.py``: tiled QK^T -> online softmax -> PV
with the running (max, denominator) carried across K blocks, so the
[Tq, Tk] score matrix never materializes; every entry also yields the
log-sum-exp statistics (natural-log units) that distributed callers fold
partial attentions with.  The entries are differentiable in q, k and v,
through both outputs.

Three schedules, chosen by the JAX package's own rule
(``_resolve_schedule`` with ``_RESIDENT_KV_BYTES``, copied so that both
packages pick the same kernel for the same inputs):

- ``resident``: the K/V row of one packed head walked whole per q block
  (``_flash_kernel_resident``) -> the CUDA kernel ``flash_fwd_resident``;
- ``resident_skew``, only when asked for by name: the resident walk with
  block j+1's QK^T issued before block j's softmax and PV
  (``_flash_kernel_resident_skew``) -> ``flash_fwd_resident_skew``, whose
  out and lse equal ``flash_fwd_resident``'s bit for bit;
- ``grid`` and ``grid_resident``: one fold per (q block, k block) cell,
  with causal live/diagonal predicates and the sliding ``window``
  (``_flash_kernel_grid``) -> the CUDA kernel ``flash_fwd_grid``.

The kernels are in ``csrc/flash.cu``: an fp32 FMA mainloop for the
float32 MXU dtype, one q head per CTA, and a tensor-core (wgmma) one for
bfloat16, ``fwd_heads`` q heads of one GQA group per CTA; every schedule
walks the 64-row tiles of ``fwd_walk``.  The backward (``_flash_backward``)
rebuilds the normalized probabilities per block from the saved lse and
runs two kernels of ``csrc/flash_bwd.cu``, whatever the forward schedule:

- ``flash_bwd_dq`` (``_flash_bwd_dq_kernel``): dQ accumulated over the
  live k blocks of each q block;
- ``flash_bwd_dkv`` (``_flash_bwd_dkv_kernel``): dK and dV accumulated
  over the live q blocks of every q head of each K/V head's group, that
  walk cut into work items by ``bwd_plan`` so that the causal load
  spreads over the card.

Both run an fp32 FMA mainloop for the float32 MXU dtype and a
tensor-core one for bfloat16.

Beside each kernel sits its plain PyTorch version: the Pallas kernel
written block by block, with the same block loops, chunk sub-folds, log2
domain, clamps and casts.  A wrapper runs the plain version only when it
is given CPU tensors; given CUDA tensors it launches its kernel or
raises.  Each wrapper counts its launches in its ``launches`` attribute.

``mxu_dtype`` is the matmul input format, bfloat16 by default even for
float32 inputs (the q product, K, V and the probabilities are rounded to
it; accumulation is always float32); pass ``torch.float32`` for exact
float32 numerics.

What the card honours: the schedule (resident, resident_skew, grid /
grid_resident, one kernel each), ``causal``, ``window``, ``static_max``,
the input and MXU dtypes.  The kernels walk their own 64-row tiles, so
``block_q``, ``block_k``, ``chunk_k``, ``q_tiles``, ``fuse_denom`` and
``kv_cast_scratch`` are validated and resolved as the JAX package does
(and shape the plain versions) but change nothing on the card.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import torch

from . import _build
from .fused import _cdiv, _scratch_for, _sms

NEG_INF = -1e30
_LOG2E = 1.4426950408889634  # log2(e)
_LN2 = 0.6931471805599453    # ln(2)

#: K/V rows larger than this run the grid schedule (the JAX package's
#: residency budget, kept so both packages pick the same kernel)
_RESIDENT_KV_BYTES = 6 << 20
#: auto-schedule defaults applied when q_tiles is None
_AUTO_Q_TILES = 1
_AUTO_CHUNK_K = None

#: input dtypes the CUDA kernels take, with their code in csrc/flash.cu
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes the CUDA kernels are instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)


def _snap_chunk(req: int, blk: int) -> int:
    """Largest divisor of `blk` at or below `req`, never under the 8-row
    tile floor (falls back to the whole block)."""
    return next((d for d in range(min(req, blk), 7, -1) if blk % d == 0), blk)


def _resolve_schedule(T, Tk, D, qdtype, causal, block_q, block_k, mxu_dtype,
                      kernel, chunk_k, kv_cast_scratch, q_tiles, fuse_denom,
                      window=None, static_max=None):
    """Static schedule resolution (``accl_tpu/ops/flash.py:505``): block
    shrinking, chunk snapping, kernel/auto selection and the auto
    q_tiles/fuse_denom choices, with the same errors.  Returns (causal,
    bq, bk, ck, mxu_dtype, kernel, needs_cast, q_tiles, fuse_denom,
    window, static_max): the JAX tuple without its ``interpret``.  The
    dtypes are torch dtypes."""
    bq, bk = min(block_q, T), min(block_k, Tk)
    while T % bq != 0 and bq > 8:
        bq //= 2
    while Tk % bk != 0 and bk > 8:
        bk //= 2
    if T % bq != 0 or Tk % bk != 0:
        raise ValueError(
            f"sequence lengths {T}/{Tk} not divisible by blocks ({bq}, {bk})")
    ck = bk if chunk_k is None else _snap_chunk(chunk_k, bk)

    needs_cast = kv_cast_scratch and qdtype != mxu_dtype

    auto_sched = q_tiles is None
    if auto_sched:
        q_tiles = _AUTO_Q_TILES
    elif q_tiles < 1:
        raise ValueError(f"q_tiles={q_tiles} must be >= 1")
    auto_fd = fuse_denom is None
    if not auto_fd and fuse_denom and kernel not in ("resident", "auto"):
        raise ValueError(
            f"fuse_denom is a resident-schedule option (kernel={kernel!r})")

    kv_bytes = 2 * Tk * D * (qdtype.itemsize
                             + (mxu_dtype.itemsize if needs_cast else 0))
    fd_scr_bytes = (Tk * (D + 1 + (D if qdtype != mxu_dtype else 0))
                    * mxu_dtype.itemsize)
    auto_kernel = kernel == "auto"
    if auto_kernel:
        kernel = "resident" if kv_bytes <= _RESIDENT_KV_BYTES else "grid"
    if kernel not in ("resident", "grid", "grid_resident", "resident_skew"):
        raise ValueError(f"unknown flash kernel {kernel!r}")
    if kernel == "resident_skew":
        if q_tiles > 1:
            raise ValueError("resident_skew is a single-chain schedule "
                             "(the skewed score carry IS its overlap "
                             "mechanism); q_tiles > 1 is not supported")
        if chunk_k is not None:
            raise ValueError("resident_skew folds whole K blocks (the "
                             "score carry spans block_k); chunk_k is "
                             "not supported")
        if kv_cast_scratch:
            raise ValueError("resident_skew casts K/V per block read; "
                             "kv_cast_scratch is not supported")
    if auto_fd:
        fuse_denom = (kernel == "resident" and D % 128 != 0
                      and kv_bytes + fd_scr_bytes <= _RESIDENT_KV_BYTES)
    elif fuse_denom and auto_kernel:
        if kernel != "resident" \
                or kv_bytes + fd_scr_bytes > _RESIDENT_KV_BYTES:
            fuse_denom = False

    if auto_sched and chunk_k is None and _AUTO_CHUNK_K is not None:
        ck = _snap_chunk(_AUTO_CHUNK_K, bk)

    while q_tiles > 1 and (bq % q_tiles != 0 or (bq // q_tiles) % 8 != 0):
        q_tiles -= 1

    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (a sliding "
                             "window is a trailing-context mask)")
        if window < 1:
            raise ValueError(f"window={window} must be >= 1")
        if kernel == "resident" and auto_kernel:
            kernel = "grid"
        if kernel not in ("grid", "grid_resident"):
            raise ValueError("window is a grid-schedule option "
                             f"(kernel={kernel!r})")
        fuse_denom = False
    if static_max is not None:
        if kernel == "resident_skew":
            raise ValueError("static_max is not supported by the "
                             "resident_skew schedule")
        static_max = float(static_max)
    return (causal, bq, bk, ck, mxu_dtype, kernel, needs_cast, q_tiles,
            fuse_denom, window, static_max)


# ---------------------------------------------------------------------------
# block bounds shared by the plain versions (the kernels apply the same
# algebra to their own tiles)
# ---------------------------------------------------------------------------
def _causal_block_bounds(iq, block_q, block_k, nk_total):
    """(n_past, n_live): k blocks [0, n_past) are strictly past (no mask),
    [n_past, n_live) straddle the diagonal (masked), the rest is future."""
    n_past = (iq * block_q) // block_k
    n_live = (iq * block_q + block_q + block_k - 1) // block_k
    return n_past, min(n_live, nk_total)


def _window_first_block(iq, block_q, block_k, window):
    """First k block any row of q block `iq` can see under the window."""
    return max(iq * block_q - (window - 1), 0) // block_k


def _grid_live_masked(iq, ik, bq, bk, causal, window=None):
    """(live, masked) predicates of grid cell (iq, ik): future cells (and
    cells before every row's window) are dead; cells straddling the
    diagonal or the window edge are masked."""
    if not causal:
        return True, False
    live = ik * bk <= iq * bq + bq - 1
    diag = (ik * bk + bk - 1 > iq * bq) and live
    if window is not None:
        live = live and (ik * bk + bk - 1 > iq * bq - window)
        wedge = ik * bk < iq * bq + bq - window
        diag = (diag or wedge) and live
    return live, diag


# ---------------------------------------------------------------------------
# plain versions: the Pallas fold, block by block
# ---------------------------------------------------------------------------
def _fold(q, kb, vb, acc, m, l, mask, mxu, static_max, fuse_denom):
    """One online-softmax fold (``_softmax_fold``/``_fold_consume``) over
    grouped operands: q [Nk, g, rows, D] and kb/vb [Nk, 1, ck, D], already
    in the MXU dtype; acc/m/l float32 running state.  ``mask`` is None or
    (row0, col0, window).  With ``fuse_denom`` the row sum is taken over
    the MXU-dtype p, as the ones column riding the PV matmul does."""
    s = torch.matmul(q.float(), kb.float().transpose(-1, -2))
    if mask is not None:
        row0, col0, window = mask
        rows = row0 + torch.arange(s.shape[-2], device=s.device)[:, None]
        cols = col0 + torch.arange(s.shape[-1], device=s.device)[None, :]
        keep = rows >= cols
        if window is not None:
            keep = keep & (rows - cols < window)
        s = torch.where(keep, s, NEG_INF)
    if static_max is not None:
        p = torch.exp2(s - static_max)
        pm = p.to(mxu).float()
        l = l + (pm if fuse_denom else p).sum(-1, keepdim=True)
        return acc + torch.matmul(pm, vb.float()), m, l
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp2(s - shift)
    if mask is not None:
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
    alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp2(m - shift))
    pm = p.to(mxu).float()
    l = alpha * l + (pm if fuse_denom else p).sum(-1, keepdim=True)
    return acc * alpha + torch.matmul(pm, vb.float()), m_new, l


def _finalize(acc, m, l, static_max, out_dtype):
    """(out, lse) of one q block (``_finalize``): out = acc / l (l = 0 ->
    1), lse = m ln2 + ln(max(l, 1e-38)) in natural-log units, NEG_INF for
    dead rows; under static_max m is the pin for live rows."""
    if static_max is not None:
        m = torch.where(l == 0.0, NEG_INF, static_max)
    out = (acc / torch.where(l == 0.0, 1.0, l)).to(out_dtype)
    lse = torch.where(m <= NEG_INF / 2, NEG_INF,
                      m * _LN2 + torch.log(torch.clamp_min(l, 1e-38)))
    return out, lse[..., 0]


def _plain_operands(qp, kp, vp, mxu):
    """Pre-scaled q and K/V in the MXU dtype, grouped [Nk, g, T, D] and
    [Nk, 1, Tk, D].  The q product is taken in the input dtype with the
    scale as a constant of that dtype (JAX's weakly typed scalar)."""
    N, T, D = qp.shape
    Nk, Tk = kp.shape[0], kp.shape[1]
    scale = torch.tensor(_LOG2E / float(D) ** 0.5, dtype=qp.dtype,
                         device=qp.device)
    q = (qp * scale).to(mxu).reshape(Nk, N // Nk, T, D)
    return (q, kp.to(mxu).reshape(Nk, 1, Tk, D),
            vp.to(mxu).reshape(Nk, 1, Tk, D))


def _run_plain(qp, kp, vp, cfg, cells):
    """Drive the fold over ``cells(iq)``, which yields (k block, masked)
    per q block, and finalize each q block."""
    (causal, bq, bk, ck, mxu, _kernel, _nc, _qt, fuse_denom, window,
     static_max, _g) = cfg
    N, T, D = qp.shape
    Nk = kp.shape[0]
    q, k, v = _plain_operands(qp, kp, vp, mxu)
    out = torch.empty_like(qp)
    lse = torch.empty((N, T), dtype=torch.float32, device=qp.device)
    for iq in range(T // bq):
        qb = q[:, :, iq * bq:(iq + 1) * bq]
        shape = (Nk, N // Nk, bq)
        acc = torch.zeros(shape + (D,), dtype=torch.float32, device=qp.device)
        m = torch.full(shape + (1,), NEG_INF, dtype=torch.float32,
                       device=qp.device)
        l = torch.zeros(shape + (1,), dtype=torch.float32, device=qp.device)
        for ik, masked in cells(iq):
            for c in range(bk // ck):
                off = ik * bk + c * ck
                acc, m, l = _fold(qb, k[:, :, off:off + ck],
                                  v[:, :, off:off + ck], acc, m, l,
                                  (iq * bq, off, window) if masked else None,
                                  mxu, static_max, fuse_denom)
        o, s = _finalize(acc, m, l, static_max, qp.dtype)
        out[:, iq * bq:(iq + 1) * bq] = o.reshape(N, bq, D)
        lse[:, iq * bq:(iq + 1) * bq] = s.reshape(N, bq)
    return out, lse


def flash_fwd_resident_plain(qp, kp, vp, cfg):
    """``_flash_kernel_resident`` in torch: per q block, the unmasked past
    blocks, then the masked diagonal blocks (``_causal_block_bounds``);
    every block unmasked without causal."""
    causal, bq, bk = cfg[0], cfg[1], cfg[2]
    nk = kp.shape[1] // bk

    def cells(iq):
        n_past, n_live = (_causal_block_bounds(iq, bq, bk, nk) if causal
                          else (nk, nk))
        return ((j, j >= n_past) for j in range(n_live))

    return _run_plain(qp, kp, vp, cfg, cells)


def flash_fwd_resident_skew_plain(qp, kp, vp, cfg):
    """``_flash_kernel_resident_skew`` in torch: the resident chain with
    whole ``block_k`` folds and one q tile, which is what the skewed
    schedule computes (only the issue order of its matmuls differs)."""
    (causal, bq, bk, _ck, mxu, kernel, nc, _qt, _fuse_denom, window,
     static_max, g) = cfg
    return flash_fwd_resident_plain(qp, kp, vp, (
        causal, bq, bk, bk, mxu, kernel, nc, 1, False, window, static_max, g))


def flash_fwd_grid_plain(qp, kp, vp, cfg):
    """``_flash_kernel_grid`` in torch: per (q block, k block) cell the
    live/diagonal predicates; under a window the k range is bounded to
    ``nk_eff`` blocks from ``_window_first_block``, phantom tail cells
    dead."""
    causal, bq, bk, window = cfg[0], cfg[1], cfg[2], cfg[9]
    nk = kp.shape[1] // bk
    nk_eff = (min(nk, (window - 1 + bq + bk - 1) // bk + 1)
              if window is not None else nk)

    def cells(iq):
        first = (_window_first_block(iq, bq, bk, window)
                 if window is not None else 0)
        for j in range(nk_eff):
            ik = j + first
            live, diag = _grid_live_masked(iq, ik, bq, bk, causal, window)
            if window is not None:
                live = live and ik < nk
                diag = diag and live
            if live:
                yield ik, causal and diag

    return _run_plain(qp, kp, vp, cfg, cells)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
#: q and K/V rows of the forward kernels' tiles (csrc/flash.cu BQ, BK):
#: a q tile of the tensor-core mainloop (one warpgroup), a K/V tile of both
FWD_TILE = 64
#: q rows of one CTA of the fp32 mainloop (csrc/flash.cu FMA_BQ)
FWD_FMA_ROWS = 128
#: q heads of one GQA group that one CTA of the tensor-core forward serves
#: (one warpgroup each, sharing the K/V tiles and the masks), where the
#: group divides by it (csrc/flash.cu MAX_HEADS)
FWD_HEADS = 2


def fwd_heads(group: int, mxu) -> int:
    """q heads per CTA of the forward kernels: FWD_HEADS on the bfloat16
    (tensor-core) mainloop where the GQA group divides by it, else 1; the
    float32 mainloop runs one head per CTA."""
    return (FWD_HEADS if mxu == torch.bfloat16 and group % FWD_HEADS == 0
            else 1)


def fwd_rows(mxu) -> int:
    """q rows of one CTA's tile: FWD_TILE on the tensor-core mainloop
    (per head), FWD_FMA_ROWS on the fp32 one."""
    return FWD_TILE if mxu == torch.bfloat16 else FWD_FMA_ROWS


def kernel_ctas(N: int, T: int, group: int = 1, mxu=torch.float32) -> int:
    """Thread blocks one forward launch over N packed heads of T rows uses:
    one per (``fwd_heads`` q heads, ``fwd_rows``-row q tile)."""
    return N // fwd_heads(group, mxu) * _cdiv(T, fwd_rows(mxu))


def fwd_walk(qt: int, T: int, Tk: int, causal: bool, window,
             rows: int = FWD_TILE) -> tuple:
    """(first, end, masked) of the forward kernels' q tile ``qt`` of
    ``rows`` rows: it folds the 64-row k tiles [first, end) in order, and
    ``masked[kt - first]`` says whether tile kt takes the per-cell test (it
    overhangs K, straddles the diagonal or the window edge); csrc/flash.cu
    ``walk`` and ``tile_masked``."""
    q0 = qt * rows
    nkt = _cdiv(Tk, FWD_TILE)
    first = max(q0 - (window - 1), 0) // FWD_TILE if window else 0
    end = min((q0 + rows - 1) // FWD_TILE + 1, nkt) if causal else nkt
    masked = tuple(
        kt * FWD_TILE + FWD_TILE > Tk
        or (causal and kt * FWD_TILE + FWD_TILE - 1 > q0)
        or bool(window and kt * FWD_TILE < q0 + rows - window)
        for kt in range(first, end))
    return first, end, masked


def _aligned(x):
    """x, or a fresh copy when its data does not start on 16 bytes (the
    kernels read rows as 16-byte chunks)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(qp, kp, vp, cfg):
    """Check the operands, allocate (out, lse) and launch the forward of
    csrc/flash.cu on the operands' card, one kernel for every schedule:
    the fp32 FMA mainloop for the float32 MXU dtype, the tensor-core one
    for bfloat16."""
    (causal, _bq, _bk, _ck, mxu, _kernel, _nc, _qt, _fd, window, static_max,
     _g) = cfg
    N, T, D = qp.shape
    Nk, Tk = kp.shape[0], kp.shape[1]
    dt = qp.dtype
    for t in (qp, kp, vp):
        if t.device != qp.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("flash kernel: q, k and v must be contiguous, "
                             "on one device, of one dtype")
    if dt not in KERNEL_DTYPES or mxu not in KERNEL_DTYPES:
        raise ValueError(f"flash kernel: takes float32 or bfloat16 inputs "
                         f"and MXU dtypes, got {dt} and {mxu}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head size {D} not in "
                         f"{KERNEL_HEAD_DIMS}")
    qp, kp, vp = _aligned(qp), _aligned(kp), _aligned(vp)
    out = torch.empty_like(qp)
    lse = torch.empty((N, T), dtype=torch.float32, device=qp.device)
    lib = _build.load("flash")
    dev = qp.device
    rc = lib.accl_flash_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
        lse.data_ptr(), N, Nk, T, Tk, D, KERNEL_DTYPES[dt], int(causal),
        window or 0, int(mxu == torch.bfloat16), int(static_max is not None),
        float(static_max or 0.0), _LOG2E / float(D) ** 0.5,
        fwd_heads(N // Nk, mxu), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.accl_flash_error_string(rc).decode()
        raise RuntimeError(f"accl_flash_fwd: CUDA error {rc} ({msg})")
    return out, lse


def _on_cpu(qp) -> bool:
    if qp.device.type == "cpu":
        return True
    if qp.device.type != "cuda":
        raise ValueError(f"flash attention: tensors on {qp.device} (cpu or "
                         f"cuda only)")
    return False


def _count(wrapper, cfg):
    """One launch of ``wrapper``'s kernel; ``launches_tc`` counts those on
    the tensor-core (bfloat16 MXU) mainloop."""
    wrapper.launches += 1
    wrapper.launches_tc += cfg[4] == torch.bfloat16


def flash_fwd_resident(qp, kp, vp, cfg):
    """The resident schedule on packed operands -> (out [N, T, D], lse
    [N, T] float32).  On the card: the forward kernel."""
    if _on_cpu(qp):
        return flash_fwd_resident_plain(qp, kp, vp, cfg)
    res = _launch(qp, kp, vp, cfg)
    _count(flash_fwd_resident, cfg)
    return res


def flash_fwd_grid(qp, kp, vp, cfg):
    """The grid schedule (and grid_resident) on packed operands -> (out,
    lse).  On the card: the forward kernel, windowed as the schedule
    says."""
    if _on_cpu(qp):
        return flash_fwd_grid_plain(qp, kp, vp, cfg)
    res = _launch(qp, kp, vp, cfg)
    _count(flash_fwd_grid, cfg)
    return res


def flash_fwd_resident_skew(qp, kp, vp, cfg):
    """The skewed resident schedule on packed operands -> (out, lse), bit
    for bit the resident schedule's.  On the card: the forward kernel,
    whose tensor-core mainloop issues tile j + 1's scores before tile j's
    softmax in every schedule."""
    if _on_cpu(qp):
        return flash_fwd_resident_skew_plain(qp, kp, vp, cfg)
    res = _launch(qp, kp, vp, cfg)
    _count(flash_fwd_resident_skew, cfg)
    return res


for _w in (flash_fwd_resident, flash_fwd_grid, flash_fwd_resident_skew):
    _w.launches = 0
    _w.launches_tc = 0


def fwd_kernel_info(D: int, dtype, mxu, device: int = 0) -> dict:
    """Registers, spill (local) bytes, static and dynamic shared memory
    and resident CTAs per SM of the forward kernel that takes these
    dtypes (``flash_fwd_fma`` for the float32 MXU dtype, else
    ``flash_fwd_wgmma``), at the launch footprint of ``fwd_heads`` heads
    per CTA (of an even GQA group), as the runtime reports them."""
    import ctypes

    lib = _build.load("flash")
    out = (ctypes.c_int * 5)()
    rc = lib.accl_flash_kernel_info(D, KERNEL_DTYPES[dtype],
                                    int(mxu == torch.bfloat16),
                                    fwd_heads(FWD_HEADS, mxu), device, out)
    if rc != 0:
        msg = lib.accl_flash_error_string(rc).decode()
        raise RuntimeError(f"accl_flash_kernel_info: CUDA error {rc} "
                           f"({msg})")
    name = "flash_fwd_wgmma" if mxu == torch.bfloat16 else "flash_fwd_fma"
    return {"kernel": name, **dict(zip(
        ("registers", "local_bytes", "static_smem", "dynamic_smem",
         "ctas_per_sm"), out))}


def _flash_forward_impl(qp, kp, vp, cfg):
    """The schedule dispatch (``_flash_forward_impl``)."""
    kernel = cfg[5]
    if kernel == "resident":
        return flash_fwd_resident(qp, kp, vp, cfg)
    if kernel == "resident_skew":
        return flash_fwd_resident_skew(qp, kp, vp, cfg)
    return flash_fwd_grid(qp, kp, vp, cfg)


# ---------------------------------------------------------------------------
# backward: dQ per q block over k blocks, dK/dV per k block over q blocks
# ---------------------------------------------------------------------------
#
# With the saved (out, lse), the normalized probabilities rebuild per
# block as P = exp2(s2 - l2) (q2 pre-scaled by a log2(e), l2 = lse
# log2(e)), and
#
#   dV_j  = sum_i P_ij dO_i
#   dS_ij = P_ij (dO_i . V_j - dvec_i),  dvec_i = dO_i . out_i - dlse_i
#   dQ_i  = a sum_j dS_ij K_j,   dK_j = a sum_i dS_ij Q_i
#
# Causal cells are predicated exactly like the forward grid schedule.

def _bwd_p_block(q2, kb, l2, row0, col0, masked, window):
    """``_flash_bwd_p_block``: the normalized probability block
    [..., rows(q2), rows(kb)] from MXU-dtype q2/kb and the log2 lse
    [..., rows, 1]; dead rows (lse = NEG_INF) give zeros; ``masked``
    applies row >= col (and row - col < window) at the global offsets."""
    s2 = torch.matmul(q2.float(), kb.float().transpose(-1, -2))
    p = torch.where(l2 <= NEG_INF / 2, 0.0, torch.exp2(s2 - l2))
    if masked:
        rows = row0 + torch.arange(s2.shape[-2], device=s2.device)[:, None]
        cols = col0 + torch.arange(s2.shape[-1], device=s2.device)[None, :]
        keep = rows >= cols
        if window is not None:
            keep = keep & (rows - cols < window)
        p = torch.where(keep, p, 0.0)
    return p


def _bwd_bounds(cfg, T, Tk):
    """(nq, nk, nq_eff, nk_eff): the block counts and, under a window, the
    bounded extents of the dq kernel's k axis and the dkv kernel's q
    axis (``_flash_backward``)."""
    bq, bk, window = cfg[1], cfg[2], cfg[9]
    nq, nk = T // bq, Tk // bk
    if window is None:
        return nq, nk, nq, nk
    return (nq, nk, min(nq, (bk + window - 2) // bq + 2),
            min(nk, (window - 1 + bq + bk - 1) // bk + 1))


def _grouped(x, Nk):
    """[N, T, ...] -> [Nk, N / Nk, T, ...]: packed q row n under K/V row
    n // (N / Nk)."""
    return x.reshape((Nk, x.shape[0] // Nk) + tuple(x.shape[1:]))


def flash_bwd_dq_plain(q2, kp, vp, do, l2, dvec, cfg):
    """``_flash_bwd_dq_kernel`` in torch: per q block, the cells
    (``_grid_live_masked``, the window's bounded k range from
    ``_window_first_block``, phantom cells past nk dead) folded in
    ``chunk_k`` sub-chunks, dS cast to the MXU dtype before dS @ K; dq =
    acc * a in q2's dtype.  q2/do [N, T, D], kp/vp [Nk, Tk, D], l2/dvec
    [N, T] float32."""
    (causal, bq, bk, ck, mxu, _kernel, _nc, _qt, _fd, window, _sm,
     _g) = cfg
    N, T, D = q2.shape
    Nk, Tk = kp.shape[0], kp.shape[1]
    nq, nk, _nq_eff, nk_eff = _bwd_bounds(cfg, T, Tk)
    a = 1.0 / float(D) ** 0.5
    q, dom = _grouped(q2.to(mxu), Nk), _grouped(do.to(mxu), Nk)
    k, v = kp.to(mxu)[:, None], vp.to(mxu)[:, None]
    l2g, dvg = _grouped(l2[..., None], Nk), _grouped(dvec[..., None], Nk)
    dq = torch.empty_like(q2)
    for iq in range(nq):
        rs = slice(iq * bq, (iq + 1) * bq)
        qb, dob, l2b, dvb = q[:, :, rs], dom[:, :, rs], l2g[:, :, rs], \
            dvg[:, :, rs]
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q2.device)
        first = (_window_first_block(iq, bq, bk, window)
                 if window is not None else 0)
        for j in range(nk_eff):
            ik = j + first
            live, diag = _grid_live_masked(iq, ik, bq, bk, causal, window)
            if window is not None:
                live = live and ik < nk
                diag = diag and live
            if not live:
                continue
            for c in range(bk // ck):
                off = ik * bk + c * ck
                kb, vb = k[:, :, off:off + ck], v[:, :, off:off + ck]
                p = _bwd_p_block(qb, kb, l2b, iq * bq, off,
                                 causal and diag, window)
                dp = torch.matmul(dob.float(), vb.float().transpose(-1, -2))
                ds = p * (dp - dvb)
                acc = acc + torch.matmul(ds.to(mxu).float(), kb.float())
        dq[:, rs] = (acc * a).to(q2.dtype).reshape(N, bq, D)
    return dq


def flash_bwd_dkv_plain(q2, kp, vp, do, l2, dvec, cfg):
    """``_flash_bwd_dkv_kernel`` in torch: per k block, the sequential
    axis over every q head of the K/V head's group and its live q blocks
    (``nq_eff`` of them from the causal base ``(ik bk) // bq`` under a
    window, phantom cells past nq dead), each folded in ``_snap_chunk(ck,
    bq)`` sub-chunks: dV += P^T dO, dK += dS^T q2 with P and dS cast to
    the MXU dtype; dk = acc / log2(e)."""
    (causal, bq, bk, ck, mxu, _kernel, _nc, _qt, _fd, window, _sm,
     _g) = cfg
    N, T, D = q2.shape
    Nk, Tk = kp.shape[0], kp.shape[1]
    G = N // Nk
    nq, nk, nq_eff, _nk_eff = _bwd_bounds(cfg, T, Tk)
    ckq = _snap_chunk(ck, bq)
    q, dom = _grouped(q2.to(mxu), Nk), _grouped(do.to(mxu), Nk)
    l2g, dvg = _grouped(l2[..., None], Nk), _grouped(dvec[..., None], Nk)
    k, v = kp.to(mxu), vp.to(mxu)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    for ik in range(nk):
        cs = slice(ik * bk, (ik + 1) * bk)
        kb, vb = k[:, cs], v[:, cs]
        dk_acc = torch.zeros(kb.shape, dtype=torch.float32, device=kp.device)
        dv_acc = torch.zeros_like(dk_acc)
        for j in range(nq_eff * G):
            g, j2 = divmod(j, nq_eff)
            iq = j2 + ((ik * bk) // bq if window is not None else 0)
            live, diag = _grid_live_masked(iq, ik, bq, bk, causal, window)
            if window is not None:
                live = live and iq < nq
                diag = diag and live
            if not live:
                continue
            for c in range(bq // ckq):
                r0 = iq * bq + c * ckq
                rs = slice(r0, r0 + ckq)
                qc, doc = q[:, g, rs], dom[:, g, rs]
                p = _bwd_p_block(qc, kb, l2g[:, g, rs], r0, ik * bk,
                                 causal and diag, window)
                dv_acc = dv_acc + torch.matmul(
                    p.to(mxu).float().transpose(-1, -2), doc.float())
                dp = torch.matmul(doc.float(), vb.float().transpose(-1, -2))
                ds = (p * (dp - dvg[:, g, rs])).to(mxu)
                dk_acc = dk_acc + torch.matmul(ds.float().transpose(-1, -2),
                                               qc.float())
        dk[:, cs] = (dk_acc * (1.0 / _LOG2E)).to(kp.dtype)
        dv[:, cs] = dv_acc.to(vp.dtype)
    return dk, dv


#: q and K/V rows of the backward kernels' tiles (csrc/flash_bwd.cu BQ, BK)
BWD_TILE = 64
#: a dK/dV item holds at most 1 / BWD_ITEM_SHARE of one SM's average
#: work, per MXU dtype (the mainloop: fp32 FMA at 1 CTA per SM, bf16
#: tensor cores at 2), the fastest of 4-32 at the training shape on an
#: H100 ...
BWD_ITEM_SHARE = {torch.float32: 12, torch.bfloat16: 6}
#: ... and, unless its tile has fewer, at least this many steps
BWD_MIN_ITEM = 4


class BwdPlan(NamedTuple):
    """One backward launch pair.  ``flash_bwd_dq`` runs one CTA per
    (packed q head, q tile), ``dq_ctas`` of them, last q tiles first.
    ``flash_bwd_dkv`` runs one CTA per item: ``items`` are (tile, j0, j1,
    slot) in launch order, longest first, K/V tile ``tile = kt Nk + kv
    head`` over steps [j0, j1) of its walk, step j being q head j //
    nlive of its group at q tile first + j % nlive (``_live_q``);
    ``tiles`` holds (parts, first_slot) per tile: an item alone on its
    tile stores dK and dV, the items of a split tile store fp32 partials
    into slots first_slot, first_slot + 1, ... (``slot``), and the last to
    finish sums them in that order.  ``steps`` counts the dK/dV walk's
    (q head, q tile, k tile) cells, ``heaviest`` the longest item's,
    ``per_sm`` the average over the SMs."""
    items: tuple
    tiles: tuple
    slots: int
    dq_ctas: int
    steps: int
    heaviest: int
    per_sm: float


def _live_q(kt: int, T: int, Tk: int, causal: bool, window) -> tuple:
    """(first q tile, live q tiles) of K/V tile ``kt``, per q head: from
    the diagonal to the last q tile whose window still reaches the tile
    (csrc/flash_bwd.cu ``live_q``)."""
    nqt = _cdiv(T, BWD_TILE)
    k_last = min(kt * BWD_TILE + BWD_TILE, Tk) - 1
    first = kt if causal else 0
    last = (min(nqt - 1, (k_last + window - 1) // BWD_TILE) if window
            else nqt - 1)
    return first, max(0, last - first + 1)


def bwd_plan(N: int, Nk: int, T: int, Tk: int, causal: bool, window,
             sms: int, mxu=torch.bfloat16) -> BwdPlan:
    """Work items of the backward kernels on a card of ``sms`` SMs under
    MXU dtype ``mxu``.  Each K/V tile's walk (every q head of its group
    over its live q tiles) is cut into near-equal ranges of at most
    max(BWD_MIN_ITEM, the average work per SM / BWD_ITEM_SHARE[mxu])
    steps, launched longest first, so that the causal load (the first k
    tile sees every q tile, the last one) spreads over the card.  At N 8,
    Nk 2, T 4096 causal on 132 SMs: 16,640 steps, 126 per SM; items of
    at most 11 steps in fp32 (1,572 items), 22 in bf16 (816)."""
    G = N // Nk
    nkt = _cdiv(Tk, BWD_TILE)
    lens = [G * _live_q(kt, T, Tk, causal, window)[1] for kt in range(nkt)]
    steps = Nk * sum(lens)
    per_sm = steps / sms
    cap = max(BWD_MIN_ITEM, _cdiv(steps, sms * BWD_ITEM_SHARE[mxu]))
    items, tiles, slots = [], [], 0
    for kt in range(nkt):
        L = lens[kt]
        parts = max(1, _cdiv(L, cap))
        for kvn in range(Nk):
            tile = kt * Nk + kvn
            tiles.append((parts, slots if parts > 1 else 0))
            for i in range(parts):
                items.append((tile, i * L // parts, (i + 1) * L // parts,
                              slots + i if parts > 1 else -1))
            if parts > 1:
                slots += parts
    items.sort(key=lambda it: (it[1] - it[2], it[0], it[1]))
    return BwdPlan(tuple(items), tuple(tiles), slots,
                   N * _cdiv(T, BWD_TILE), steps,
                   max((j1 - j0 for _t, j0, j1, _s in items), default=0),
                   per_sm)


_plan_lock = threading.Lock()
#: (device, N, Nk, T, Tk, causal, window, mxu) -> (plan, items, tiles):
#: the plan and its tables on the card, uploaded once per shape
_plans: dict = {}


def _plan_on(dev: torch.device, N, Nk, T, Tk, causal, window, mxu) -> tuple:
    key = (dev.index, N, Nk, T, Tk, bool(causal), window or 0, mxu)
    with _plan_lock:
        got = _plans.get(key)
        if got is None:
            plan = bwd_plan(N, Nk, T, Tk, causal, window or 0,
                            _sms(dev.index or 0), mxu)

            def table(rows, width):
                flat = [x for row in rows for x in row] or [0] * width
                return torch.tensor(flat, dtype=torch.int32, device=dev)

            got = (plan, table(plan.items, 4), table(plan.tiles, 2))
            _plans[key] = got
        return got


def _launch_bwd(fn_name, outs, q2, kp, vp, do, l2, dvec, cfg):
    """Check the operands and launch ``fn_name`` of csrc/flash_bwd.cu
    into ``outs`` on the operands' card: the fp32 mainloop for the
    float32 MXU dtype, the tensor-core one for bfloat16; ``flash_bwd_dkv``
    under ``bwd_plan``."""
    causal, mxu, window = cfg[0], cfg[4], cfg[9]
    N, T, D = q2.shape
    Nk, Tk = kp.shape[0], kp.shape[1]
    dt = q2.dtype
    for t in (q2, kp, vp, do, *outs):
        if t.device != q2.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("flash backward kernel: q2, k, v, dO and the "
                             "gradients must be contiguous, on one device, "
                             "of one dtype")
        if t.data_ptr() % 16:
            raise ValueError("flash backward kernel: q2, k, v, dO and the "
                             "gradients must start on 16 bytes")
    for t in (l2, dvec):
        if (t.device != q2.device or t.dtype != torch.float32
                or tuple(t.shape) != (N, T) or not t.is_contiguous()):
            raise ValueError(f"flash backward kernel: l2 and dvec must be "
                             f"contiguous float32 [{N}, {T}]")
    if dt not in KERNEL_DTYPES or mxu not in KERNEL_DTYPES:
        raise ValueError(f"flash backward kernel: takes float32 or bfloat16 "
                         f"inputs and MXU dtypes, got {dt} and {mxu}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash backward kernel: head size {D} not in "
                         f"{KERNEL_HEAD_DIMS}")
    lib = _build.load("flash_bwd")
    dev = q2.device
    stream = torch.cuda.current_stream(dev)
    args = [q2.data_ptr(), kp.data_ptr(), vp.data_ptr(), do.data_ptr(),
            l2.data_ptr(), dvec.data_ptr(), *(o.data_ptr() for o in outs)]
    if fn_name == "accl_flash_bwd_dkv":
        plan, items, tiles = _plan_on(dev, N, Nk, T, Tk, causal, window,
                                      mxu)
        # both held until the launch: under a capture each is a new tensor
        ws = (_scratch_for(dev, stream, "ws", plan.slots * 2 * BWD_TILE * D)
              if plan.slots else None)
        counters = _scratch_for(dev, stream, "counters",
                                max(1, len(plan.tiles)))
        args += [items.data_ptr(), tiles.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 counters.data_ptr(), len(plan.items)]
    args += [N, Nk, T, Tk, D, KERNEL_DTYPES[dt], int(causal), window or 0,
             int(mxu == torch.bfloat16)]
    if fn_name == "accl_flash_bwd_dq":
        args.append(1.0 / float(D) ** 0.5)
    args += [dev.index or 0, stream.cuda_stream]
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.accl_flash_bwd_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({msg})")


def flash_bwd_dq(q2, kp, vp, do, l2, dvec, cfg):
    """dQ [N, T, D] in q2's dtype from the prepared operands of
    ``_flash_backward``.  On the card: the ``flash_bwd_dq`` kernel."""
    if _on_cpu(q2):
        return flash_bwd_dq_plain(q2, kp, vp, do, l2, dvec, cfg)
    dq = torch.empty_like(q2)
    _launch_bwd("accl_flash_bwd_dq", (dq,), q2, kp, vp, do, l2, dvec, cfg)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q2, kp, vp, do, l2, dvec, cfg):
    """(dK, dV) [Nk, Tk, D] in k's dtype from the prepared operands of
    ``_flash_backward``.  On the card: the ``flash_bwd_dkv`` kernel, one
    CTA per item of ``bwd_plan``."""
    if _on_cpu(q2):
        return flash_bwd_dkv_plain(q2, kp, vp, do, l2, dvec, cfg)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    _launch_bwd("accl_flash_bwd_dkv", (dk, dv), q2, kp, vp, do, l2, dvec,
                cfg)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def bwd_kernel_info(D: int, dtype, mxu, device: int = 0) -> dict:
    """Registers, spill (local) bytes, static and dynamic shared memory
    and resident CTAs per SM of the dq and dkv kernels that take these
    dtypes, as the runtime reports them at their launch footprint."""
    import ctypes

    lib = _build.load("flash_bwd")
    info = {}
    for which, name in enumerate(("flash_bwd_dq", "flash_bwd_dkv")):
        out = (ctypes.c_int * 5)()
        rc = lib.accl_flash_bwd_kernel_info(which, D, KERNEL_DTYPES[dtype],
                                            int(mxu == torch.bfloat16),
                                            device, out)
        if rc != 0:
            msg = lib.accl_flash_bwd_error_string(rc).decode()
            raise RuntimeError(f"accl_flash_bwd_kernel_info: CUDA error "
                               f"{rc} ({msg})")
        info[name] = dict(zip(("registers", "local_bytes", "static_smem",
                               "dynamic_smem", "ctas_per_sm"), out))
    return info


def _flash_backward(qp, kp, vp, out, lse, g_out, g_lse, cfg):
    """The host-side prep of ``_flash_backward``: q2 = q a log2(e) taken
    in float32 and cast back to q's dtype, l2 = lse log2(e), dvec =
    rowsum(dO out) - g_lse (the subtract skipped when the lse output was
    unused); then the dq and dkv kernels.  Returns (dq, dk, dv)."""
    D = qp.shape[-1]
    a = 1.0 / float(D) ** 0.5
    q2 = (qp.float() * (a * _LOG2E)).to(qp.dtype)
    l2 = (lse * _LOG2E).contiguous()
    dvec = torch.sum(g_out.float() * out.float(), dim=-1)
    if g_lse is not None:
        dvec = dvec - g_lse.float()
    dvec = dvec.contiguous()
    g_out = g_out.contiguous()
    dq = flash_bwd_dq(q2, kp, vp, g_out, l2, dvec, cfg)
    dk, dv = flash_bwd_dkv(q2, kp, vp, g_out, l2, dvec, cfg)
    return dq, dk, dv


class _FlashPacked(torch.autograd.Function):
    """The role of ``_flash_packed_diff`` (the custom-vjp boundary): the
    forward is the schedule dispatch, saving (q, k, v, out, lse); the
    backward is ``_flash_diff_bwd``.  Gradients are not materialized, so
    an unused lse output arrives as None (JAX's symbolic zero) and the
    dvec subtract is skipped; an unused out becomes zeros."""

    @staticmethod
    def forward(ctx, qp, kp, vp, cfg):
        out, lse = _flash_forward_impl(qp, kp, vp, cfg)
        ctx.save_for_backward(qp, kp, vp, out, lse)
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        qp, kp, vp, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = _flash_backward(qp, kp, vp, out, lse, g_out, g_lse,
                                     ctx.cfg)
        return dq, dk, dv, None


def _flash_call_packed(qp, kp, vp, causal, block_q, block_k, mxu_dtype,
                       kernel, chunk_k=None, kv_cast_scratch=False,
                       q_tiles=None, fuse_denom=None, window=None,
                       static_max=None):
    """Core entry on head-packed operands: q [N, T, D], k/v [Nk, Tk, D]
    with N % Nk == 0 (q row n reads K/V row n // (N / Nk)).  Returns
    (out [N, T, D], lse [N, T] float32)."""
    N, T, D = qp.shape
    Tk = kp.shape[1]
    if (kp.shape != vp.shape or kp.shape[2] != D
            or kp.shape[0] == 0 or N % kp.shape[0] != 0):
        raise ValueError(f"k/v shape {tuple(kp.shape)}/{tuple(vp.shape)} "
                         f"incompatible with q {tuple(qp.shape)} (K/V heads "
                         f"must divide q heads for GQA)")
    if causal and Tk != T:
        raise ValueError("causal masking requires Tq == Tk "
                         "(cross-length attention has no diagonal)")
    cfg = _resolve_schedule(T, Tk, D, qp.dtype, causal, block_q, block_k,
                            mxu_dtype, kernel, chunk_k, kv_cast_scratch,
                            q_tiles, fuse_denom, window, static_max)
    cfg += (N // kp.shape[0],)
    return _FlashPacked.apply(qp.contiguous(), kp.contiguous(),
                              vp.contiguous(), cfg)


def _flash_call(q, k, v, causal, block_q, block_k, mxu_dtype, kernel,
                q_tiles=None, fuse_denom=None, window=None, static_max=None):
    """[B, T, H, D] wrapper: packs to [B*H, T, D] around the core call.
    k/v may carry fewer heads than q ([B, Tk, G, D], H % G == 0).
    Returns (out [B, T, H, D], lse [B, H, T] float32)."""
    B, T, H, D = q.shape
    G = k.shape[2] if k.dim() == 4 else -1
    if (k.shape != v.shape or k.dim() != 4 or k.shape[0] != B
            or k.shape[3] != D or G <= 0 or H % G != 0):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"incompatible with q {tuple(q.shape)} (K/V heads "
                         f"must divide q heads for GQA)")

    def pack(x):
        t, h = x.shape[1], x.shape[2]
        return x.transpose(1, 2).reshape(B * h, t, D)

    out, lse = _flash_call_packed(pack(q), pack(k), pack(v), causal, block_q,
                                  block_k, mxu_dtype, kernel, q_tiles=q_tiles,
                                  fuse_denom=fuse_denom, window=window,
                                  static_max=static_max)
    return (out.reshape(B, H, T, D).transpose(1, 2),
            lse.reshape(B, H, T))


def flash_attention(q, k, v, causal: bool = False, block_q: int = 256,
                    block_k: int = 512, mxu_dtype=torch.bfloat16,
                    kernel: str = "auto", q_tiles: Optional[int] = None,
                    fuse_denom: Optional[bool] = None,
                    window: Optional[int] = None,
                    static_max: Optional[float] = None):
    """q, k, v: [B, T, H, D] (k/v may have fewer heads, GQA) -> [B, T, H,
    D].  ``kernel``: "resident", "resident_skew", "grid", "grid_resident"
    or "auto" (resident or grid by K/V size, the JAX package's rule);
    ``window`` (causal, grid) keeps each row's trailing ``window``
    columns; ``static_max`` pins the softmax shift.  On the card these,
    ``causal`` and the dtypes choose what runs; ``block_q``, ``block_k``,
    ``q_tiles`` and ``fuse_denom`` are validated as the JAX package does
    but change nothing there (the kernels walk 64-row tiles)."""
    out, _lse = _flash_call(q, k, v, causal, block_q, block_k, mxu_dtype,
                            kernel, q_tiles, fuse_denom, window, static_max)
    return out


def flash_attention_lse(q, k, v, causal: bool = False, block_q: int = 256,
                        block_k: int = 512, mxu_dtype=torch.bfloat16,
                        kernel: str = "auto", q_tiles: Optional[int] = None,
                        fuse_denom: Optional[bool] = None,
                        window: Optional[int] = None,
                        static_max: Optional[float] = None):
    """Like :func:`flash_attention`, also returning the log-sum-exp:
    (out [B, T, H, D], lse [B, H, T] float32)."""
    return _flash_call(q, k, v, causal, block_q, block_k, mxu_dtype, kernel,
                       q_tiles, fuse_denom, window, static_max)


def flash_attention_packed(q, k, v, causal: bool = False,
                           block_q: int = 256, block_k: int = 512,
                           mxu_dtype=torch.bfloat16, kernel: str = "auto",
                           chunk_k: Optional[int] = None,
                           kv_cast_scratch: bool = False,
                           q_tiles: Optional[int] = None,
                           fuse_denom: Optional[bool] = None,
                           window: Optional[int] = None,
                           static_max: Optional[float] = None):
    """Head-packed entry: q [N, T, D], k/v [Nk, Tk, D] -> out [N, T, D].
    ``chunk_k`` is the plain version's sub-fold size; ``kv_cast_scratch``
    only enters the resolver's residency budget."""
    out, _lse = _flash_call_packed(q, k, v, causal, block_q, block_k,
                                   mxu_dtype, kernel, chunk_k,
                                   kv_cast_scratch, q_tiles, fuse_denom,
                                   window, static_max)
    return out


def flash_attention_packed_lse(q, k, v, causal: bool = False,
                               block_q: int = 256, block_k: int = 512,
                               mxu_dtype=torch.bfloat16, kernel: str = "auto",
                               chunk_k: Optional[int] = None,
                               kv_cast_scratch: bool = False,
                               q_tiles: Optional[int] = None,
                               fuse_denom: Optional[bool] = None,
                               window: Optional[int] = None,
                               static_max: Optional[float] = None):
    """Head-packed entry returning (out [N, T, D], lse [N, T] float32)."""
    return _flash_call_packed(q, k, v, causal, block_q, block_k, mxu_dtype,
                              kernel, chunk_k, kv_cast_scratch, q_tiles,
                              fuse_denom, window, static_max)
