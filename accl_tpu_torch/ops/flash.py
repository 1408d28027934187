"""Flash attention, forward half.

Port of ``accl_tpu/ops/flash.py``: tiled QK^T -> online softmax -> PV
with the running (max, denominator) carried across K blocks, so the
[Tq, Tk] score matrix never materializes; every entry also yields the
log-sum-exp statistics (natural-log units) that distributed callers fold
partial attentions with.

Two schedules, chosen by the JAX package's own rule (``_resolve_schedule``
with ``_RESIDENT_KV_BYTES``, copied so that both packages pick the same
kernel for the same inputs):

- ``resident``: the K/V row of one packed head walked whole per q block
  (``_flash_kernel_resident``) -> the CUDA kernel ``flash_fwd_resident``;
- ``grid`` and ``grid_resident``: one fold per (q block, k block) cell,
  with causal live/diagonal predicates and the sliding ``window``
  (``_flash_kernel_grid``) -> the CUDA kernel ``flash_fwd_grid``.

Both kernels are in ``csrc/flash.cu``.  Beside each sits its plain
PyTorch version: the Pallas fold written block by block, with the same
``bq``/``bk``/``ck`` loops, log2 domain, clamps and casts.  A wrapper runs
the plain version only when it is given CPU tensors; given CUDA tensors
it launches its kernel or raises.  Each wrapper counts its launches in
its ``launches`` attribute.

``mxu_dtype`` is the matmul input format, bfloat16 by default even for
float32 inputs (the q product, K, V and the probabilities are rounded to
it; accumulation is always float32); pass ``torch.float32`` for exact
float32 numerics.  Not ported yet, each raising an ``ACCLError`` naming
itself: ``kernel="resident_skew"`` and the backward kernels
(``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..constants import ACCLError
from . import _build

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
def _launch(fn_name, qp, kp, vp, cfg):
    """Check the operands, allocate (out, lse) and launch ``fn_name`` of
    csrc/flash.cu on the operands' card."""
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
    out = torch.empty_like(qp)
    lse = torch.empty((N, T), dtype=torch.float32, device=qp.device)
    lib = _build.load("flash")
    dev = qp.device
    args = [qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
            lse.data_ptr(), N, Nk, T, Tk, D, KERNEL_DTYPES[dt], int(causal)]
    if fn_name == "accl_flash_fwd_grid":
        args.append(window or 0)
    args += [int(mxu == torch.bfloat16), int(static_max is not None),
             float(static_max or 0.0), _LOG2E / float(D) ** 0.5,
             dev.index or 0, torch.cuda.current_stream(dev).cuda_stream]
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.accl_flash_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({msg})")
    return out, lse


def _on_cpu(qp) -> bool:
    if qp.device.type == "cpu":
        return True
    if qp.device.type != "cuda":
        raise ValueError(f"flash attention: tensors on {qp.device} (cpu or "
                         f"cuda only)")
    return False


def flash_fwd_resident(qp, kp, vp, cfg):
    """The resident schedule on packed operands -> (out [N, T, D], lse
    [N, T] float32).  On the card: the ``flash_fwd_resident`` kernel."""
    if _on_cpu(qp):
        return flash_fwd_resident_plain(qp, kp, vp, cfg)
    res = _launch("accl_flash_fwd_resident", qp, kp, vp, cfg)
    flash_fwd_resident.launches += 1
    return res


flash_fwd_resident.launches = 0


def flash_fwd_grid(qp, kp, vp, cfg):
    """The grid schedule (and grid_resident) on packed operands -> (out,
    lse).  On the card: the ``flash_fwd_grid`` kernel."""
    if _on_cpu(qp):
        return flash_fwd_grid_plain(qp, kp, vp, cfg)
    res = _launch("accl_flash_fwd_grid", qp, kp, vp, cfg)
    flash_fwd_grid.launches += 1
    return res


flash_fwd_grid.launches = 0


def kernel_ctas(N: int, T: int) -> int:
    """Thread blocks one kernel launch over N packed heads of T rows uses
    (needs the built library, so the card)."""
    return int(_build.load("flash").accl_flash_ctas(N, T))


def _flash_forward_impl(qp, kp, vp, cfg):
    """The schedule dispatch (``_flash_forward_impl``)."""
    kernel = cfg[5]
    if kernel == "resident_skew":
        raise ACCLError("flash kernel 'resident_skew' "
                        "(_flash_kernel_resident_skew) is not part of "
                        "accl_tpu_torch yet")
    if kernel == "resident":
        return flash_fwd_resident(qp, kp, vp, cfg)
    return flash_fwd_grid(qp, kp, vp, cfg)


class _FlashPacked(torch.autograd.Function):
    """The role of ``_flash_packed_diff`` (the custom-vjp boundary): the
    forward is the schedule dispatch; the backward needs the flash
    backward kernels, which come with the training slice."""

    @staticmethod
    def forward(ctx, qp, kp, vp, cfg):
        return _flash_forward_impl(qp, kp, vp, cfg)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise ACCLError("flash attention backward (_flash_bwd_dq_kernel, "
                        "_flash_bwd_dkv_kernel) is not part of "
                        "accl_tpu_torch yet")


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
    D].  ``kernel``: "resident", "grid", "grid_resident" or "auto" (by
    K/V size, the JAX package's rule); ``window`` (causal, grid) keeps
    each row's trailing ``window`` columns; ``static_max`` pins the
    softmax shift.  ``q_tiles`` and ``fuse_denom`` are validated as the
    JAX package does; on the card they change nothing."""
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
