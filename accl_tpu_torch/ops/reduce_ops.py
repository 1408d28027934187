"""On-path reduction arithmetic: the reduce_ops plugin lane.

Port of ``accl_tpu/ops/reduce_ops.py``: an elementwise sum or max whose
lane is selected by (dtype, function), like the reference plugin's TDEST
selector (kernels/plugins/reduce_ops/reduce_ops.cpp:31-107).  The operands
are viewed as ``[rows, 128]`` tiles (``_to_tiles`` pads the tail) and
combined in ``block_rows``-row tiles by the CUDA kernel ``accl_combine``
(``csrc/reduce_ops.cu``) in place of the Pallas kernel
``_pallas_combine_2d``, over the 12 lanes of ``ARITH_LANE``: float32,
float64, int32, int64, float16 and bfloat16, each by sum and by max.

Beside the kernel sits its plain PyTorch version (``a + b``,
``torch.maximum``).  The wrapper runs it only when it is given CPU
tensors; given CUDA tensors it launches the kernel or raises, and counts
its launches in ``_pallas_combine_2d.launches``.

``donate=True`` writes the result into operand ``a``'s storage and
returns ``a``: PyTorch's in-place form of the alias that the JAX package
asks for with ``input_output_aliases={0: 0}``.  The JAX package never
mutates the caller's array; the port does, only when asked.

No backend calls these lanes on the driver path (the JAX TPU backend's
wire roundtrip casts with ``astype`` and reduces with XLA): they are the
benchmark-of-record lanes (``bench.py``).
"""
from __future__ import annotations

import torch

from . import _build

#: rows per tile when block_rows is 0 (the JAX package's default)
_BLOCK_ROWS = 512
_LANES = 128

#: operand dtypes the kernel takes, with their code in csrc/reduce_ops.cu
KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                 torch.int64: 3, torch.float16: 4, torch.bfloat16: 5}


def _to_tiles(x: torch.Tensor, lanes: int = _LANES):
    """Flatten to [rows, lanes], padding the tail with zeros; returns (2d,
    original length).  A contiguous x whose length divides ``lanes`` is
    viewed, not copied."""
    n = x.numel()
    flat = x.reshape(-1)
    rows = -(-n // lanes)
    pad = rows * lanes - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(rows, lanes), n


def _combine_2d_plain(a: torch.Tensor, b: torch.Tensor,
                      is_max: bool) -> torch.Tensor:
    """The kernel's function in torch: a + b or torch.maximum(a, b)."""
    return torch.maximum(a, b) if is_max else a + b


def _pallas_combine_2d(a: torch.Tensor, b: torch.Tensor, is_max: bool = False,
                       block_rows: int = 0,
                       donate: bool = False) -> torch.Tensor:
    """Elementwise sum (or max) of two [rows, 128] tensors of one dtype in
    ``block_rows``-row tiles (0: ``_BLOCK_ROWS``).  ``donate=True`` writes
    the result into ``a`` and returns it.  On the card: the
    ``accl_combine`` kernel of csrc/reduce_ops.cu."""
    if a.dim() != 2 or a.shape[1] != _LANES or a.shape != b.shape:
        raise ValueError(f"combine: operands must both be [rows, {_LANES}], "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in KERNEL_DTYPES:
        raise ValueError(f"combine: operands of one dtype among "
                         f"{sorted(str(d) for d in KERNEL_DTYPES)}, got "
                         f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError("combine: operands on one device")
    if block_rows < 0:
        raise ValueError(f"combine: block_rows={block_rows} must be >= 0")
    rows = a.shape[0]
    block_rows = min(block_rows or _BLOCK_ROWS, max(rows, 1))
    if a.device.type == "cpu":
        res = _combine_2d_plain(a, b, is_max)
        return a.copy_(res) if donate else res
    if a.device.type != "cuda":
        raise ValueError(f"combine: tensors on {a.device} (cpu or cuda only)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("combine: operands must be contiguous")
    out = a if donate else torch.empty_like(a)
    if rows == 0:
        return out
    lib = _build.load("reduce_ops")
    dev = a.device
    rc = lib.accl_combine(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows,
                          block_rows, KERNEL_DTYPES[a.dtype], int(is_max),
                          dev.index or 0,
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.accl_reduce_ops_error_string(rc).decode()
        raise RuntimeError(f"accl_combine: CUDA error {rc} ({msg})")
    _pallas_combine_2d.launches += 1
    return out


_pallas_combine_2d.launches = 0


def _combine(a, b, is_max, block_rows, donate):
    if a.shape != b.shape:
        raise ValueError(f"combine: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    a2, n = _to_tiles(a)
    b2, _ = _to_tiles(b)
    out = _pallas_combine_2d(a2, b2, is_max, block_rows, donate and
                             a2.data_ptr() == a.data_ptr())
    res = out.reshape(-1)[:n].view(a.shape)
    if not donate:
        return res
    if res.data_ptr() != a.data_ptr():
        a.copy_(res)  # a's tiles were a padded copy: the result goes back
    return a


def pallas_add(a: torch.Tensor, b: torch.Tensor, block_rows: int = 0,
               donate: bool = False) -> torch.Tensor:
    """Elementwise sum lane (reduce_ops TDEST 0/2/4/6/8).  ``block_rows``
    overrides the tile depth (the bench's ladder; 0 = default);
    ``donate=True`` writes the sum into ``a`` and returns ``a``."""
    return _combine(a, b, False, block_rows, donate)


def pallas_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max lane (reduce_ops TDEST 1/3/5/7/9)."""
    return _combine(a, b, True, 0, False)


def reduce_lane(a: torch.Tensor, b: torch.Tensor, op: str = "sum",
                use_pallas: bool = True) -> torch.Tensor:
    """Dispatch by (dtype, op) like the reference TDEST selector.  With
    ``use_pallas=False`` the combine is the plain ``a + b`` /
    ``torch.maximum`` instead of the kernel."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown reduce op {op!r}")
    if not use_pallas:
        return _combine_2d_plain(a, b, op == "max")
    fn = pallas_add if op == "sum" else pallas_max
    return fn(a, b)
