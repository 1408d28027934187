"""On-path reduction arithmetic: the reduce_ops plugin lane.

Port of ``accl_tpu/ops/reduce_ops.py``: an elementwise sum or max whose
lane is selected by (dtype, function), like the reference plugin's TDEST
selector (kernels/plugins/reduce_ops/reduce_ops.cpp:31-107).  The operands
are viewed as ``[rows, 128]`` tiles (``_to_tiles`` pads the tail) and
combined by the CUDA kernel ``accl_combine`` (``csrc/reduce_ops.cu``) in
place of the Pallas kernel
``_pallas_combine_2d``, over the 12 lanes of ``ARITH_LANE``: float32,
float64, int32, int64, float16 and bfloat16, each by sum and by max.

Beside the kernel sits its plain PyTorch version (``a + b``,
``torch.maximum``).  The wrapper runs it only when it is given CPU
tensors; given CUDA tensors it launches the kernel or raises, and counts
its launches in ``_pallas_combine_2d.launches``.

The ``block_rows``-row tiles of the Pallas grid do not shape the
launch: ``stream_plan`` cuts the flat run of 16-byte vectors into
blocks of STREAM_THREADS vectors, one CTA each, and the card schedules
the CTAs as SMs free up.  ``block_rows`` is still taken
and checked, and moves no bit and no launch: the bench's ladder times
one launch.  The same plan drives the cast kernel of ``compression``.
``combine_kernel_info`` reports an instantiation's registers and CTAs
per SM.

``donate=True`` writes the result into operand ``a``'s storage and
returns ``a``: PyTorch's in-place form of the alias that the JAX package
asks for with ``input_output_aliases={0: 0}``.  The JAX package never
mutates the caller's array; the port does, only when asked.

No backend calls these lanes on the driver path (the JAX TPU backend's
wire roundtrip casts with ``astype`` and reduces with XLA): they are the
benchmark-of-record lanes (``bench.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

_LANES = 128

#: operand dtypes the kernel takes, with their code in csrc/reduce_ops.cu
KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                 torch.int64: 3, torch.float16: 4, torch.bfloat16: 5}

#: the streaming kernels' geometry (csrc/reduce_ops.cu and
#: csrc/compression.cu): threads per CTA; the combine kernel's bytes per
#: vector (one vector a thread)
STREAM_THREADS = 256
VEC_BYTES = 16
#: the most CTAs one launch takes (gridDim.x)
MAX_GRID = 2 ** 31 - 1


class StreamPlan(NamedTuple):
    """One launch of a streaming kernel over ``units`` vectors (or
    elements): ``grid`` CTAs walking blocks of ``block`` units, CTA c
    the blocks c, c + grid, ... (``stream_share``)."""
    grid: int
    units: int
    block: int


def stream_plan(units: int, per_thread: int = 1) -> StreamPlan:
    """One CTA per block of STREAM_THREADS x ``per_thread`` units (the
    kernel's vectors per thread; 1 on the element path, for pointers off
    16-byte alignment).  The card schedules the CTAs as SMs free up,
    which streams faster than one resident wave walking the payload."""
    block = STREAM_THREADS * per_thread
    return StreamPlan(max(1, min(-(-units // block), MAX_GRID)), units, block)


def stream_share(plan: StreamPlan, cta: int) -> list:
    """[first, last) of each block of units CTA ``cta`` walks, in order,
    as the kernels compute them."""
    step = plan.grid * plan.block
    return [(b, min(b + plan.block, plan.units))
            for b in range(cta * plan.block, plan.units, step)]


def kernel_info(lib, fn: str, *key) -> dict:
    """Registers and local bytes a thread, and CTAs an SM holds, of one
    instantiation of a streaming kernel, from ``fn`` of ``lib`` (the
    ``*_kernel_info`` entries); ``key`` ends with the device."""
    out = (ctypes.c_int * 3)()
    rc = getattr(lib, fn)(*key, out)
    if rc != 0:
        raise RuntimeError(f"{fn}{key}: CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "ctas_per_sm": out[2]}


@functools.lru_cache(maxsize=None)
def combine_kernel_info(dtype_code: int, is_max: bool, vec: bool,
                        device: int) -> dict:
    """``kernel_info`` of the combine kernel (cached per device)."""
    return kernel_info(_build.load("reduce_ops"), "accl_combine_kernel_info",
                       dtype_code, int(is_max), int(vec), device)


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
    ``block_rows``-row tiles (0: the JAX package's 512; the tiles move no
    bit, and on the card no launch).  ``donate=True`` writes the result into
    ``a`` and returns it.  On the card: the ``accl_combine`` kernel of
    csrc/reduce_ops.cu under ``stream_plan``."""
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
    dev, code, n = a.device.index or 0, KERNEL_DTYPES[a.dtype], a.numel()
    vec = all(t.data_ptr() % VEC_BYTES == 0 for t in (a, b, out))
    plan = stream_plan(n // (VEC_BYTES // a.element_size()) if vec else n)
    rc = lib.accl_combine(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, code,
                          int(is_max), int(vec), plan.grid, dev,
                          torch.cuda.current_stream(a.device).cuda_stream)
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
