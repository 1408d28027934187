"""Wire-compression lanes: the hp_compression plugin.

Port of ``accl_tpu/ops/compression.py``: streaming casts at a 2:1 width
ratio (reference kernels/plugins/hp_compression/hp_compression.cpp:70-144),
fp32 -> fp16 / bf16 and back, with optional stochastic rounding.  The
payload is viewed as ``[rows, 512]`` tiles (``_to_tiles`` pads the tail) and
cast in ``block_rows``-row tiles by the CUDA kernel ``accl_cast``
(``csrc/compression.cu``) in place of the Pallas kernel ``_cast_2d``.

- Rounding to nearest even: fp32 -> float16 or bfloat16, as ``Tensor.to``
  rounds.
- Stochastic rounding: fp32 -> bfloat16, float8_e5m2 or float8_e4m3fn,
  the targets ``pltpu.stochastic_round`` takes (its fourth,
  float8_e4m3b11fnuz, has no torch dtype); float16 raises, as it does
  there.  The TPU draws its bits from the core PRNG seeded with
  ``seed + tile``; the port draws them from a counter-based hash of
  (``seed + tile``, element index within the tile), ``_random_bits``, and
  rounds up with probability equal to the dropped fraction
  (``_stochastic_round``).  The plain version computes both with integer
  tensor ops, so the kernel is held to it bit for bit.  Past its range,
  e5m2 rounds to inf and e4m3fn (which has none) saturates at +-448.
- Back to fp32 from float16, bfloat16, float8_e5m2 or float8_e4m3fn.

The seed is a kernel argument: stepping it per call (to decorrelate ring
hops) rebuilds nothing.  A wrapper runs the plain version only when it is
given CPU tensors; given CUDA tensors it launches the kernel or raises,
and counts its launches in ``_cast_2d.launches``.

No backend calls these lanes on the driver path: the JAX TPU backend's
wire roundtrip (``accl_tpu/backends/tpu.py:2011``) casts with ``astype``,
as the port's does.  They are the benchmark-of-record compression stage
(``bench.py``) and the chip tuning sweep (``bench/kernel_tune.py``).
"""
from __future__ import annotations

import torch

from . import _build
from .reduce_ops import _to_tiles

#: rows per tile (the JAX package's on-chip choice) and lanes per row
_BLOCK_ROWS = 1024
_LANES = 512

#: dtype codes of csrc/compression.cu
_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
          torch.float8_e5m2: 3, torch.float8_e4m3fn: 4}
#: targets of rounding to nearest even
NEAREST_TARGETS = (torch.float16, torch.bfloat16)
#: targets of stochastic rounding: (mantissa bits, least normal exponent)
STOCHASTIC_TARGETS = {torch.bfloat16: (7, -126), torch.float8_e5m2: (2, -14),
                      torch.float8_e4m3fn: (3, -6)}
#: sources of the cast back to float32
WIDEN_SOURCES = (torch.float16, torch.bfloat16, torch.float8_e5m2,
                 torch.float8_e4m3fn)

_M32 = 0xFFFFFFFF


def _check_pair(src, dst, stochastic: bool) -> None:
    if stochastic:
        if src != torch.float32 or dst not in STOCHASTIC_TARGETS:
            raise ValueError(
                f"stochastic rounding casts float32 to one of "
                f"{[str(d) for d in STOCHASTIC_TARGETS]} (the targets "
                f"pltpu.stochastic_round takes), not {src} to {dst}")
    elif not ((src == torch.float32 and dst in NEAREST_TARGETS)
              or (src in WIDEN_SOURCES and dst == torch.float32)):
        raise ValueError(
            f"cast {src} -> {dst}: the lanes cast float32 to "
            f"{[str(d) for d in NEAREST_TARGETS]} and "
            f"{[str(d) for d in WIDEN_SOURCES]} to float32")


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), in int64 without overflow."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _random_bits(seed: int, rows: int, cols: int, block_rows: int,
                 device) -> torch.Tensor:
    """The stochastic rounding's 32 random bits per element of a [rows,
    cols] view cut into block_rows-row tiles, as int64 values in [0,
    2^32): element i of tile t draws fmix32(fmix32(seed + t) ^ (i
    0x9E3779B1)), all mod 2^32, as csrc/compression.cu does."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    key = _fmix32((seed + r // block_rows) & _M32)
    idx = ((r % block_rows) * cols + c) & _M32
    return _fmix32(key ^ _mul32(idx, 0x9E3779B1))


def _stochastic_round(x: torch.Tensor, bits: torch.Tensor,
                      dtype) -> torch.Tensor:
    """float32 x rounded to ``dtype`` stochastically with the uint32
    ``bits`` (int64): with m the 24-bit significand of |x| and k the bits
    below the target's last mantissa bit at x's exponent, n = (m + R) >>
    k, R the low k bits of ``bits`` (k <= 32) or ``bits`` shifted up by
    k - 32 (k <= 63; n = 0 beyond); the result n 2^(e - 23 + k) is exact
    in the target.  Past the range: inf (bf16, e5m2) or +-448 (e4m3fn);
    inf and NaN pass through ``Tensor.to``."""
    mant, emin = STOCHASTIC_TARGETS[dtype]
    u = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    mag = u & 0x7FFFFFFF
    big_e = mag >> 23
    e = torch.clamp_min(big_e, 1) - 127
    m = (mag & 0x7FFFFF) | torch.where(big_e > 0, 0x800000, 0)
    k = (23 - mant) + torch.clamp_min(emin - e, 0)
    low = bits & (torch.bitwise_left_shift(torch.ones_like(k),
                                           torch.clamp_max(k, 32)) - 1)
    high = torch.bitwise_left_shift(bits, torch.clamp(k - 32, 0, 31))
    n = (m + torch.where(k <= 32, low, high)) >> torch.clamp_max(k, 63)
    n = torch.where(k <= 63, n, 0)
    v = n.double() * torch.exp2((e - 23 + k).double())
    v = torch.where((u >> 31) == 1, -v, v).float()
    v = torch.where(mag >= 0x7F800000, x, v)
    if dtype == torch.float8_e5m2:
        v = torch.where(v.abs() >= 65536.0, v.sign() * float("inf"), v)
    elif dtype == torch.float8_e4m3fn:
        v = torch.clamp(v, -448.0, 448.0)  # inf saturates too
    return v.to(dtype)


def _cast_2d_plain(x2d, seed, dtype, stochastic, block_rows):
    if not stochastic:
        return x2d.to(dtype)
    rows, cols = x2d.shape
    return _stochastic_round(
        x2d, _random_bits(seed, rows, cols, block_rows, x2d.device), dtype)


def _cast_2d(x2d: torch.Tensor, seed: int, dtype, stochastic: bool,
             block_rows: int = _BLOCK_ROWS) -> torch.Tensor:
    """Cast a [rows, cols] tensor to ``dtype`` in ``block_rows``-row tiles
    (the column count is the tensor's, so the tuning sweep reuses this);
    stochastic rounding seeds tile t with ``seed + t``.  On the card: the
    ``accl_cast`` kernel of csrc/compression.cu."""
    if x2d.dim() != 2:
        raise ValueError(f"cast: a 2-d view, got {tuple(x2d.shape)}")
    _check_pair(x2d.dtype, dtype, stochastic)
    if block_rows < 1:
        raise ValueError(f"cast: block_rows={block_rows} must be >= 1")
    rows, cols = x2d.shape
    block_rows = min(block_rows, max(rows, 1))
    seed = int(seed) & _M32
    if x2d.device.type == "cpu":
        return _cast_2d_plain(x2d, seed, dtype, stochastic, block_rows)
    if x2d.device.type != "cuda":
        raise ValueError(f"cast: tensors on {x2d.device} (cpu or cuda only)")
    x2d = x2d.contiguous()
    out = torch.empty((rows, cols), dtype=dtype, device=x2d.device)
    if x2d.numel() == 0:
        return out
    lib = _build.load("compression")
    dev = x2d.device
    rc = lib.accl_cast(x2d.data_ptr(), out.data_ptr(), rows, cols, block_rows,
                       _CODES[x2d.dtype], _CODES[dtype], int(stochastic), seed,
                       dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.accl_compression_error_string(rc).decode()
        raise RuntimeError(f"accl_cast: CUDA error {rc} ({msg})")
    _cast_2d.launches += 1
    return out


_cast_2d.launches = 0


def compress_cast(x: torch.Tensor, dtype=torch.bfloat16,
                  stochastic: bool = False, seed: int = 0) -> torch.Tensor:
    """Compress lane (hp_compression TDEST 0): float32 -> float16 /
    bfloat16 by nearest even, or with ``stochastic=True`` -> bfloat16 /
    float8_e5m2 / float8_e4m3fn by stochastic rounding seeded with
    ``seed`` (stepping it rebuilds nothing)."""
    x2, n = _to_tiles(x, _LANES)
    out = _cast_2d(x2, seed, dtype, stochastic)
    return out.reshape(-1)[:n].view(x.shape)


def decompress_cast(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Decompress lane (hp_compression TDEST 1): float16 / bfloat16 /
    float8 -> float32."""
    x2, n = _to_tiles(x, _LANES)
    out = _cast_2d(x2, 0, dtype, False)
    return out.reshape(-1)[:n].view(x.shape)
