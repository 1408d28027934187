// Streaming casts between fp32 and the wire's narrow types: the
// hp_compression plugin lanes.  fp32 -> fp16 / bf16 rounding to nearest
// even, fp32 -> bf16 / fp8 (e5m2, e4m3fn) rounding stochastically, and
// fp16 / bf16 / fp8 -> fp32.
//
// Replaces the Pallas TPU kernel _cast_2d (_cast_kernel and
// _stochastic_kernel, accl_tpu/ops/compression.py:54, calls :72 and :84)
// and its tuning copy cast2d (scripts/kernel_tune.py:96, call :102).  The
// TPU grid walks block_rows-row tiles of a [rows, cols] view.  Here the
// tiles do not shape the launch: the payload is one flat run of CHUNK-
// element vectors (16 bytes of fp32, 4-8 of the narrow type), and the
// wrapper's plan (ops/reduce_ops.py stream_plan) launches one CTA per
// THREADS x UNROLL vectors (SR_UNROLL when rounding stochastically),
// which the card schedules as SMs free up.  Each thread loads its vectors
// before its first store; stores are streaming (st.global.cs), loads too
// where the source is narrow (ld.global.cs; an fp32 source loads plainly,
// see load_src), and every warp-wide access is contiguous, so no sector
// is half written or half read when L2 evicts it early (8-element
// vectors, two 16-byte halves a thread, ran up to 2x slower on the
// widening casts: PERF.md).  The last CTA casts the ragged tail of
// fewer than CHUNK elements; pointers that are not 16-byte aligned take
// the same walk over single elements.  So the tuning sweep's geometries
// are one launch for the nearest and widening casts.
//
// Rounding to nearest even is what Tensor.to does on the card, NaN, inf,
// overflow and fp16 subnormals included: cvt.rn on pairs
// (__float22bfloat162_rn / __float22half2_rn) on the vector path,
// __float2bfloat16_rn / __float2half_rn on single elements.  Widening is
// exact: bf16 is a 16-bit shift, fp16 and fp8 go through cvt.
//
// Stochastic rounding has no PRNG stream to copy: the TPU seeds its core
// PRNG with seed + tile index per grid step (compression.py:42-47).  Here
// the random bits of element i of tile t (tiles of block_rows x cols
// elements) are a counter-based hash, fmix32(fmix32(seed + t) ^ (i *
// 0x9E3779B1)) (the murmur3 finalizer), which the plain version in
// compression.py computes with integer tensor ops, so the kernel is held
// to it bit for bit.  Each vector finds its (t, i) by one division of its
// flat index and rolls i over into the next tile inside the vector, so a
// tile of any size takes the vector path.  The rounding, with k the bits
// below the target's last mantissa bit at |x|'s exponent and R the low k
// bits of the hash, adds R to the significand and drops k bits; it rounds
// up with probability (dropped bits) / 2^k.  In 32-bit steps on the fp32
// bit pattern u:
// - bf16: k is 16 for every finite fp32, normal or not, so the result is
//   ((|u| + (r & 0xffff)) >> 16) | sign: a carry into the exponent is the
//   right round-up and FLT_MAX rounds up to inf.  NaN goes through
//   __float2bfloat16_rn, as Tensor.to would take it.
// - fp8 in its normal range: k = 23 - M, the result is the fp32 pattern
//   ((|u| + R) >> k) << k, then encoded exactly.
// - fp8 below it: n = (m + R) >> k with m the 24-bit significand, and the
//   result n * 2^(EMIN - M), one exact multiply.  Only k > 31 (|x| below
//   2^-24 for e5m2, 2^-17 for e4m3fn) takes a 64-bit add, with R the hash
//   shifted up by k - 32 (n = 0 beyond k = 63).
// Past the target's range bf16 and e5m2 give inf and e4m3fn saturates at
// +-448.  The seed is an argument: stepping it rebuilds nothing.
//
// What bounds it on this card: bytes.  Each element is read once and
// written once (4 + 2 bytes either way for the fp16/bf16 lanes, 4 + 1 for
// fp8): at the bench shape ([131072, 512] fp32) each fp16/bf16 direction
// moves 384 MiB, 0.120 ms at 3.35 TB/s.  The hash and the rounding are
// ~20 integer operations an element, under what the card does in that
// time with every SM full.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "current_device.cuh"

namespace {

constexpr int THREADS = 256;
// vectors per thread: one for nearest and widening, four for stochastic
// rounding, whose integer work wants more loads in flight per thread
constexpr int UNROLL = 1;
constexpr int SR_UNROLL = 4;
constexpr int CHUNK = 4;  // elements per vector: 16 bytes of fp32
constexpr uint32_t GOLDEN = 0x9e3779b1u;

enum { DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2, DT_E5M2 = 3, DT_E4M3 = 4 };

// Storage of each type as plain bits
template <int DT> struct Store;
template <> struct Store<DT_F32> { using U = uint32_t; };
template <> struct Store<DT_F16> { using U = uint16_t; };
template <> struct Store<DT_BF16> { using U = uint16_t; };
template <> struct Store<DT_E5M2> { using U = uint8_t; };
template <> struct Store<DT_E4M3> { using U = uint8_t; };

template <int DT> struct Fp8Kind;
template <> struct Fp8Kind<DT_E5M2> { static constexpr __nv_fp8_interpretation_t K = __NV_E5M2; };
template <> struct Fp8Kind<DT_E4M3> { static constexpr __nv_fp8_interpretation_t K = __NV_E4M3; };

template <int DT> __device__ __forceinline__ float to_float(typename Store<DT>::U b);
template <> __device__ __forceinline__ float to_float<DT_F32>(uint32_t b) { return __uint_as_float(b); }
template <> __device__ __forceinline__ float to_float<DT_F16>(uint16_t b) {
  return __half2float(__ushort_as_half(b));
}
template <> __device__ __forceinline__ float to_float<DT_BF16>(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}
template <> __device__ __forceinline__ float to_float<DT_E5M2>(uint8_t b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E5M2)));
}
template <> __device__ __forceinline__ float to_float<DT_E4M3>(uint8_t b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3)));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// fp32 bits u rounded stochastically to bf16 bits with the random bits r
__device__ __forceinline__ uint16_t stochastic_bf16(uint32_t u, uint32_t r) {
  const uint32_t mag = u & 0x7fffffffu;
  if (mag > 0x7f800000u) return __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(u)));
  return (uint16_t)(((mag + (r & 0xffffu)) >> 16) | ((u >> 16) & 0x8000u));
}

// fp32 bits u rounded stochastically to a format with M mantissa bits and
// least normal exponent EMIN, as an fp32 value (exact in the format unless
// it is past the format's range); inf and NaN pass through
template <int M, int EMIN>
__device__ __forceinline__ float stochastic_value(uint32_t u, uint32_t r) {
  constexpr int K = 23 - M;
  const uint32_t mag = u & 0x7fffffffu, sign = u & 0x80000000u;
  if (mag >= 0x7f800000u) return __uint_as_float(u);
  if (mag >= (uint32_t)(EMIN + 127) << 23)  // the format's normal range
    return __uint_as_float((((mag + (r & ((1u << K) - 1))) >> K) << K) | sign);
  const int E = (int)(mag >> 23);
  const int e = (E > 0 ? E : 1) - 127;
  const uint32_t m = (mag & 0x7fffffu) | (E > 0 ? 0x800000u : 0u);
  const int k = K + EMIN - e;  // > K
  uint32_t n;
  if (k <= 31) {
    n = (m + (r & ((1u << k) - 1))) >> k;
  } else if (k <= 63) {
    const uint64_t R = k == 32 ? (uint64_t)r : ((uint64_t)r << (k - 32));
    n = (uint32_t)(((uint64_t)m + R) >> k);
  } else {
    n = 0;
  }
  constexpr float SCALE = EMIN - M == -16 ? 0x1p-16f : 0x1p-9f;  // 2^(EMIN - M)
  static_assert(EMIN - M == -16 || EMIN - M == -9, "e5m2 or e4m3fn");
  return __uint_as_float(__float_as_uint((float)n * SCALE) | sign);
}

// fp32 -> e5m2 / e4m3fn bits for the values stochastic_value returns
// (exact in the format, past its range, inf or NaN): past the range e5m2
// gives inf and e4m3fn, which has none, saturates at +-448, as the plain
// version defines; exact values are encoded exactly
__device__ __forceinline__ uint8_t encode_e5m2(float v) {
  const uint32_t u = __float_as_uint(v);
  const uint8_t s = (uint8_t)((u >> 24) & 0x80u);
  const uint32_t mag = u & 0x7fffffffu;
  if (mag > 0x7f800000u) return s | 0x7f;
  if (mag >= 0x47800000u) return s | 0x7c;  // |v| >= 65536: inf
  return (uint8_t)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E5M2);
}
__device__ __forceinline__ uint8_t encode_e4m3(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint8_t)(((u >> 24) & 0x80u) | 0x7fu);
  return (uint8_t)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);  // inf, > 448: +-448
}

// One element: nearest even or widening (SR false), stochastic (SR true)
template <int DT, bool SR> __device__ __forceinline__ typename Store<DT>::U from_float(float v, uint32_t r);
template <> __device__ __forceinline__ uint32_t from_float<DT_F32, false>(float v, uint32_t) {
  return __float_as_uint(v);
}
template <> __device__ __forceinline__ uint16_t from_float<DT_F16, false>(float v, uint32_t) {
  return __half_as_ushort(__float2half_rn(v));
}
template <> __device__ __forceinline__ uint16_t from_float<DT_BF16, false>(float v, uint32_t) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ uint16_t from_float<DT_BF16, true>(float v, uint32_t r) {
  return stochastic_bf16(__float_as_uint(v), r);
}
template <> __device__ __forceinline__ uint8_t from_float<DT_E5M2, true>(float v, uint32_t r) {
  return encode_e5m2(stochastic_value<2, -14>(__float_as_uint(v), r));
}
template <> __device__ __forceinline__ uint8_t from_float<DT_E4M3, true>(float v, uint32_t r) {
  return encode_e4m3(stochastic_value<3, -6>(__float_as_uint(v), r));
}

// CHUNK elements of one type as their bits, loadable as 8-32 bytes
template <int BYTES> struct Raw;
template <> struct Raw<4> { using W = unsigned int; static constexpr int N = 1; W w[N]; };
template <> struct Raw<8> { using W = uint2; static constexpr int N = 1; W w[N]; };
template <> struct Raw<16> { using W = uint4; static constexpr int N = 1; W w[N]; };
template <> struct Raw<32> { using W = uint4; static constexpr int N = 2; W w[N]; };
template <int DT>
union Chunk {
  using R = Raw<CHUNK * sizeof(typename Store<DT>::U)>;
  R raw;
  typename Store<DT>::U e[CHUNK];
  uint32_t w32[CHUNK * sizeof(typename Store<DT>::U) / 4];
  uint16_t w16[CHUNK * sizeof(typename Store<DT>::U) / 2];
};

// A load of the source: streaming (ld.global.cs) for the narrow types,
// plain for fp32, which measured ~1 % faster on the card (PERF.md)
template <int SRC, typename W>
__device__ __forceinline__ W load_src(const W* p) {
  if constexpr (SRC == DT_F32)
    return *p;
  else
    return __ldcs(p);
}

template <int DT>
__device__ __forceinline__ void load_chunk(Chunk<DT>& c, const typename Store<DT>::U* p) {
  using R = typename Chunk<DT>::R;
  const typename R::W* src = reinterpret_cast<const typename R::W*>(p);
#pragma unroll
  for (int i = 0; i < R::N; ++i) c.raw.w[i] = load_src<DT>(src + i);
}
template <int DT>
__device__ __forceinline__ void store_chunk(typename Store<DT>::U* p, const Chunk<DT>& c) {
  using R = typename Chunk<DT>::R;
  typename R::W* dst = reinterpret_cast<typename R::W*>(p);
#pragma unroll
  for (int i = 0; i < R::N; ++i) __stcs(dst + i, c.raw.w[i]);
}

// The stochastic rounding's tiles: element f of the flat payload is
// element i = f mod tile of tile t = f / tile, keyed fmix32(seed + t)
struct Tiles {
  int64_t tile;
  uint32_t seed;
  __device__ __forceinline__ void find(int64_t f, int64_t& t, int64_t& i) const {
    if (((uint64_t)f | (uint64_t)tile) >> 32 == 0) {
      const uint32_t q = (uint32_t)f / (uint32_t)tile;
      t = q;
      i = f - (int64_t)q * tile;
    } else {
      t = f / tile;
      i = f - t * tile;
    }
  }
  __device__ __forceinline__ uint32_t key(int64_t t) const { return fmix32(seed + (uint32_t)t); }
};

// One vector, nearest even or widening: pairs by cvt where the pair form
// exists, else element by element (the same instruction each)
template <int SRC, int DST>
__device__ __forceinline__ void convert(const Chunk<SRC>& in, Chunk<DST>& out) {
  if constexpr (SRC == DT_F32 && DST == DT_BF16) {
#pragma unroll
    for (int p = 0; p < CHUNK / 2; ++p) {
      const __nv_bfloat162 h = __float22bfloat162_rn(
          make_float2(__uint_as_float(in.e[2 * p]), __uint_as_float(in.e[2 * p + 1])));
      out.w32[p] = *reinterpret_cast<const uint32_t*>(&h);
    }
  } else if constexpr (SRC == DT_F32 && DST == DT_F16) {
#pragma unroll
    for (int p = 0; p < CHUNK / 2; ++p) {
      const __half2 h = __float22half2_rn(
          make_float2(__uint_as_float(in.e[2 * p]), __uint_as_float(in.e[2 * p + 1])));
      out.w32[p] = *reinterpret_cast<const uint32_t*>(&h);
    }
  } else if constexpr (SRC == DT_E5M2 || SRC == DT_E4M3) {
#pragma unroll
    for (int p = 0; p < CHUNK / 2; ++p) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)in.w16[p],
                                                       Fp8Kind<SRC>::K);
      out.e[2 * p] = __float_as_uint(__half2float(__ushort_as_half(h.x)));
      out.e[2 * p + 1] = __float_as_uint(__half2float(__ushort_as_half(h.y)));
    }
  } else {
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) out.e[e] = from_float<DST, false>(to_float<SRC>(in.e[e]), 0u);
  }
}

// One vector starting at flat element f, stochastic: the hash of each
// element's (t, i), with i rolled over into the next tile where the
// vector crosses one
template <int DST>
__device__ __forceinline__ void convert_sr(const Chunk<DT_F32>& in, Chunk<DST>& out, int64_t f,
                                           const Tiles& tl) {
  int64_t t, i;
  tl.find(f, t, i);
  uint32_t key = tl.key(t);
  if (i + CHUNK <= tl.tile) {
    const uint32_t h0 = (uint32_t)i * GOLDEN;
#pragma unroll
    for (int e = 0; e < CHUNK; ++e)
      out.e[e] = from_float<DST, true>(__uint_as_float(in.e[e]), fmix32(key ^ (h0 + (uint32_t)e * GOLDEN)));
  } else {
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) {
      if (i == tl.tile) {
        i = 0;
        key = tl.key(++t);
      }
      out.e[e] = from_float<DST, true>(__uint_as_float(in.e[e]), fmix32(key ^ ((uint32_t)i * GOLDEN)));
      ++i;
    }
  }
}

// One element at flat index f
template <int SRC, int DST, bool SR>
__device__ __forceinline__ void cast_one(const typename Store<SRC>::U* xs, typename Store<DST>::U* yd,
                                         int64_t f, const Tiles& tl) {
  uint32_t r = 0;
  if (SR) {
    int64_t t, i;
    tl.find(f, t, i);
    r = fmix32(tl.key(t) ^ ((uint32_t)i * GOLDEN));
  }
  __stcs(yd + f, from_float<DST, SR>(to_float<SRC>(load_src<SRC>(xs + f)), r));
}

// UNROLL vectors per thread, every load issued before the first store;
// GUARD masks the units past hi (the share's last round)
template <int SRC, int DST, bool SR, bool GUARD>
__device__ __forceinline__ void vec_round(const typename Store<SRC>::U* xs,
                                          typename Store<DST>::U* yd, int64_t j0, int64_t hi,
                                          const Tiles& tl) {
  constexpr int U = SR ? SR_UNROLL : UNROLL;
  Chunk<SRC> in[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t j = j0 + (int64_t)u * THREADS;
    if (!GUARD || j < hi) load_chunk<SRC>(in[u], xs + j * CHUNK);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t j = j0 + (int64_t)u * THREADS;
    if (!GUARD || j < hi) {
      Chunk<DST> out;
      if constexpr (SR)
        convert_sr<DST>(in[u], out, j * CHUNK, tl);
      else
        convert<SRC, DST>(in[u], out);
      store_chunk<DST>(yd + j * CHUNK, out);
    }
  }
}

// The plan's walk (ops/reduce_ops.py stream_plan): CTA c takes the
// blocks c, c + gridDim.x, ... of STEP units (THREADS x UNROLL or
// SR_UNROLL CHUNK-element vectors when VEC, both pointers 16-byte
// aligned; else THREADS elements); the plan launches one CTA per block,
// so each CTA takes one.
// When VEC the last CTA also casts the n mod CHUNK elements past the last
// vector.
template <int SRC, int DST, bool SR, bool VEC>
__global__ void __launch_bounds__(THREADS) cast_kernel(const void* x, void* y, int64_t n,
                                                      int64_t tile, uint32_t seed) {
  using S = typename Store<SRC>::U;
  using D = typename Store<DST>::U;
  const S* xs = (const S*)x;
  D* yd = (D*)y;
  const Tiles tl{tile, seed};
  if (VEC) {
    const int64_t units = n / CHUNK;
    constexpr int64_t STEP = (int64_t)THREADS * (SR ? SR_UNROLL : UNROLL);
    int64_t j = (int64_t)blockIdx.x * STEP + threadIdx.x;
    for (; j - threadIdx.x + STEP <= units; j += (int64_t)gridDim.x * STEP)
      vec_round<SRC, DST, SR, false>(xs, yd, j, units, tl);
    if (j < units) vec_round<SRC, DST, SR, true>(xs, yd, j, units, tl);
    const int64_t f = units * CHUNK + threadIdx.x;
    if (blockIdx.x == gridDim.x - 1 && f < n) cast_one<SRC, DST, SR>(xs, yd, f, tl);
  } else {
    for (int64_t f = (int64_t)blockIdx.x * THREADS + threadIdx.x; f < n;
         f += (int64_t)gridDim.x * THREADS)
      cast_one<SRC, DST, SR>(xs, yd, f, tl);
  }
}

template <int S, int D, bool R>
void* kernel_for(bool vec) {
  return vec ? (void*)cast_kernel<S, D, R, true> : (void*)cast_kernel<S, D, R, false>;
}

// The instantiation of a pair the lanes take, null for any other
void* pick(int src, int dst, bool stochastic, bool vec) {
  if (src == DT_F32 && !stochastic) {
    if (dst == DT_F16) return kernel_for<DT_F32, DT_F16, false>(vec);
    if (dst == DT_BF16) return kernel_for<DT_F32, DT_BF16, false>(vec);
  } else if (src == DT_F32) {
    if (dst == DT_BF16) return kernel_for<DT_F32, DT_BF16, true>(vec);
    if (dst == DT_E5M2) return kernel_for<DT_F32, DT_E5M2, true>(vec);
    if (dst == DT_E4M3) return kernel_for<DT_F32, DT_E4M3, true>(vec);
  } else if (dst == DT_F32 && !stochastic) {
    if (src == DT_F16) return kernel_for<DT_F16, DT_F32, false>(vec);
    if (src == DT_BF16) return kernel_for<DT_BF16, DT_F32, false>(vec);
    if (src == DT_E5M2) return kernel_for<DT_E5M2, DT_F32, false>(vec);
    if (src == DT_E4M3) return kernel_for<DT_E4M3, DT_F32, false>(vec);
  }
  return nullptr;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* accl_compression_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The kernel of (src, dst, stochastic, vec): out[0] registers a thread,
// out[1] local bytes a thread, out[2] CTAs of THREADS that fit on one SM
int accl_cast_kernel_info(int src, int dst, int stochastic, int vec, int device, int* out) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t e;
  void* fn = pick(src, dst, stochastic != 0, vec != 0);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per_sm;
  return 0;
}

// y = x cast from type src to type dst over n elements in `grid` CTAs,
// each a contiguous share of the units: CHUNK-element vectors when vec
// (both pointers 16-byte aligned), else elements.  Stochastic rounding
// draws element i of tile t (tiles of `tile` elements, block_rows x cols)
// from seed + t.  Pairs: f32 -> f16, bf16 (nearest even); f32 -> bf16,
// e5m2, e4m3fn (stochastic); f16, bf16, e5m2, e4m3fn -> f32.
int accl_cast(const void* x, void* y, long long n, long long tile, int src, int dst,
              int stochastic, unsigned int seed, int vec, int grid, int device, void* stream) {
  if (n < 0 || tile < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  void* fn = pick(src, dst, stochastic != 0, vec != 0);
  if (!fn) return (int)cudaErrorInvalidValue;
  if (vec && !(aligned16(x) && aligned16(y))) return (int)cudaErrorInvalidValue;
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t e;
  if (n == 0) return (int)cudaSuccess;
  long long tl = tile;
  void* args[] = {(void*)&x, (void*)&y, (void*)&n, (void*)&tl, (void*)&seed};
  e = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
