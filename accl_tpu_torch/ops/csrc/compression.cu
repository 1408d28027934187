// Streaming casts between fp32 and the wire's narrow types: the
// hp_compression plugin lanes.  fp32 -> fp16 / bf16 rounding to nearest
// even, fp32 -> bf16 / fp8 (e5m2, e4m3fn) rounding stochastically, and
// fp16 / bf16 / fp8 -> fp32.
//
// Replaces the Pallas TPU kernel _cast_2d (_cast_kernel and
// _stochastic_kernel, accl_tpu/ops/compression.py:54, calls :72 and :84)
// and its tuning copy cast2d (scripts/kernel_tune.py:96, call :102).  The
// TPU grid walks block_rows-row tiles of a [rows, cols] view; here one CTA
// owns one tile (the last may be ragged) and its 256 threads stride over
// it in chunks of 8 elements, UNROLL chunks in flight per thread, loading
// and storing 8-32 bytes at a time.  Rows and columns are launch
// parameters, so the tuning sweep's geometries are this kernel's.
//
// Rounding to nearest even uses __float2half_rn / __float2bfloat16_rn,
// which is what Tensor.to does on the card (NaN, inf, overflow and fp16
// subnormals included).  Stochastic rounding has no PRNG stream to copy:
// the TPU seeds its core PRNG with seed + tile index per grid step
// (compression.py:42-47).  Here the random bits of element i of tile t are
// a counter-based hash, fmix32(fmix32(seed + t) ^ (i * 0x9E3779B1)) (the
// murmur3 finalizer), which the plain version in compression.py computes
// with integer tensor ops, so the kernel is held to it bit for bit.  The
// rounding: with m the 24-bit significand of |x| and k the bits below the
// target's last mantissa bit at |x|'s exponent (16 for bf16; more for fp8
// and below its normal range), n = (m + R) >> k, where R is the low k bits
// of the hash (k <= 32) or the hash shifted up by k - 32 (k <= 63; n = 0
// beyond), and the result n * 2^(e - 23 + k) is exact in the target.  It
// rounds up with probability (m mod 2^k) / 2^k.  Past the target's range
// bf16 and e5m2 give inf and e4m3fn saturates at +-448.  The seed is an
// argument: stepping it rebuilds nothing.
//
// What bounds it on this card: bytes.  Each element is read once and
// written once (4 + 2 bytes either way for the fp16/bf16 lanes): at the
// bench shape ([131072, 512] fp32) each direction moves 384 MiB, 0.120 ms
// at 3.35 TB/s.  The hash is ~12 integer operations an element, far under
// what the card does in that time.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int CHUNK = 8;  // elements per vector step

enum { DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2, DT_E5M2 = 3, DT_E4M3 = 4 };

// Storage of each type as plain bits
template <int DT> struct Store;
template <> struct Store<DT_F32> { using U = uint32_t; };
template <> struct Store<DT_F16> { using U = uint16_t; };
template <> struct Store<DT_BF16> { using U = uint16_t; };
template <> struct Store<DT_E5M2> { using U = uint8_t; };
template <> struct Store<DT_E4M3> { using U = uint8_t; };

template <int DT> __device__ __forceinline__ float to_float(typename Store<DT>::U b);
template <> __device__ __forceinline__ float to_float<DT_F32>(uint32_t b) { return __uint_as_float(b); }
template <> __device__ __forceinline__ float to_float<DT_F16>(uint16_t b) {
  return __half2float(__ushort_as_half(b));
}
template <> __device__ __forceinline__ float to_float<DT_BF16>(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
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

// x rounded stochastically to a format with M mantissa bits and least
// normal exponent EMIN, as an fp32 value (exact in the format unless it
// is past the format's range); inf and NaN pass through
template <int M, int EMIN>
__device__ __forceinline__ float stochastic_value(float x, uint32_t r) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t mag = u & 0x7fffffffu;
  if (mag >= 0x7f800000u) return x;
  const int E = (int)(mag >> 23);
  const int e = (E > 0 ? E : 1) - 127;
  const uint64_t m = (mag & 0x7fffffu) | (E > 0 ? 0x800000u : 0u);
  const int k = 23 - M + (EMIN > e ? EMIN - e : 0);
  uint64_t n = 0;
  if (k <= 63) {
    const uint64_t R = k <= 32 ? (uint64_t)(r & (uint32_t)((1ull << k) - 1))
                               : ((uint64_t)r << (k - 32));
    n = (m + R) >> k;
  }
  const float v = ldexpf((float)n, e - 23 + k);
  return (u >> 31) ? -v : v;
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
  return __bfloat16_as_ushort(__float2bfloat16_rn(stochastic_value<7, -126>(v, r)));
}
template <> __device__ __forceinline__ uint8_t from_float<DT_E5M2, true>(float v, uint32_t r) {
  return encode_e5m2(stochastic_value<2, -14>(v, r));
}
template <> __device__ __forceinline__ uint8_t from_float<DT_E4M3, true>(float v, uint32_t r) {
  return encode_e4m3(stochastic_value<3, -6>(v, r));
}

// CHUNK elements of one type as their bits, loadable as 8-32 bytes
template <int BYTES> struct Raw;
template <> struct Raw<8> { using W = uint2; static constexpr int N = 1; W w[N]; };
template <> struct Raw<16> { using W = uint4; static constexpr int N = 1; W w[N]; };
template <> struct Raw<32> { using W = uint4; static constexpr int N = 2; W w[N]; };
template <int DT>
union Chunk {
  using R = Raw<CHUNK * sizeof(typename Store<DT>::U)>;
  R raw;
  typename Store<DT>::U e[CHUNK];
};

template <int DT>
__device__ __forceinline__ void load_chunk(Chunk<DT>& c, const typename Store<DT>::U* p) {
  using R = typename Chunk<DT>::R;
  const typename R::W* src = reinterpret_cast<const typename R::W*>(p);
#pragma unroll
  for (int i = 0; i < R::N; ++i) c.raw.w[i] = src[i];
}
template <int DT>
__device__ __forceinline__ void store_chunk(typename Store<DT>::U* p, const Chunk<DT>& c) {
  using R = typename Chunk<DT>::R;
  typename R::W* dst = reinterpret_cast<typename R::W*>(p);
#pragma unroll
  for (int i = 0; i < R::N; ++i) dst[i] = c.raw.w[i];
}

// One CTA per block_rows-row tile of the [rows, cols] view.  VEC: every
// tile starts on a CHUNK boundary and both pointers are 16-byte aligned.
template <int SRC, int DST, bool SR, bool VEC>
__global__ void __launch_bounds__(THREADS) cast_kernel(const void* x, void* y, int64_t rows,
                                                      int64_t cols, int64_t block_rows,
                                                      uint32_t seed) {
  using S = typename Store<SRC>::U;
  using D = typename Store<DST>::U;
  const int64_t r0 = (int64_t)blockIdx.x * block_rows;
  const int64_t r1 = r0 + block_rows < rows ? r0 + block_rows : rows;
  const int64_t begin = r0 * cols, count = (r1 - r0) * cols;
  const S* xs = (const S*)x + begin;
  D* yd = (D*)y + begin;
  const uint32_t key = SR ? fmix32(seed + (uint32_t)blockIdx.x) : 0u;
  int64_t done = 0;
  if (VEC) {
    const int64_t nc = count / CHUNK;
    for (int64_t i = threadIdx.x; i < nc; i += (int64_t)THREADS * UNROLL) {
      Chunk<SRC> in[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t j = i + (int64_t)u * THREADS;
        if (j < nc) load_chunk<SRC>(in[u], xs + j * CHUNK);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t j = i + (int64_t)u * THREADS;
        if (j < nc) {
          Chunk<DST> out;
#pragma unroll
          for (int e = 0; e < CHUNK; ++e) {
            const uint32_t idx = (uint32_t)(j * CHUNK + e);
            const uint32_t r = SR ? fmix32(key ^ (idx * 0x9e3779b1u)) : 0u;
            out.e[e] = from_float<DST, SR>(to_float<SRC>(in[u].e[e]), r);
          }
          store_chunk<DST>(yd + j * CHUNK, out);
        }
      }
    }
    done = nc * CHUNK;
  }
  for (int64_t i = done + threadIdx.x; i < count; i += THREADS) {
    const uint32_t r = SR ? fmix32(key ^ ((uint32_t)i * 0x9e3779b1u)) : 0u;
    yd[i] = from_float<DST, SR>(to_float<SRC>(xs[i]), r);
  }
}

template <int SRC, int DST, bool SR>
cudaError_t launch(const void* x, void* y, int64_t rows, int64_t cols, int64_t block_rows,
                   uint32_t seed, cudaStream_t stream) {
  const int64_t tiles = (rows + block_rows - 1) / block_rows;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const bool vec = ((((uintptr_t)x | (uintptr_t)y) & 15) == 0) && (block_rows * cols) % CHUNK == 0;
  if (vec)
    cast_kernel<SRC, DST, SR, true><<<(unsigned)tiles, THREADS, 0, stream>>>(x, y, rows, cols,
                                                                            block_rows, seed);
  else
    cast_kernel<SRC, DST, SR, false><<<(unsigned)tiles, THREADS, 0, stream>>>(x, y, rows, cols,
                                                                             block_rows, seed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* accl_compression_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// y = x cast from type src to type dst over a [rows, cols] view in tiles
// of block_rows rows; stochastic rounding seeded per tile with seed + tile.
// Pairs: f32 -> f16, bf16 (nearest even); f32 -> bf16, e5m2, e4m3fn
// (stochastic); f16, bf16, e5m2, e4m3fn -> f32.
int accl_cast(const void* x, void* y, long long rows, long long cols, long long block_rows,
              int src, int dst, int stochastic, unsigned int seed, int device, void* stream) {
  if (rows < 0 || cols < 0 || block_rows < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
#define ACCL_CAST(S, D, R) launch<S, D, R>(x, y, rows, cols, block_rows, seed, st)
  if (src == DT_F32 && !stochastic) {
    if (dst == DT_F16) return (int)ACCL_CAST(DT_F32, DT_F16, false);
    if (dst == DT_BF16) return (int)ACCL_CAST(DT_F32, DT_BF16, false);
  } else if (src == DT_F32) {
    if (dst == DT_BF16) return (int)ACCL_CAST(DT_F32, DT_BF16, true);
    if (dst == DT_E5M2) return (int)ACCL_CAST(DT_F32, DT_E5M2, true);
    if (dst == DT_E4M3) return (int)ACCL_CAST(DT_F32, DT_E4M3, true);
  } else if (dst == DT_F32 && !stochastic) {
    if (src == DT_F16) return (int)ACCL_CAST(DT_F16, DT_F32, false);
    if (src == DT_BF16) return (int)ACCL_CAST(DT_BF16, DT_F32, false);
    if (src == DT_E5M2) return (int)ACCL_CAST(DT_E5M2, DT_F32, false);
    if (src == DT_E4M3) return (int)ACCL_CAST(DT_E4M3, DT_F32, false);
  }
#undef ACCL_CAST
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
