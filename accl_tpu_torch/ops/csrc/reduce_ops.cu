// Elementwise sum or max of two [rows, 128] tiles: the reduce_ops plugin
// lane (one lane per (dtype, function): fp32, fp64, int32, int64, fp16 and
// bf16, each by sum and by max).
//
// Replaces the Pallas TPU kernel _pallas_combine_2d (_kernel_add,
// _kernel_max; accl_tpu/ops/reduce_ops.py:39, call :49).  The TPU grid
// walks block_rows-row tiles of the [rows, 128] view through VMEM; here
// one CTA owns one such tile (the last one may be ragged: the kernel reads
// no row past `rows`) and its 256 threads stride over it with 16-byte
// loads and stores, UNROLL of each in flight per thread.  With the output
// aliased to operand a (donate), every element is read and then written by
// the same thread, so the in-place form needs no extra care.
//
// Numerics are those of PyTorch on the card: an integer sum wraps, an
// fp16/bf16 sum is the float sum of the two values rounded once to the
// type (the exact sum rounded once: fp32 holds 2p+2 bits of either type,
// so the double rounding is innocuous), and max is torch.maximum's (a NaN
// operand wins, else a < b ? b : a).
//
// What bounds it on this card: bytes.  It reads two operands and writes
// one, one operation per element: at the bench shape ([524288, 128] fp32)
// 3 x 256 MiB over 3.35 TB/s is 0.240 ms.  The design keeps enough bytes
// in flight (4 x 16 B loads per operand per thread) to stream at that
// rate; it does nothing else.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;

enum { DT_F32 = 0, DT_F64 = 1, DT_I32 = 2, DT_I64 = 3, DT_F16 = 4, DT_BF16 = 5 };

// Elements travel as their bits (plain unsigned storage), so a 16-byte
// vector can be a union of them.
template <typename T> struct Bits;
template <> struct Bits<float> { using U = uint32_t; };
template <> struct Bits<double> { using U = uint64_t; };
template <> struct Bits<int32_t> { using U = uint32_t; };
template <> struct Bits<int64_t> { using U = uint64_t; };
template <> struct Bits<__half> { using U = uint16_t; };
template <> struct Bits<__nv_bfloat16> { using U = uint16_t; };

template <typename T> __device__ __forceinline__ T from_bits(typename Bits<T>::U u);
template <> __device__ __forceinline__ float from_bits<float>(uint32_t u) { return __uint_as_float(u); }
template <> __device__ __forceinline__ double from_bits<double>(uint64_t u) {
  return __longlong_as_double((long long)u);
}
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t u) { return (int32_t)u; }
template <> __device__ __forceinline__ int64_t from_bits<int64_t>(uint64_t u) { return (int64_t)u; }
template <> __device__ __forceinline__ __half from_bits<__half>(uint16_t u) { return __ushort_as_half(u); }
template <> __device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(uint16_t u) {
  return __ushort_as_bfloat16(u);
}

__device__ __forceinline__ uint32_t to_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint64_t to_bits(double x) { return (uint64_t)__double_as_longlong(x); }
__device__ __forceinline__ uint32_t to_bits(int32_t x) { return (uint32_t)x; }
__device__ __forceinline__ uint64_t to_bits(int64_t x) { return (uint64_t)x; }
__device__ __forceinline__ uint16_t to_bits(__half x) { return __half_as_ushort(x); }
__device__ __forceinline__ uint16_t to_bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// a + b as PyTorch computes it for the type
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int64_t add(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ __half add(__half a, __half b) {
  return __float2half_rn(__fadd_rn(__half2float(a), __half2float(b)));
}
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// torch.maximum: a NaN operand wins (a first), else std::max
__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool is_nan(double x) { return x != x; }
__device__ __forceinline__ bool is_nan(int32_t) { return false; }
__device__ __forceinline__ bool is_nan(int64_t) { return false; }
__device__ __forceinline__ bool is_nan(__half x) { return is_nan(__half2float(x)); }
__device__ __forceinline__ bool is_nan(__nv_bfloat16 x) { return is_nan(__bfloat162float(x)); }
__device__ __forceinline__ bool less(float a, float b) { return a < b; }
__device__ __forceinline__ bool less(double a, double b) { return a < b; }
__device__ __forceinline__ bool less(int32_t a, int32_t b) { return a < b; }
__device__ __forceinline__ bool less(int64_t a, int64_t b) { return a < b; }
__device__ __forceinline__ bool less(__half a, __half b) { return __half2float(a) < __half2float(b); }
__device__ __forceinline__ bool less(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __bfloat162float(a) < __bfloat162float(b);
}
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return less(a, b) ? b : a;
}

template <typename T, bool MAX>
__device__ __forceinline__ typename Bits<T>::U combine(typename Bits<T>::U x,
                                                       typename Bits<T>::U y) {
  const T a = from_bits<T>(x), b = from_bits<T>(y);
  return to_bits(MAX ? maximum(a, b) : add(a, b));
}

template <typename T>
union Vec16 {
  uint4 v;
  typename Bits<T>::U e[16 / sizeof(T)];
};

// One CTA per block_rows-row tile of the [rows, 128] view.  VEC: every
// pointer is 16-byte aligned (a tile is a whole number of 16-byte vectors:
// 128 columns of 2 bytes or more).
template <typename T, bool MAX, bool VEC>
__global__ void __launch_bounds__(THREADS) combine_kernel(const T* a, const T* b, T* out,
                                                         int64_t rows, int64_t block_rows) {
  using U = typename Bits<T>::U;
  const int64_t r0 = (int64_t)blockIdx.x * block_rows;
  const int64_t r1 = r0 + block_rows < rows ? r0 + block_rows : rows;
  const int64_t begin = r0 * LANES, count = (r1 - r0) * LANES;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int64_t nv = count / V;
    const uint4* av = reinterpret_cast<const uint4*>(a + begin);
    const uint4* bv = reinterpret_cast<const uint4*>(b + begin);
    uint4* ov = reinterpret_cast<uint4*>(out + begin);
    for (int64_t i = threadIdx.x; i < nv; i += (int64_t)THREADS * UNROLL) {
      Vec16<T> x[UNROLL], y[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t j = i + (int64_t)u * THREADS;
        if (j < nv) {
          x[u].v = av[j];
          y[u].v = bv[j];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t j = i + (int64_t)u * THREADS;
        if (j < nv) {
#pragma unroll
          for (int e = 0; e < V; ++e) x[u].e[e] = combine<T, MAX>(x[u].e[e], y[u].e[e]);
          ov[j] = x[u].v;
        }
      }
    }
  } else {
    const U* au = reinterpret_cast<const U*>(a + begin);
    const U* bu = reinterpret_cast<const U*>(b + begin);
    U* ou = reinterpret_cast<U*>(out + begin);
    for (int64_t i = threadIdx.x; i < count; i += THREADS)
      ou[i] = combine<T, MAX>(au[i], bu[i]);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, int64_t rows, int64_t block_rows,
                   bool is_max, cudaStream_t stream) {
  const int64_t tiles = (rows + block_rows - 1) / block_rows;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const bool vec = (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15) == 0;
  const T* at = (const T*)a;
  const T* bt = (const T*)b;
  T* ot = (T*)out;
  const dim3 grid((unsigned)tiles);
  if (is_max) {
    if (vec)
      combine_kernel<T, true, true><<<grid, THREADS, 0, stream>>>(at, bt, ot, rows, block_rows);
    else
      combine_kernel<T, true, false><<<grid, THREADS, 0, stream>>>(at, bt, ot, rows, block_rows);
  } else {
    if (vec)
      combine_kernel<T, false, true><<<grid, THREADS, 0, stream>>>(at, bt, ot, rows, block_rows);
    else
      combine_kernel<T, false, false><<<grid, THREADS, 0, stream>>>(at, bt, ot, rows, block_rows);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* accl_reduce_ops_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out = a + b (is_max 0) or maximum(a, b) (is_max 1) over a [rows, 128]
// view in tiles of block_rows rows; out may be a (donate).
int accl_combine(const void* a, const void* b, void* out, long long rows, long long block_rows,
                 int dtype, int is_max, int device, void* stream) {
  if (rows < 0 || block_rows < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool mx = is_max != 0;
  switch (dtype) {
    case DT_F32: return (int)launch<float>(a, b, out, rows, block_rows, mx, st);
    case DT_F64: return (int)launch<double>(a, b, out, rows, block_rows, mx, st);
    case DT_I32: return (int)launch<int32_t>(a, b, out, rows, block_rows, mx, st);
    case DT_I64: return (int)launch<int64_t>(a, b, out, rows, block_rows, mx, st);
    case DT_F16: return (int)launch<__half>(a, b, out, rows, block_rows, mx, st);
    case DT_BF16: return (int)launch<__nv_bfloat16>(a, b, out, rows, block_rows, mx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
