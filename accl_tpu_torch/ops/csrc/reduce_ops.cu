// Elementwise sum or max of two [rows, 128] tiles: the reduce_ops plugin
// lane (one lane per (dtype, function): fp32, fp64, int32, int64, fp16 and
// bf16, each by sum and by max).
//
// Replaces the Pallas TPU kernel _pallas_combine_2d (_kernel_add,
// _kernel_max; accl_tpu/ops/reduce_ops.py:39, call :49).  The TPU grid
// walks block_rows-row tiles of the [rows, 128] view through VMEM.  Here
// the tiles do not shape the launch: the operands are one flat run of
// 16-byte vectors, and the wrapper's plan (ops/reduce_ops.py stream_plan)
// launches one CTA of THREADS threads per THREADS vectors, one a thread,
// which the card schedules as SMs free up; the kernel walks grid-stride,
// so a smaller grid would be right too.  Loads and stores are streaming
// (ld.global.cs / st.global.cs): no byte is read twice and the operands
// are several times the L2.  Measured on the H100 at the bench shape
// (fp32 sum; PERF.md): one resident wave of CTAs, each walking a
// contiguous share, ran ~14 % slower than this, the same wave walking
// interleaved rounds ~5 % slower, and 2-4 vectors a thread 0.4-0.6 %
// slower.  Pointers that are not
// 16-byte aligned take the same walk over single elements.  With the
// output aliased to operand a (donate), every element is read and then
// written by the same thread, and a is never read through the
// non-coherent path, so the in-place form needs no extra care.
//
// Numerics are those of PyTorch on the card: an integer sum wraps, an
// fp16/bf16 sum is the float sum of the two values rounded once to the
// type (the exact sum rounded once: fp32 holds 2p+2 bits of either type,
// so the double rounding is innocuous), and max is torch.maximum's (a NaN
// operand wins, else a < b ? b : a).
//
// What bounds it on this card: bytes.  It reads two operands and writes
// one, one operation per element: at the bench shape ([524288, 128] fp32)
// 3 x 256 MiB over 3.35 TB/s is 0.240 ms.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "current_device.cuh"

#include <type_traits>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int VEC_BYTES = 16;

enum { DT_F32 = 0, DT_F64 = 1, DT_I32 = 2, DT_I64 = 3, DT_F16 = 4, DT_BF16 = 5 };

// Elements travel as their bits (plain unsigned storage), so a 16-byte
// vector can be a union of them; 64-bit lanes as unsigned long long, the
// type the streaming load and store intrinsics take.
using u64 = unsigned long long;
template <typename T> struct Bits;
template <> struct Bits<float> { using U = uint32_t; };
template <> struct Bits<double> { using U = u64; };
template <> struct Bits<int32_t> { using U = uint32_t; };
template <> struct Bits<int64_t> { using U = u64; };
template <> struct Bits<__half> { using U = uint16_t; };
template <> struct Bits<__nv_bfloat16> { using U = uint16_t; };

template <typename T> __device__ __forceinline__ T from_bits(typename Bits<T>::U u);
template <> __device__ __forceinline__ float from_bits<float>(uint32_t u) { return __uint_as_float(u); }
template <> __device__ __forceinline__ double from_bits<double>(u64 u) {
  return __longlong_as_double((long long)u);
}
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t u) { return (int32_t)u; }
template <> __device__ __forceinline__ int64_t from_bits<int64_t>(u64 u) { return (int64_t)u; }
template <> __device__ __forceinline__ __half from_bits<__half>(uint16_t u) { return __ushort_as_half(u); }
template <> __device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(uint16_t u) {
  return __ushort_as_bfloat16(u);
}

__device__ __forceinline__ uint32_t to_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ u64 to_bits(double x) { return (u64)__double_as_longlong(x); }
__device__ __forceinline__ uint32_t to_bits(int32_t x) { return (uint32_t)x; }
__device__ __forceinline__ u64 to_bits(int64_t x) { return (u64)x; }
__device__ __forceinline__ uint16_t to_bits(__half x) { return __half_as_ushort(x); }
__device__ __forceinline__ uint16_t to_bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// a + b as PyTorch computes it for the type
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int64_t add(int64_t a, int64_t b) {
  return (int64_t)((u64)a + (u64)b);
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

// The plan's walk (ops/reduce_ops.py stream_plan): thread g of the grid
// takes the units g, g + gridDim.x x THREADS, ...: 16-byte vectors when
// VEC (every pointer 16-byte aligned), else elements; the plan launches
// one CTA per THREADS units, so each thread takes one.
template <typename T, bool MAX, bool VEC>
__global__ void __launch_bounds__(THREADS) combine_kernel(const T* a, const T* b, T* out,
                                                         int64_t units) {
  using U = typename Bits<T>::U;
  using W = std::conditional_t<VEC, uint4, U>;
  union Unit {
    W w;
    U e[sizeof(W) / sizeof(U)];
  };
  const W* aw = reinterpret_cast<const W*>(a);
  const W* bw = reinterpret_cast<const W*>(b);
  W* ow = reinterpret_cast<W*>(out);
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < units;
       j += (int64_t)gridDim.x * THREADS) {
    Unit x, y;
    x.w = __ldcs(aw + j);
    y.w = __ldcs(bw + j);
#pragma unroll
    for (int e = 0; e < (int)(sizeof(W) / sizeof(U)); ++e) x.e[e] = combine<T, MAX>(x.e[e], y.e[e]);
    __stcs(ow + j, x.w);
  }
}

template <typename T>
void* kernel_for(bool is_max, bool vec) {
  if (is_max)
    return vec ? (void*)combine_kernel<T, true, true> : (void*)combine_kernel<T, true, false>;
  return vec ? (void*)combine_kernel<T, false, true> : (void*)combine_kernel<T, false, false>;
}

// The instantiation for (dtype, is_max, vec), null for an unknown dtype
void* pick(int dtype, bool is_max, bool vec, int* elem) {
  switch (dtype) {
    case DT_F32: *elem = 4; return kernel_for<float>(is_max, vec);
    case DT_F64: *elem = 8; return kernel_for<double>(is_max, vec);
    case DT_I32: *elem = 4; return kernel_for<int32_t>(is_max, vec);
    case DT_I64: *elem = 8; return kernel_for<int64_t>(is_max, vec);
    case DT_F16: *elem = 2; return kernel_for<__half>(is_max, vec);
    case DT_BF16: *elem = 2; return kernel_for<__nv_bfloat16>(is_max, vec);
    default: return nullptr;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* accl_reduce_ops_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The kernel of (dtype, is_max, vec): out[0] registers a thread, out[1]
// local bytes a thread, out[2] CTAs of THREADS that fit on one SM
int accl_combine_kernel_info(int dtype, int is_max, int vec, int device, int* out) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t e;
  int elem;
  void* fn = pick(dtype, is_max != 0, vec != 0, &elem);
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

// out = a + b (is_max 0) or maximum(a, b) (is_max 1) over n elements (n a
// multiple of LANES, the [rows, 128] view flattened) in `grid` CTAs, each
// a contiguous share of the units: 16-byte vectors when vec (every
// pointer 16-byte aligned), else elements.  out may be a (donate).
int accl_combine(const void* a, const void* b, void* out, long long n, int dtype, int is_max,
                 int vec, int grid, int device, void* stream) {
  if (n < 0 || n % LANES != 0 || grid < 1) return (int)cudaErrorInvalidValue;
  int elem;
  void* fn = pick(dtype, is_max != 0, vec != 0, &elem);
  if (!fn) return (int)cudaErrorInvalidValue;
  if (vec && !(aligned16(a) && aligned16(b) && aligned16(out))) return (int)cudaErrorInvalidValue;
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t e;
  if (n == 0) return (int)cudaSuccess;
  long long units = vec ? n / (VEC_BYTES / elem) : n;
  void* args[] = {(void*)&a, (void*)&b, (void*)&out, (void*)&units};
  e = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
