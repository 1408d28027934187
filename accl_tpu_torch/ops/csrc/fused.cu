// Tiled matmul, and the ring reduce-scatter of per-rank partial products
// with the matmul inside the ring loop, over P ranks that share one card.
//
// Replaces the Pallas TPU kernels pallas_matmul (_matmul_kernel,
// accl_tpu/ops/fused.py:341) and fused_matmul_reduce_scatter_pallas
// (accl_tpu/ops/fused.py:476).
//
//  * accl_matmul: out[m, n] = x[m, k] @ w[k, n], inputs float32 or
//    bfloat16, fp32 accumulation and output.  The TPU kernel takes full-K
//    256x256 output blocks into VMEM and hands them to the MXU; here each
//    block computes a 128x128 output tile, walking K in slices of 8
//    staged through shared memory, and each thread keeps an 8x8 tile of
//    fp32 accumulators in registers.
//  * accl_fused_matmul_rs: rank r holds x_r [P, m, k] and w_r [k, n] and
//    ends with row block r of sum_q x_q @ w_q, [m, n] fp32.  On the TPU
//    each rank is a chip and a hop is a remote DMA of the accumulator
//    while the MXU computes the next partial.  Here each rank is a group
//    of thread blocks, each block owns a stripe of the [m, n] output tiles
//    and runs its own ring over that stripe, and a hop is a store into
//    the right neighbour's double-buffered landing slot in device memory,
//    published with a release-ordered flag (the machinery of ring.cu,
//    shared through ring_sync.cuh).  Per stripe and hop s: the fold of
//    hop s-1 (acc_0 = x[my-1] @ w at the start) has just been written
//    into the right neighbour's slot s % 2 and published; the block then
//    computes prod = x[my-2-s] @ w for its stripe into a per-rank scratch,
//    waits with acquire for its own slot s % 2, and folds
//    acc = prod + landing[slot] straight into the right neighbour's next
//    slot (the last hop into the output), then ACKs the slot to the left
//    neighbour under rs_signals_ack.  The fold nesting is the Pallas
//    kernel's, so with products and partial sums exact in fp32 (small
//    integer inputs) the result is bitwise equal to it.
//
// What bounds them on this card: operations.  At the main path's shapes
// (MLP-down of Llama-3-8B at TP=8: x [4096, 1792] @ w [1792, 4096] per
// rank) a matmul does ~480 fp32 operations per byte it must move; an
// H100 needs ~20 (fp32, 67 TFLOP/s over 3.35 TB/s) before arithmetic
// binds.  Neither kernel uses TF32 or the tensor cores: a full fp32 FMA
// chain per output element, in k order, is the reference's numerics
// (preferred_element_type=float32 on f32 inputs).  The design keeps
// operands in shared memory and accumulators in registers, 64 FMAs per
// pair of shared-memory fragment loads.  Tensor cores for bf16 (wgmma),
// TMA staging and double buffering are later work.
//
// Correctness rules the fused kernel keeps (as ring.cu):
//  * all blocks spin on flags other blocks set, so the launch is
//    cooperative, and the stripe count comes from the occupancy query for
//    this kernel (its static shared memory included): the runtime refuses
//    a grid that cannot be co-resident instead of letting it deadlock;
//  * flags are zeroed on the launch stream before every launch, and waits
//    compare against per-launch counts;
//  * landing slots are read through L2 (__ldcg): L1 is not coherent
//    across SMs and a slot's address recurs every second hop;
//  * each wait traps after 10 s counted from its own start, so a broken
//    handshake fails the launch while long hops (a stripe's matmul takes
//    on the order of a millisecond) do not;
//  * every offset is 64-bit.
#include <cuda_bf16.h>

#include "ring_sync.cuh"

#define BM 128
#define BN 128
#define BK 8
#define TM 8
#define TN 8
#define MM_THREADS 256  // (BM / TM) * (BN / TN)

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct TileSmem {
  float a[BK][BM];  // x slice, transposed: a[kk][row]
  float b[BK][BN];  // w slice: b[kk][col]
};

// acc[i][j] = sum over k, in k order, of x[row0 + ty*TM + i][k] *
// w[k][col0 + tx*TN + j] with fp32 FMA; rows, columns and k past the
// edges read as zero.  Ends with a barrier, so sm may be refilled.
template <typename T>
__device__ __forceinline__ void tile_product(const T* __restrict__ x, const T* __restrict__ w,
                                             int64_t m, int64_t n, int64_t k, int64_t row0,
                                             int64_t col0, TileSmem& sm, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int ar = tid >> 1, ac = (tid & 1) * 4;   // x slice: 128 rows x 8, 4 a thread
  const int br = tid >> 5, bc = (tid & 31) * 4;  // w slice: 8 x 128 cols, 4 a thread
  const int64_t gr = row0 + ar;
  for (int64_t k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t gk = k0 + ac + i;
      sm.a[ac + i][ar] = (gr < m && gk < k) ? to_f32(x[gr * k + gk]) : 0.f;
    }
    const int64_t gk = k0 + br;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t gc = col0 + bc + i;
      sm.b[br][bc + i] = (gk < k && gc < n) ? to_f32(w[gk * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[kk][tx * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store_tile(float* out, int64_t m, int64_t n, int64_t row0,
                                           int64_t col0, const float (&acc)[TM][TN]) {
  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty * TM + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + tx * TN + j;
      if (gc < n) out[gr * n + gc] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------------
// accl_matmul: one block per 128x128 output tile
// ------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(MM_THREADS, 2)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ out,
              int64_t m, int64_t n, int64_t k) {
  __shared__ __align__(16) TileSmem sm;
  const int64_t row0 = (int64_t)blockIdx.y * BM, col0 = (int64_t)blockIdx.x * BN;
  float acc[TM][TN];
  tile_product<T>(x, w, m, n, k, row0, col0, sm, acc);
  store_tile(out, m, n, row0, col0, acc);
}

// ------------------------------------------------------------------------
// accl_fused_matmul_rs.  Flags: filled[P][S][2] then ack[P][S][2] (int32),
// as in ring.cu.  Block b plays rank b / S on tile stripe b % S: tiles
// [t0, t1) of the row-major tile grid of the [m, n] output.
// ------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void stripe_product(const T* xc, const T* w, int64_t m, int64_t n,
                                               int64_t k, int64_t t0, int64_t t1,
                                               int64_t tiles_n, TileSmem& sm, float* dst) {
  float acc[TM][TN];
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t row0 = (t / tiles_n) * BM, col0 = (t % tiles_n) * BN;
    tile_product<T>(xc, w, m, n, k, row0, col0, sm, acc);
    store_tile(dst, m, n, row0, col0, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(MM_THREADS, 2)
fused_matmul_rs_kernel(PtrTable xs, PtrTable ws, OutTable outs, int64_t m, int64_t n, int64_t k,
                       int P, int S, float* landing, float* prod, int* flags) {
  __shared__ __align__(16) TileSmem sm;
  const int my = blockIdx.x / S, st = blockIdx.x % S;
  const int right = (my + 1) % P, left = (my + P - 1) % P;
  const int64_t tiles_n = (n + BN - 1) / BN;
  const int64_t tiles = ((m + BM - 1) / BM) * tiles_n;
  const int64_t per = (tiles + S - 1) / S;
  const int64_t t0 = (int64_t)st * per < tiles ? (int64_t)st * per : tiles;
  const int64_t t1 = t0 + per < tiles ? t0 + per : tiles;
  const int64_t mn = m * n;
  int* filled = flags;
  int* ack = flags + (int64_t)P * S * 2;
  auto F = [&](int r, int slot) { return filled + ((int64_t)r * S + st) * 2 + slot; };
  auto A = [&](int r, int slot) { return ack + ((int64_t)r * S + st) * 2 + slot; };
  auto L = [&](int r, int slot) { return landing + ((int64_t)r * 2 + slot) * mn; };
  const T* x = static_cast<const T*>(xs.p[my]);
  const T* w = static_cast<const T*>(ws.p[my]);
  float* pr = prod + (int64_t)my * mn;
  const int64_t xchunk = m * k;

  // hop 0: acc_0 = x[my - 1] @ w into the right neighbour's slot 0
  stripe_product<T>(x + (int64_t)pmod(my - 1, P) * xchunk, w, m, n, k, t0, t1, tiles_n, sm,
                    L(right, 0));
  __syncthreads();
  if (threadIdx.x == 0) add_release(F(right, 0));
  for (int s = 0; s < P - 1; ++s) {
    const int slot = s & 1;
    // the partial this hop folds, computed while the accumulator just
    // published travels to the right neighbour
    stripe_product<T>(x + (int64_t)pmod(my - 2 - s, P) * xchunk, w, m, n, k, t0, t1, tiles_n,
                      sm, pr);
    wait_geq(F(my, slot), s / 2 + 1);  // left's hop s has landed
    const float* lin = L(my, slot);
    const bool last = (s == P - 2);
    float* dst;
    if (last) {
      dst = static_cast<float*>(outs.p[my]);
    } else {
      const int ns = s + 1;
      // the right neighbour freed this slot at its fold of hop ns - 2
      if (rs_waits_ack(ns, P)) wait_geq(A(my, ns & 1), ns / 2);
      dst = L(right, ns & 1);
    }
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t row0 = (t / tiles_n) * BM, col0 = (t % tiles_n) * BN;
      for (int e = threadIdx.x; e < BM * BN; e += MM_THREADS) {
        const int64_t gr = row0 + e / BN, gc = col0 + e % BN;
        if (gr < m && gc < n) {
          const int64_t j = gr * n + gc;
          dst[j] = pr[j] + __ldcg(lin + j);  // acc = prod + landing[slot]
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (!last) add_release(F(right, (s + 1) & 1));
      // landing[slot] consumed: free it for the left neighbour's hop s + 2
      if (rs_signals_ack(s, P)) add_release(A(left, slot));
    }
  }
}

// ------------------------------------------------------------------------
// host side: plain C interface, bound with ctypes
// ------------------------------------------------------------------------
enum { DT_F32 = 0, DT_BF16 = 1 };

static void* fused_kernel_for(int dtype) {
  switch (dtype) {
    case DT_F32: return (void*)fused_matmul_rs_kernel<float>;
    case DT_BF16: return (void*)fused_matmul_rs_kernel<__nv_bfloat16>;
  }
  return nullptr;
}

extern "C" {

const char* accl_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int accl_matmul(const void* x, const void* w, void* out, int64_t m, int64_t n, int64_t k,
                int dtype, int device, void* stream) {
  if (m < 0 || n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  const int64_t gy = (m + BM - 1) / BM, gx = (n + BN - 1) / BN;
  if (gy > 65535 || gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  switch (dtype) {
    case DT_F32:
      matmul_kernel<float><<<grid, MM_THREADS, 0, st>>>(
          (const float*)x, (const float*)w, (float*)out, m, n, k);
      break;
    case DT_BF16:
      matmul_kernel<__nv_bfloat16><<<grid, MM_THREADS, 0, st>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (float*)out, m, n, k);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Tile stripes per rank for one fused launch: as many as fit co-resident
// (the occupancy query counts the kernel's static shared memory and
// registers), at most one per output tile.  Returns 0 when not even P
// blocks fit (the launch would deadlock), a negative value for a CUDA
// error.
int accl_fused_matmul_rs_stripes(int dtype, int P, int64_t m, int64_t n, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -(int)e;
  void* fn = fused_kernel_for(dtype);
  if (fn == nullptr || P < 1) return -(int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, MM_THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  const int64_t fit = (int64_t)sms * per_sm / P;
  const int64_t want = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (fit < 1) return 0;
  const int64_t s = fit < want ? fit : want;
  return (int)(s < 1 ? 1 : s);
}

int accl_fused_matmul_rs(const void* const* xs, const void* const* ws, void* const* outs,
                         int64_t m, int64_t n, int64_t k, int P, int dtype, int S,
                         void* landing, void* prod, int* flags, int device, void* stream) {
  if (P < 2 || P > MAXP || S < 1 || m < 0 || n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  void* fn = fused_kernel_for(dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(flags, 0, sizeof(int) * (size_t)P * S * 4, st);
  if (e != cudaSuccess) return (int)e;
  PtrTable xt, wt;
  OutTable ot;
  for (int r = 0; r < P; ++r) { xt.p[r] = xs[r]; wt.p[r] = ws[r]; ot.p[r] = outs[r]; }
  float* land = (float*)landing;
  float* pr = (float*)prod;
  void* args[] = {&xt, &wt, &ot, &m, &n, &k, &P, &S, &land, &pr, &flags};
  e = cudaLaunchCooperativeKernel(fn, dim3(P * S), dim3(MM_THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
