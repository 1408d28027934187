// Ring reduce-scatter and ring all-gather over P ranks that share one card.
//
// Replaces the Pallas TPU kernels ring_reduce_scatter_pallas
// (accl_tpu/ops/ring.py:274) and ring_all_gather_pallas
// (accl_tpu/ops/ring.py:151).  There each rank is a chip and a hop is a
// remote DMA into the right neighbour's double-buffered VMEM slot.  Here
// each rank is a group of thread blocks, its buffers are regions of the
// card's memory reached through a table of per-rank pointers, and a hop
// is a store into the right neighbour's double-buffered landing slot in
// a scratch buffer, published with a release-ordered flag.
//
// What bounds it on this card: bytes.  Both kernels do one add (or max,
// or nothing) per element moved; an H100 needs ~300 operations per byte
// before arithmetic binds.  Per rank and step the reduce-scatter reads a
// local chunk and a landing slot and writes one slot (3 chunk-sized
// accesses), against the bound's one read of the operand and one write
// of the result.  The design keeps the accumulator out of memory: the
// fold of step s is written straight into the right neighbour's slot for
// step s+1 (the last fold lands in the output), so no separate
// accumulator is read or written.  Landing slots are read with __ldcg
// (L2, not L1): L1 is not coherent across SMs and a slot's address is
// reused every second step.
//
// Correctness rules the design keeps:
//  * all blocks spin on flags other blocks set, so the launch is
//    cooperative: the runtime refuses a grid that cannot be co-resident
//    instead of letting it deadlock;
//  * flags are zeroed with cudaMemsetAsync on the launch stream before
//    every launch, and waits compare against per-launch counts, so no
//    state carries from one segment's launch into the next;
//  * the ACK windows are exactly rs_waits_ack / rs_signals_ack and
//    ag_waits_ack / ag_signals_ack of the reference (ring.py:132-148);
//  * every offset is 64-bit;
//  * a wait that exceeds SPIN_TIMEOUT_NS traps, so a broken handshake
//    fails the launch instead of hanging the card.
#include <cuda_fp16.h>

#include "ring_sync.cuh"

#define THREADS 256

// -- element ops ----------------------------------------------------------
template <typename T> __device__ __forceinline__ T ldcg(const T* p) { return __ldcg(p); }
template <> __device__ __forceinline__ __half ldcg<__half>(const __half* p) {
  return __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

template <typename T> __device__ __forceinline__ T fold_sum(T a, T b) { return a + b; }
template <> __device__ __forceinline__ __half fold_sum<__half>(__half a, __half b) { return __hadd(a, b); }

// NaN-propagating max, as torch.maximum and jnp.maximum
template <typename T> __device__ __forceinline__ T fold_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <> __device__ __forceinline__ __half fold_max<__half>(__half a, __half b) {
  return __hmax_nan(a, b);
}

template <typename T, bool IS_MAX> __device__ __forceinline__ T fold(T a, T b) {
  return IS_MAX ? fold_max<T>(a, b) : fold_sum<T>(a, b);
}

// Flags: filled[P][S][2] then ack[P][S][2] (int32).  filled[r][k][slot]
// counts the times rank r's slot was written by its left neighbour;
// ack[r][k][slot] counts the times rank r's right neighbour freed the slot
// rank r writes into.  Block b plays rank b / S on column stripe b % S.

// ------------------------------------------------------------------------
// ring reduce-scatter: per rank x[P][n] (row stride x_row) -> out[n].
// acc_0 = x[my-1]; hop s sends acc_s into right.landing[s%2]; after it
// arrives, acc_{s+1} = x[my-2-s] + landing[s%2] (or max).  Output chunk c
// is x_c[c] + (x_{c-1}[c] + (... + (x_{c+2}[c] + x_{c+1}[c]))), the
// chain the Pallas kernel builds, so fp32 results match it bit for bit.
// ------------------------------------------------------------------------
template <typename T, bool IS_MAX>
__global__ void __launch_bounds__(THREADS)
ring_rs_kernel(PtrTable xs, int64_t x_row, OutTable outs, int64_t n, int P, int S,
               T* landing, int* flags) {
  const int my = blockIdx.x / S, k = blockIdx.x % S;
  const int right = (my + 1) % P, left = (my + P - 1) % P;
  const int64_t w = (n + S - 1) / S;
  const int64_t c0 = (int64_t)k * w;
  const int64_t c1 = c0 + w < n ? c0 + w : n;
  int* filled = flags;
  int* ack = flags + (int64_t)P * S * 2;
  auto F = [&](int r, int slot) { return filled + ((int64_t)r * S + k) * 2 + slot; };
  auto A = [&](int r, int slot) { return ack + ((int64_t)r * S + k) * 2 + slot; };
  auto L = [&](int r, int slot) { return landing + ((int64_t)r * 2 + slot) * n; };
  const T* x = static_cast<const T*>(xs.p[my]);

  // hop 0: acc_0 = our chunk (my - 1) into the right neighbour's slot 0
  {
    const T* src = x + (int64_t)pmod(my - 1, P) * x_row;
    T* dst = L(right, 0);
    for (int64_t j = c0 + threadIdx.x; j < c1; j += THREADS) dst[j] = src[j];
    __syncthreads();
    if (threadIdx.x == 0) add_release(F(right, 0));
  }
  for (int s = 0; s < P - 1; ++s) {
    const int slot = s & 1;
    wait_geq(F(my, slot), s / 2 + 1);  // left's hop s has landed
    const T* xc = x + (int64_t)pmod(my - 2 - s, P) * x_row;
    const T* lin = L(my, slot);
    const bool last = (s == P - 2);
    T* dst;
    if (last) {
      dst = static_cast<T*>(outs.p[my]);
    } else {
      const int ns = s + 1;
      // the right neighbour freed this slot at its fold of hop ns - 2
      if (rs_waits_ack(ns, P)) wait_geq(A(my, ns & 1), ns / 2);
      dst = L(right, ns & 1);
    }
    for (int64_t j = c0 + threadIdx.x; j < c1; j += THREADS)
      dst[j] = fold<T, IS_MAX>(xc[j], ldcg(lin + j));
    __syncthreads();
    if (threadIdx.x == 0) {
      if (!last) add_release(F(right, (s + 1) & 1));
      // landing[slot] consumed: free it for the left neighbour's hop s + 2
      if (rs_signals_ack(s, P)) add_release(A(left, slot));
    }
  }
}

// ------------------------------------------------------------------------
// ring all-gather: per rank x[n] -> out[P][n] (row stride out_row).
// Local block to out[my] and comm slot 0; hop s relays comm[s%2] into the
// right neighbour's comm[(s+1)%2], then places the arrival at
// out[(my-s-1) % P].
// ------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
ring_ag_kernel(PtrTable xs, OutTable outs, int64_t out_row, int64_t n, int P, int S,
               T* comm, int* flags) {
  const int my = blockIdx.x / S, k = blockIdx.x % S;
  const int right = (my + 1) % P, left = (my + P - 1) % P;
  const int64_t w = (n + S - 1) / S;
  const int64_t c0 = (int64_t)k * w;
  const int64_t c1 = c0 + w < n ? c0 + w : n;
  int* filled = flags;
  int* ack = flags + (int64_t)P * S * 2;
  auto F = [&](int r, int slot) { return filled + ((int64_t)r * S + k) * 2 + slot; };
  auto A = [&](int r, int slot) { return ack + ((int64_t)r * S + k) * 2 + slot; };
  auto C = [&](int r, int slot) { return comm + ((int64_t)r * 2 + slot) * n; };
  const T* x = static_cast<const T*>(xs.p[my]);
  T* out = static_cast<T*>(outs.p[my]);

  for (int64_t j = c0 + threadIdx.x; j < c1; j += THREADS) {
    const T v = x[j];
    out[(int64_t)my * out_row + j] = v;
    C(my, 0)[j] = v;
  }
  __syncthreads();
  for (int s = 0; s < P - 1; ++s) {
    const int slot = s & 1, nxt = slot ^ 1;
    // the right neighbour's comm[nxt] was last read by its own send of
    // hop s - 1: wait for that ACK
    if (ag_waits_ack(s, P)) wait_geq(A(my, nxt), (s - 1) / 2 + 1);
    const T* src = C(my, slot);
    T* dst = C(right, nxt);
    for (int64_t j = c0 + threadIdx.x; j < c1; j += THREADS) dst[j] = ldcg(src + j);
    __syncthreads();
    if (threadIdx.x == 0) {
      add_release(F(right, nxt));
      // our send out of comm[slot] is complete: the left may refill it
      if (ag_signals_ack(s, P)) add_release(A(left, slot));
    }
    wait_geq(F(my, nxt), s / 2 + 1);
    const int64_t origin = pmod(my - s - 1, P);
    const T* got = C(my, nxt);
    for (int64_t j = c0 + threadIdx.x; j < c1; j += THREADS)
      out[origin * out_row + j] = ldcg(got + j);
  }
}

// ------------------------------------------------------------------------
// host side: plain C interface, bound with ctypes
// ------------------------------------------------------------------------
enum { DT_F32 = 0, DT_F16 = 1, DT_F64 = 2, DT_I32 = 3, DT_I64 = 4, DT_COUNT = 5 };

template <typename T>
static void* rs_fn(int is_max) {
  return is_max ? (void*)ring_rs_kernel<T, true> : (void*)ring_rs_kernel<T, false>;
}

static void* kernel_for(int kind, int dtype, int is_max) {
  switch (dtype) {
    case DT_F32: return kind ? (void*)ring_ag_kernel<float> : rs_fn<float>(is_max);
    case DT_F16: return kind ? (void*)ring_ag_kernel<__half> : rs_fn<__half>(is_max);
    case DT_F64: return kind ? (void*)ring_ag_kernel<double> : rs_fn<double>(is_max);
    case DT_I32: return kind ? (void*)ring_ag_kernel<int> : rs_fn<int>(is_max);
    case DT_I64: return kind ? (void*)ring_ag_kernel<long long> : rs_fn<long long>(is_max);
  }
  return nullptr;
}

extern "C" {

const char* accl_ring_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Column stripes per rank for one launch (kind 0 = reduce-scatter, 1 =
// all-gather): as many as fit co-resident, at most one per THREADS*4
// elements.  Returns 0 when not even P blocks fit (the launch would
// deadlock), a negative value for a CUDA error.
int accl_ring_stripes(int kind, int dtype, int is_max, int P, int64_t n, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -(int)e;
  void* fn = kernel_for(kind, dtype, is_max);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  int64_t fit = (int64_t)sms * per_sm / P;
  int64_t want = (n + THREADS * 4 - 1) / (THREADS * 4);
  int64_t s = fit < want ? fit : want;
  if (fit < 1) return 0;
  return (int)(s < 1 ? 1 : s);
}

int accl_ring_reduce_scatter(const void* const* xs, int64_t x_row, void* const* outs,
                             int64_t n, int P, int dtype, int is_max, int S,
                             void* landing, int* flags, int device, void* stream) {
  if (P < 2 || P > MAXP || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  void* fn = kernel_for(0, dtype, is_max);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(flags, 0, sizeof(int) * (size_t)P * S * 4, st);
  if (e != cudaSuccess) return (int)e;
  PtrTable xt;
  OutTable ot;
  for (int r = 0; r < P; ++r) { xt.p[r] = xs[r]; ot.p[r] = outs[r]; }
  void* args[] = {&xt, &x_row, &ot, &n, &P, &S, &landing, &flags};
  e = cudaLaunchCooperativeKernel(fn, dim3(P * S), dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int accl_ring_all_gather(const void* const* xs, void* const* outs, int64_t out_row,
                         int64_t n, int P, int dtype, int S, void* comm, int* flags,
                         int device, void* stream) {
  if (P < 2 || P > MAXP || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  void* fn = kernel_for(1, dtype, 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(flags, 0, sizeof(int) * (size_t)P * S * 4, st);
  if (e != cudaSuccess) return (int)e;
  PtrTable xt;
  OutTable ot;
  for (int r = 0; r < P; ++r) { xt.p[r] = xs[r]; ot.p[r] = outs[r]; }
  void* args[] = {&xt, &ot, &out_row, &n, &P, &S, &comm, &flags};
  e = cudaLaunchCooperativeKernel(fn, dim3(P * S), dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
