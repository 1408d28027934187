// Tiled matmul, and the ring reduce-scatter of per-rank partial products
// with the matmul inside the ring loop, over P ranks that share one card
// (one launch) or sit on several cards (the cross-card mode, one launch
// per card).
//
// Replaces the Pallas TPU kernels pallas_matmul (_matmul_kernel,
// accl_tpu/ops/fused.py:341) and fused_matmul_reduce_scatter_pallas
// (accl_tpu/ops/fused.py:476).
//
//  * accl_matmul: out[m, n] = x[m, k] @ w[k, n], inputs float32 or
//    bfloat16, fp32 accumulation and output.  The TPU kernel takes full-K
//    256x256 output blocks into VMEM and hands them to the MXU.  Here a
//    block computes a BM x 128 output tile (BM = 128 or 64) over one
//    range of K, and the wrapper's plan (ops/fused.py matmul_plan) picks
//    BM and the split of K per call so that a short m still fills the
//    card's 132 SMs: the chunked TP form's [128, 1792] @ [1792, 4096] runs
//    as 64 tiles of 64 x 128, each K split in 4, 256 blocks, where one
//    block per 128 x 128 tile gave 32.  A split of K is reduced in one
//    fixed order, with no float atomics: every block of a tile writes its
//    partial to a workspace and counts itself in on the tile's counter
//    (an integer atomic); the last to arrive sums partials 0, 1, ...,
//    split-1 in that order (its own from registers) into the output, and
//    sets the counter back to 0.  Two launches on the same inputs give
//    the same bits whichever block arrives last.
//  * accl_fused_matmul_rs: rank r holds x_r [P, m, k] and w_r [k, n] and
//    ends with row block r of sum_q x_q @ w_q, [m, n] fp32.  On the TPU
//    each rank is a chip and a hop is a remote DMA of the accumulator
//    while the MXU computes the next partial.  Here each rank is a group
//    of thread blocks, each block owns a stripe of the [m, n] output
//    tiles (128 x 128) and runs its own ring over that stripe, and a hop
//    is a store into the right neighbour's double-buffered landing slot
//    in device memory, published with a release-ordered flag (the
//    machinery of ring.cu, shared through ring_sync.cuh).  Per stripe
//    and hop s, for each tile: the mainloop computes x[my-2-s] @ w into
//    registers; at the hop's first epilogue the block waits with acquire
//    for its own slot s % 2 (and, unless last, for the ACK that frees the
//    right neighbour's next slot); the epilogue adds the landing
//    (read through L2) to the accumulators and stores the sum straight
//    into the right neighbour's next slot, or into the output on the last
//    hop.  Hop 0 stores x[my-1] @ w into the right neighbour's slot 0.
//    After the stripe's tiles the block publishes the hop and ACKs the
//    consumed slot to its left neighbour under rs_signals_ack.  The fold
//    nesting is the Pallas kernel's, acc = x[my-2-s] @ w + landing, so
//    with products and partial sums exact in fp32 (small integer inputs)
//    the result is bitwise equal to it.  No product goes through device
//    memory: the fold is the epilogue.
//
// What bounds them on this card: operations.  At the main path's shapes
// (MLP-down of Llama-3-8B at TP=8: x [4096, 1792] @ w [1792, 4096] per
// rank) a matmul does ~480 fp32 operations per byte it must move; an
// H100 needs ~20 (fp32, 67 TFLOP/s over 3.35 TB/s) before arithmetic
// binds.  Neither kernel uses TF32 or the tensor cores: a full fp32 FMA
// chain per output element, in k order within a block's range of K, is
// the reference's numerics (preferred_element_type=float32 on f32
// inputs).  The mainloop, shared by both kernels (tile_mainloop):
//  * a ring of STAGES = 4 slices of BK = 16 in dynamic shared memory,
//    filled with 16-byte cp.async.cg issued STAGES - 1 slices ahead, one
//    barrier per slice (1024 FMAs a thread between barriers); bf16
//    operands are copied raw (half the bytes) and widened at the
//    fragment read;
//  * x slices are kept K-major (k contiguous: row r's 16 values of k in
//    one 64-byte line, as they lie in device memory), so a thread's row
//    fragment, 4 values of k for one row, is one 16-byte read, and the
//    lanes of a quarter-warp read the same row (a broadcast; the two
//    rows a warp reads share banks, a 2-way conflict that costs less
//    than the XOR swizzle or the row padding that removed it); w slices
//    are N-major, a thread reading columns tx*4 and tx*4 + 64 (four 4x4
//    quadrants of accumulators), so a quarter-warp's LDS.128 land on
//    distinct banks;
//  * the w fragments are double-buffered in registers, k + 1 loaded while
//    k multiplies; the epilogue stores 16 bytes a thread;
//  * accl_matmul runs 2 blocks of 256 threads per SM (128 registers, no
//    spills); the fused kernel 1 (255 registers): its ring state on top
//    of the mainloop's 128 registers spilled at 2 blocks per SM, which
//    was slower;
//  * a shape whose rows are not 16-byte aligned (k or n not a multiple of
//    16 / sizeof(T), a pointer off 16 bytes) stages the same slices with
//    plain loads and stores scalars: the wrapper passes vec = 0.
// Measured on an H100 and not kept (PERF.md section 6): the XOR
// swizzle of x slices, x-slice rows padded by 16 bytes, warps of 4 x 8
// threads, BK = 32 with 3 stages, 3 stages of BK = 16, x fragments
// double-buffered in registers, the next slice's copies issued after
// the slice's FMAs, 128 x 256 tiles (8 x 16 outputs a thread), 64-row
// tiles or the ring state in shared memory in the fused kernel.
//
// Correctness rules the fused kernel keeps (as ring.cu):
//  * all blocks spin on flags other blocks set, so the launch is
//    cooperative, and the stripe count comes from the occupancy query for
//    this kernel at the dynamic shared memory it is launched with (the
//    attribute that allows more than 48 KB is set first): the runtime
//    refuses a grid that cannot be co-resident instead of letting it
//    deadlock;
//  * no memset per launch: the wrapper zeroes the flags once, and every
//    block sets its own four back to 0 when it ends, after its last wait
//    (the ACK ledger balances, so nothing writes them again in the
//    launch); the split-K counters of accl_matmul likewise;
//  * landing slots and split-K partials are read through L2 (__ldcg):
//    L1 is not coherent across SMs and a slot's address recurs every
//    second hop;
//  * each wait traps after 10 s counted from its own start, so a broken
//    handshake fails the launch while long hops do not;
//  * every offset is 64-bit.
#include <cuda_bf16.h>

#include "current_device.cuh"
#include "ring_sync.cuh"

#define BN 128           // output tile columns
#define BK 16            // k per pipeline stage
#define STAGES 4         // stages in the shared-memory ring
#define MM_THREADS 256   // 16 x 16 threads; a thread holds (BM / 16) x 8 outputs
#define FUSED_BM 128     // output tile rows of the fused kernel

// ------------------------------------------------------------------------
// cp.async
// ------------------------------------------------------------------------
// 16 bytes from src to dst in shared memory; with full false nothing is
// read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ------------------------------------------------------------------------
// element types
// ------------------------------------------------------------------------
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Four consecutive values in shared memory as fp32: one LDS.128 for
// float, one LDS.64 widened for bf16 (a bf16 is the high half of its f32).
template <typename T> __device__ __forceinline__ float4 lds4(const T* p);
template <> __device__ __forceinline__ float4 lds4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 lds4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

template <typename T, int BM> struct Tile {
  static constexpr int TM = BM / 16;              // rows a thread holds
  static constexpr int V = 16 / (int)sizeof(T);   // elements per 16 bytes
  static constexpr int A_ELEMS = BM * BK;         // one x slice, [BM][BK]
  static constexpr int B_ELEMS = BK * BN;         // one w slice, [BK][BN]
  static constexpr int SMEM = STAGES * (A_ELEMS + B_ELEMS) * (int)sizeof(T);
};

// Row of the tile that a thread's accumulator row i holds, and column of
// its accumulator column j: quadrants at +BM/2 and +BN/2.
template <int BM> __device__ __forceinline__ int acc_row(int i) {
  return (i / 4) * (BM / 2) + (threadIdx.x / 16) * 4 + (i % 4);
}
__device__ __forceinline__ int acc_col(int j) {
  return (j / 4) * (BN / 2) + (threadIdx.x % 16) * 4 + (j % 4);
}

// ------------------------------------------------------------------------
// The mainloop
// ------------------------------------------------------------------------
// Stage one slice: x[row0 .. row0+BM)[kb .. kb+BK) into sa (K-major) and
// w[kb .. kb+BK)[col0 .. col0+BN) into sb; everything past m, n or k1
// reads as zero.  With vec every 16-byte chunk is aligned and wholly
// inside or wholly outside (k1 and n multiples of V), and goes by
// cp.async; without, by plain loads and stores.
template <typename T, int BM>
__device__ __forceinline__ void fill_stage(T* sa, T* sb, const T* __restrict__ x,
                                           const T* __restrict__ w, int64_t m, int64_t n,
                                           int64_t k, int64_t row0, int64_t col0, int64_t kb,
                                           int64_t k1, bool vec) {
  using G = Tile<T, BM>;
  constexpr int V = G::V;
  constexpr int ACH = G::A_ELEMS / V, BCH = G::B_ELEMS / V;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (ACH + MM_THREADS - 1) / MM_THREADS; ++i) {
    const int c = tid + i * MM_THREADS;
    if (ACH % MM_THREADS == 0 || c < ACH) {
      const int r = c / (BK / V), kc = (c % (BK / V)) * V;
      const int64_t gr = row0 + r, gk = kb + kc;
      T* d = sa + r * BK + kc;
      if (vec) {
        const bool ok = gr < m && gk < k1;
        cp_async16(d, ok ? x + gr * k + gk : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          d[e] = (gr < m && gk + e < k1) ? x[gr * k + gk + e] : zero_of<T>();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < (BCH + MM_THREADS - 1) / MM_THREADS; ++i) {
    const int c = tid + i * MM_THREADS;
    if (BCH % MM_THREADS == 0 || c < BCH) {
      const int r = c / (BN / V), nc = (c % (BN / V)) * V;
      const int64_t gk = kb + r, gc = col0 + nc;
      T* d = sb + r * BN + nc;
      if (vec) {
        const bool ok = gk < k1 && gc < n;
        cp_async16(d, ok ? w + gk * n + gc : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          d[e] = (gk < k1 && gc + e < n) ? w[gk * n + gc + e] : zero_of<T>();
      }
    }
  }
}

// acc[i][j] += sum over the slice's 16 values of k, in k order.
template <typename T, int BM>
__device__ __forceinline__ void compute_stage(const T* sa, const T* sb,
                                              float (&acc)[BM / 16][8]) {
  constexpr int TM = BM / 16;
  const T* pa = sa + ((threadIdx.x / 16) * 4) * BK;
  const T* pb = sb + (threadIdx.x % 16) * 4;
  float4 b[2][2];
  b[0][0] = lds4<T>(pb);
  b[0][1] = lds4<T>(pb + BN / 2);
#pragma unroll
  for (int kq = 0; kq < BK / 4; ++kq) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = lds4<T>(pa + ((i / 4) * (BM / 2) + (i % 4)) * BK + kq * 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int ks = kq * 4 + kk, cur = ks & 1;
      if (ks + 1 < BK) {
        b[cur ^ 1][0] = lds4<T>(pb + (ks + 1) * BN);
        b[cur ^ 1][1] = lds4<T>(pb + (ks + 1) * BN + BN / 2);
      }
      const float bv[8] = {b[cur][0].x, b[cur][0].y, b[cur][0].z, b[cur][0].w,
                           b[cur][1].x, b[cur][1].y, b[cur][1].z, b[cur][1].w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

// acc = x[row0 .., k0 .. k1) @ w[k0 .. k1, col0 ..) for the thread's
// outputs, fp32 FMA in k order.  Ends with the ring drained and a
// barrier, so the shared memory may be refilled.
template <typename T, int BM>
__device__ __forceinline__ void tile_mainloop(const T* __restrict__ x, const T* __restrict__ w,
                                              int64_t m, int64_t n, int64_t k, int64_t row0,
                                              int64_t col0, int64_t k0, int64_t k1, bool vec,
                                              unsigned char* smem, float (&acc)[BM / 16][8]) {
  using G = Tile<T, BM>;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + STAGES * G::A_ELEMS;
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = k1 > k0 ? (int)((k1 - k0 + BK - 1) / BK) : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      fill_stage<T, BM>(sa + s * G::A_ELEMS, sb + s * G::B_ELEMS, x, w, m, n, k, row0, col0,
                        k0 + (int64_t)s * BK, k1, vec);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // slice kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and slice kt-1 is consumed
    const int nt = kt + STAGES - 1;
    if (nt < nk) {
      const int slot = nt % STAGES;  // the slot of slice kt - 1
      fill_stage<T, BM>(sa + slot * G::A_ELEMS, sb + slot * G::B_ELEMS, x, w, m, n, k, row0,
                        col0, k0 + (int64_t)nt * BK, k1, vec);
    }
    cp_async_commit();
    const int cur = kt % STAGES;
    compute_stage<T, BM>(sa + cur * G::A_ELEMS, sb + cur * G::B_ELEMS, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ------------------------------------------------------------------------
// Epilogues
// ------------------------------------------------------------------------
// dst[tile] = acc (+ add[tile], read through L2, when add is given);
// 16-byte stores with vec, scalar ones without.
template <int BM>
__device__ __forceinline__ void store_tile(float* dst, const float* add, int64_t m, int64_t n,
                                           int64_t row0, int64_t col0, bool vec,
                                           const float (&acc)[BM / 16][8]) {
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int64_t gr = row0 + acc_row<BM>(i);
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gc = col0 + acc_col(h * 4);
      const int64_t o = gr * n + gc;
      float4 v = make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                             acc[i][h * 4 + 3]);
      if (vec) {
        if (gc >= n) continue;
        if (add) {
          const float4 l = __ldcg(reinterpret_cast<const float4*>(add + o));
          v.x += l.x; v.y += l.y; v.z += l.z; v.w += l.w;
        }
        *reinterpret_cast<float4*>(dst + o) = v;
      } else {
        const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < n) dst[o + e] = add ? e4[e] + __ldcg(add + o + e) : e4[e];
      }
    }
  }
}

// The last block of a split tile: out = partial 0 + partial 1 + ... +
// partial split-1, in that order, its own (index z) from registers.
template <int BM>
__device__ __forceinline__ void reduce_split(float* out, const float* ws, int64_t m, int64_t n,
                                             int64_t row0, int64_t col0, int split, int z,
                                             bool vec, const float (&acc)[BM / 16][8]) {
  const int64_t mn = m * n;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int64_t gr = row0 + acc_row<BM>(i);
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gc = col0 + acc_col(h * 4);
      const int64_t o = gr * n + gc;
      const float4 own = make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                                     acc[i][h * 4 + 3]);
      if (vec) {
        if (gc >= n) continue;
        float4 s = z == 0 ? own : __ldcg(reinterpret_cast<const float4*>(ws + o));
        for (int q = 1; q < split; ++q) {
          const float4 p = q == z ? own : __ldcg(reinterpret_cast<const float4*>(ws + q * mn + o));
          s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
        }
        *reinterpret_cast<float4*>(out + o) = s;
      } else {
        const float e4[4] = {own.x, own.y, own.z, own.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gc + e >= n) continue;
          float s = z == 0 ? e4[e] : __ldcg(ws + o + e);
          for (int q = 1; q < split; ++q) s += q == z ? e4[e] : __ldcg(ws + q * mn + o + e);
          out[o + e] = s;
        }
      }
    }
  }
}

// ------------------------------------------------------------------------
// accl_matmul: block (bx, by, z) computes tile (by, bx) over
// k in [z kps, min(k, (z + 1) kps)).
// ------------------------------------------------------------------------
template <typename T, int BM>
__global__ void __launch_bounds__(MM_THREADS, 2)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ out,
              int64_t m, int64_t n, int64_t k, int64_t kps, int split, int vec, float* ws,
              int* counters) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int64_t row0 = (int64_t)blockIdx.y * BM, col0 = (int64_t)blockIdx.x * BN;
  const int z = blockIdx.z;
  const int64_t k0 = (int64_t)z * kps, k1 = k0 + kps < k ? k0 + kps : k;
  float acc[BM / 16][8];
  tile_mainloop<T, BM>(x, w, m, n, k, row0, col0, k0, k1, vec != 0, smem, acc);
  if (split == 1) {
    store_tile<BM>(out, nullptr, m, n, row0, col0, vec != 0, acc);
    return;
  }
  store_tile<BM>(ws + (int64_t)z * m * n, nullptr, m, n, row0, col0, vec != 0, acc);
  __syncthreads();
  int* cnt = counters + (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partial before its count
    last = atomicAdd(cnt, 1) == split - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other partial is visible past the count
  reduce_split<BM>(out, ws, m, n, row0, col0, split, z, vec != 0, acc);
  if (threadIdx.x == 0) *cnt = 0;  // every block of the tile has counted
}

// ------------------------------------------------------------------------
// accl_fused_matmul_rs.  Flags: filled[P][S][2] then ack[P][S][2] (int32),
// as in ring.cu.  Block b plays rank b / S on tile stripe st = b % S:
// tiles [st T / S, (st + 1) T / S) of the row-major grid of T output
// tiles of 128 x 128 (ops/fused.py stripe_tiles).
// ------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(MM_THREADS, 1)
fused_matmul_rs_kernel(PtrTable xs, PtrTable ws, OutTable outs, int64_t m, int64_t n, int64_t k,
                       int P, int S, int vec, float* landing, int* flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int my = blockIdx.x / S, st = blockIdx.x % S;
  const int right = (my + 1) % P, left = (my + P - 1) % P;
  const int64_t tiles_n = (n + BN - 1) / BN;
  const int64_t tiles = ((m + FUSED_BM - 1) / FUSED_BM) * tiles_n;
  const int64_t t0 = st * tiles / S, t1 = (st + 1) * tiles / S;
  const int64_t mn = m * n;
  int* filled = flags;
  int* ack = flags + (int64_t)P * S * 2;
  auto F = [&](int r, int slot) { return filled + ((int64_t)r * S + st) * 2 + slot; };
  auto A = [&](int r, int slot) { return ack + ((int64_t)r * S + st) * 2 + slot; };
  auto L = [&](int r, int slot) { return landing + ((int64_t)r * 2 + slot) * mn; };
  const T* x = static_cast<const T*>(xs.p[my]);
  const T* w = static_cast<const T*>(ws.p[my]);
  const int64_t xchunk = m * k;
  float acc[FUSED_BM / 16][8];

  // s = -1 is hop 0: x[my - 1] @ w into the right neighbour's slot 0.
  // Hop s >= 0 folds x[my - 2 - s] @ w + landing[s % 2].
  for (int s = -1; s < P - 1; ++s) {
    const T* xc = x + (int64_t)pmod(s < 0 ? my - 1 : my - 2 - s, P) * xchunk;
    const bool last = s == P - 2;
    const int slot = s & 1, ns = s + 1;
    float* dst = s < 0 ? L(right, 0)
                       : (last ? static_cast<float*>(outs.p[my]) : L(right, ns & 1));
    const float* lin = s < 0 ? nullptr : L(my, slot);
    bool waited = s < 0;
    auto wait_hop = [&]() {
      wait_geq<SCOPE_GPU>(F(my, slot), s / 2 + 1);  // left's hop s has landed
      // the right neighbour freed this slot at its fold of hop ns - 2
      if (!last && rs_waits_ack(ns, P)) wait_geq<SCOPE_GPU>(A(my, ns & 1), ns / 2);
    };
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t row0 = (t / tiles_n) * FUSED_BM, col0 = (t % tiles_n) * BN;
      tile_mainloop<T, FUSED_BM>(xc, w, m, n, k, row0, col0, 0, k, vec != 0, smem, acc);
      if (!waited) {  // the hop's first epilogue: its product is already in registers
        wait_hop();
        waited = true;
      }
      store_tile<FUSED_BM>(dst, lin, m, n, row0, col0, vec != 0, acc);
    }
    if (!waited) wait_hop();
    __syncthreads();
    if (threadIdx.x == 0) {
      if (s < 0) {
        arrive_release<SCOPE_GPU>(F(right, 0));
      } else {
        if (!last) arrive_release<SCOPE_GPU>(F(right, ns & 1));
        // landing[slot] consumed: free it for the left neighbour's hop s + 2
        if (rs_signals_ack(s, P)) arrive_release<SCOPE_GPU>(A(left, slot));
      }
    }
  }
  if (threadIdx.x == 0) {
    // every hop into this block's slots and every ACK it will get have
    // been waited for: leave its flags at 0 for the next launch
    *F(my, 0) = *F(my, 1) = *A(my, 0) = *A(my, 1) = 0;
  }
}

// ------------------------------------------------------------------------
// The cross-card mode of accl_fused_matmul_rs (the TPU kernel's own
// setting: each rank a chip, each hop a remote DMA into the right
// neighbour's landing buffer with a semaphore signal on its chip,
// accl_tpu/ops/fused.py:476-586).  The ranks sit on several cards joined
// by peer access.  Each card gets one launch holding its ranks' blocks
// (block b plays rank tabs.rank[b / S] on stripe b % S), all with the
// same S and the same stripes.  Rank r's landing slots [2][m n] floats
// and its flags (HS_WORDS head words, then filled[S][2], then ack[S][2])
// are its own buffers on its own card, reached through per-rank tables,
// so a hop is the epilogue's store over NVLink into the right
// neighbour's slot, published by a .sys release reduction into its
// filled flag, and every wait is a .sys acquire on the waiting rank's own
// card.  The entry and exit are ring_kernel_cross's (ring.cu,
// cross_entry and count_out in ring_sync.cuh): the wrapper joins the
// cards' streams before the launches and back after them; in an eager
// launch one block a card waits for the host's gate and copies what it
// saw into the card's word, the others wait on that word, and a launch
// given up touches nothing (a launch captured in a CUDA graph has no
// gate); then every block waits until both of its rank's handshake words
// count every block of every earlier launch on these tables (its rank's
// HS_DONE, kept on the card), and as it ends it sets its own four flags
// back to 0, counts itself into its left neighbour's second word and its
// right neighbour's first, with a release, and out of its rank's launch,
// the rank's last block advancing HS_DONE (tests/test_torch_model_cards.py
// replays that schedule, eager and replayed launches interleaved).  The
// fold chain, the tiles and the ACK windows are the one-launch kernel's,
// so the results are bitwise those of one launch.  The one-launch kernel
// above keeps its own code: this is a function of its own, not a
// template the two share (a shared step changed the one-launch ring
// kernels' machine code, PERF.md).  With every rank on one card it is the
// per-rank-table form, which a one-card check holds against the one
// launch.
// ------------------------------------------------------------------------
struct FusedTables {
  float* slots[MAXP];  // rank r's landing slots, [2][m n], on its card
  int* flags[MAXP];    // rank r's flags, on its card
  int rank[MAXP];      // the rank block b of this launch plays: rank[b / S]
  const int* gate;     // the host's gate (ring.cu RankTables::gate), null
                       // for a launch captured in a CUDA graph
  int seq;             // this launch's number in the gate
};
// A block's three ranks: its own (slots, flags), its right neighbour's
// (slots, filled) and its left neighbour's (ack).  Thread 0 copies their
// bases into shared memory at entry and every use reads them there
// (volatile: the mainloop leaves no registers for five pointers).
struct FusedBases {
  float* slot[2];  // mine, my right neighbour's
  int* flags[3];   // mine, my right neighbour's, my left neighbour's
};

template <typename T>
__global__ void __launch_bounds__(MM_THREADS, 1)
fused_matmul_rs_cross_kernel(PtrTable xs, PtrTable ws, OutTable outs, int64_t m, int64_t n,
                             int64_t k, int P, int S, int vec, FusedTables tabs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ FusedBases bases;
  __shared__ int opened;
  const int my = tabs.rank[blockIdx.x / S], st = blockIdx.x % S;
  const int right = (my + 1) % P, left = (my + P - 1) % P;
  if (threadIdx.x == 0) {
    opened = cross_entry(tabs.gate, tabs.seq, tabs.flags[tabs.rank[0]] + 2, tabs.flags[my]);
    if (opened) {
      bases.slot[0] = tabs.slots[my];
      bases.slot[1] = tabs.slots[right];
      bases.flags[0] = tabs.flags[my];
      bases.flags[1] = tabs.flags[right];
      bases.flags[2] = tabs.flags[left];
    }
  }
  __syncthreads();
  if (!opened) return;  // given up: touch nothing, count nothing
  volatile const FusedBases* b = &bases;
  const int64_t tiles_n = (n + BN - 1) / BN;
  const int64_t tiles = ((m + FUSED_BM - 1) / FUSED_BM) * tiles_n;
  const int64_t t0 = st * tiles / S, t1 = (st + 1) * tiles / S;
  const int64_t mn = m * n;
  // filled of mine or my right neighbour's (who 0 or 1); ack of mine or
  // my left neighbour's (who 0 or 2); slots of mine or my right's
  auto F = [&](int who, int slot) { return b->flags[who] + HS_WORDS + st * 2 + slot; };
  auto A = [&](int who, int slot) {
    return b->flags[who] + HS_WORDS + (int64_t)S * 2 + st * 2 + slot;
  };
  auto L = [&](int who, int slot) { return b->slot[who] + (int64_t)slot * mn; };
  const T* x = static_cast<const T*>(xs.p[my]);
  const T* w = static_cast<const T*>(ws.p[my]);
  const int64_t xchunk = m * k;
  float acc[FUSED_BM / 16][8];

  for (int s = -1; s < P - 1; ++s) {
    const T* xc = x + (int64_t)pmod(s < 0 ? my - 1 : my - 2 - s, P) * xchunk;
    const bool last = s == P - 2;
    const int slot = s & 1, ns = s + 1;
    float* dst = s < 0 ? L(1, 0) : (last ? static_cast<float*>(outs.p[my]) : L(1, ns & 1));
    const float* lin = s < 0 ? nullptr : L(0, slot);
    bool waited = s < 0;
    auto wait_hop = [&]() {
      wait_geq<SCOPE_SYS>(F(0, slot), s / 2 + 1);  // left's hop s has landed
      if (!last && rs_waits_ack(ns, P)) wait_geq<SCOPE_SYS>(A(0, ns & 1), ns / 2);
    };
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t row0 = (t / tiles_n) * FUSED_BM, col0 = (t % tiles_n) * BN;
      tile_mainloop<T, FUSED_BM>(xc, w, m, n, k, row0, col0, 0, k, vec != 0, smem, acc);
      if (!waited) {
        wait_hop();
        waited = true;
      }
      store_tile<FUSED_BM>(dst, lin, m, n, row0, col0, vec != 0, acc);
    }
    if (!waited) wait_hop();
    __syncthreads();
    if (threadIdx.x == 0) {
      if (s < 0) {
        arrive_release<SCOPE_SYS>(F(1, 0));
      } else {
        if (!last) arrive_release<SCOPE_SYS>(F(1, ns & 1));
        if (rs_signals_ack(s, P)) arrive_release<SCOPE_SYS>(A(2, slot));
      }
    }
  }
  if (threadIdx.x == 0) {
    *F(0, 0) = *F(0, 1) = *A(0, 0) = *A(0, 1) = 0;
    arrive_release<SCOPE_SYS>(tabs.flags[left] + 1);
    arrive_release<SCOPE_SYS>(tabs.flags[right]);
    count_out(tabs.flags[my], S);
  }
}

// ------------------------------------------------------------------------
// host side: plain C interface, bound with ctypes
// ------------------------------------------------------------------------
enum { DT_F32 = 0, DT_BF16 = 1 };
#define N_KERNELS 8
#define MAX_DEVICES 64

// 0-3: accl_matmul (f32 BM 128, f32 BM 64, bf16 BM 128, bf16 BM 64);
// 4-5: accl_fused_matmul_rs (f32, bf16); 6-7: its cross-card mode (f32,
// bf16).  Each with its dynamic shared memory in bytes.
static void* kernel_fn(int which, int* smem) {
  switch (which) {
    case 0: *smem = Tile<float, 128>::SMEM; return (void*)matmul_kernel<float, 128>;
    case 1: *smem = Tile<float, 64>::SMEM; return (void*)matmul_kernel<float, 64>;
    case 2: *smem = Tile<__nv_bfloat16, 128>::SMEM; return (void*)matmul_kernel<__nv_bfloat16, 128>;
    case 3: *smem = Tile<__nv_bfloat16, 64>::SMEM; return (void*)matmul_kernel<__nv_bfloat16, 64>;
    case 4: *smem = Tile<float, FUSED_BM>::SMEM; return (void*)fused_matmul_rs_kernel<float>;
    case 5:
      *smem = Tile<__nv_bfloat16, FUSED_BM>::SMEM;
      return (void*)fused_matmul_rs_kernel<__nv_bfloat16>;
    case 6: *smem = Tile<float, FUSED_BM>::SMEM; return (void*)fused_matmul_rs_cross_kernel<float>;
    case 7:
      *smem = Tile<__nv_bfloat16, FUSED_BM>::SMEM;
      return (void*)fused_matmul_rs_cross_kernel<__nv_bfloat16>;
  }
  return nullptr;
}

static int matmul_index(int dtype, int bm) {
  if ((dtype != DT_F32 && dtype != DT_BF16) || (bm != 128 && bm != 64)) return -1;
  return dtype * 2 + (bm == 64);
}

// The kernel with its shared-memory attribute set on this device: above
// 48 KB dynamic shared memory needs the opt-in, which must come before
// the occupancy query and the launch.  Set once per kernel and device.
static cudaError_t ready_kernel(int which, int device, void** fn, int* smem) {
  static bool ready[N_KERNELS][MAX_DEVICES];
  *fn = kernel_fn(which, smem);
  if (*fn == nullptr || device < 0) return cudaErrorInvalidValue;
  if (device < MAX_DEVICES && ready[which][device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e == cudaSuccess && device < MAX_DEVICES) ready[which][device] = true;
  return e;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

extern "C" {

const char* accl_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// What the runtime reports for kernel `which` (see kernel_fn): out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] static
// shared memory, out[3] the dynamic shared memory it is launched with,
// out[4] blocks resident per SM at that footprint.
int accl_fused_kernel_info(int which, int device, int* out) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t e;
  void* fn;
  int smem;
  e = ready_kernel(which, device, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, MM_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = smem;
  out[4] = per_sm;
  return 0;
}

// One launch of accl_matmul with the wrapper's plan: tiles of bm x 128
// (bm 128 or 64), K split in `split` ranges of kps (a multiple of BK).
// With split > 1, ws holds split m n floats and counters one int32 per
// output tile, zero on entry and on exit.  vec: every row and pointer is
// 16-byte aligned.
int accl_matmul(const void* x, const void* w, void* out, int64_t m, int64_t n, int64_t k,
                int dtype, int bm, int split, int64_t kps, int vec, void* ws, int* counters,
                int device, void* stream) {
  const int which = matmul_index(dtype, bm);
  if (which < 0 || m < 0 || n < 0 || k < 0 || split < 1 || split > 65535 || kps < 1)
    return (int)cudaErrorInvalidValue;
  if (split > 1 && (kps % BK != 0 || (int64_t)(split - 1) * kps >= k || (int64_t)split * kps < k ||
                    ws == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  if (split == 1 && kps < k) return (int)cudaErrorInvalidValue;
  const int V = dtype == DT_F32 ? 4 : 8;
  if (vec && (k % V || n % V || !aligned16(x) || !aligned16(w) || !aligned16(out) ||
              (split > 1 && !aligned16(ws))))
    return (int)cudaErrorInvalidValue;
  const int64_t gy = (m + bm - 1) / bm, gx = (n + BN - 1) / BN;
  if (gy > 65535 || gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t e;
  void* fn;
  int smem;
  e = ready_kernel(which, device, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  float* o = (float*)out;
  float* wsp = (float*)ws;
  void* args[] = {(void*)&x, (void*)&w, &o, &m, &n, &k, &kps, &split, &vec, &wsp, &counters};
  e = cudaLaunchKernel(fn, dim3((unsigned)gx, (unsigned)gy, (unsigned)split), dim3(MM_THREADS),
                       args, (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks of the fused kernel for dtype (cross: its cross-card mode) that
// fit on the card together at the dynamic shared memory it is launched
// with, or a negative CUDA error.
int accl_fused_resident_mode(int dtype, int cross, int device) {
  if (dtype != DT_F32 && dtype != DT_BF16) return -(int)cudaErrorInvalidValue;
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return -(int)on.err;
  void* fn;
  int smem;
  cudaError_t e = ready_kernel((cross ? 6 : 4) + dtype, device, &fn, &smem);
  if (e != cudaSuccess) return -(int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, MM_THREADS, smem);
  if (e != cudaSuccess) return -(int)e;
  return sms * per_sm;
}

int accl_fused_resident(int dtype, int device) {
  return accl_fused_resident_mode(dtype, 0, device);
}

// One cooperative launch of P * S blocks.  landing holds P * 2 * m * n
// floats; flags P * S * 4 int32, zero on entry and on exit.
int accl_fused_matmul_rs(const void* const* xs, const void* const* ws, void* const* outs,
                         int64_t m, int64_t n, int64_t k, int P, int dtype, int S, int vec,
                         void* landing, int* flags, int device, void* stream) {
  if (P < 2 || P > MAXP || S < 1 || m < 0 || n < 0 || k < 0 ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = ((m + FUSED_BM - 1) / FUSED_BM) * ((n + BN - 1) / BN);
  if (S > tiles) return (int)cudaErrorInvalidValue;  // every stripe holds a tile
  const int V = dtype == DT_F32 ? 4 : 8;
  if (vec) {
    bool ok = k % V == 0 && n % V == 0 && aligned16(landing);
    for (int r = 0; r < P; ++r) ok = ok && aligned16(xs[r]) && aligned16(ws[r]) && aligned16(outs[r]);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t e;
  void* fn;
  int smem;
  e = ready_kernel(4 + dtype, device, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  PtrTable xt, wt;
  OutTable ot;
  for (int r = 0; r < P; ++r) { xt.p[r] = xs[r]; wt.p[r] = ws[r]; ot.p[r] = outs[r]; }
  float* land = (float*)landing;
  void* args[] = {&xt, &wt, &ot, &m, &n, &k, &P, &S, &vec, &land, &flags};
  e = cudaLaunchCooperativeKernel(fn, dim3(P * S), dim3(MM_THREADS), args, (size_t)smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One card's launch of the cross-card mode: nr * S blocks, block b
// playing rank ranks[b / S] of a ring of P over every card.  xs, ws, outs,
// slots and flags hold one entry per rank of the ring (rank r's slots
// 2 m n floats and flags HS_WORDS + S * 4 int32 on rank r's card, the
// flags zero when first made; their head keeps the handshake's count);
// an eager launch passes its gate (accl_ring_gate_new in ring.cu): its
// blocks start once gate[0] reaches seq and end at once if gate[1] is
// set first; a launch captured in a CUDA graph passes a null gate.  The
// caller joins the cards' streams before (accl_ring_join) and after
// (accl_ring_join_back).
int accl_fused_matmul_rs_cross(const void* const* xs, const void* const* ws, void* const* outs,
                               int64_t m, int64_t n, int64_t k, int P, const int* ranks, int nr,
                               int dtype, int S, int vec, void* const* slots, int* const* flags,
                               const int* gate, int seq, int device, void* stream) {
  if (P < 2 || P > MAXP || nr < 1 || nr > P || S < 1 || m < 0 || n < 0 || k < 0 ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = ((m + FUSED_BM - 1) / FUSED_BM) * ((n + BN - 1) / BN);
  if (S > tiles) return (int)cudaErrorInvalidValue;  // every stripe holds a tile
  const int V = dtype == DT_F32 ? 4 : 8;
  if (vec) {
    bool ok = k % V == 0 && n % V == 0;
    for (int r = 0; r < P; ++r)
      ok = ok && aligned16(xs[r]) && aligned16(ws[r]) && aligned16(outs[r]) && aligned16(slots[r]);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  void* fn;
  int smem;
  cudaError_t e = ready_kernel(6 + dtype, device, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  PtrTable xt, wt;
  OutTable ot;
  FusedTables tabs;
  for (int r = 0; r < P; ++r) {
    xt.p[r] = xs[r];
    wt.p[r] = ws[r];
    ot.p[r] = outs[r];
    tabs.slots[r] = (float*)slots[r];
    tabs.flags[r] = flags[r];
  }
  for (int i = 0; i < nr; ++i) {
    if (ranks[i] < 0 || ranks[i] >= P) return (int)cudaErrorInvalidValue;
    tabs.rank[i] = ranks[i];
  }
  tabs.gate = gate;
  tabs.seq = seq;
  void* args[] = {&xt, &wt, &ot, &m, &n, &k, &P, &S, &vec, &tabs};
  e = cudaLaunchCooperativeKernel(fn, dim3(nr * S), dim3(MM_THREADS), args, (size_t)smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
