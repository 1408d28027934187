// Flash-attention backward: dQ, and dK/dV, rebuilt from the forward's
// saved log-sum-exp, so the [T, Tk] probability matrix never reaches
// device memory.
//
// Replaces the Pallas TPU kernels of accl_tpu/ops/flash.py:
//  * flash_bwd_dq  <- _flash_bwd_dq_kernel  (:873, call :1086);
//  * flash_bwd_dkv <- _flash_bwd_dkv_kernel (:939, call :1124).
// Both take the operands _flash_backward prepares on the host: q2 = q a
// log2(e) in the input dtype, the log2 lse l2 [N, T] and dvec = rowsum(dO
// out) - g_lse [N, T] (fp32).  Per 64 x 64 tile, as _flash_bwd_p_block:
// P = exp2(q2 k^T - l2) (0 on dead rows), the causal and window mask on
// straddling tiles only, dS = P (dO v^T - dvec); dQ = a sum dS K, dV =
// sum P^T dO and dK = (1 / log2 e) sum dS^T q2 over the whole GQA group
// (packed q row n reads K/V row n / (N / Nk); K/V are never expanded).
// The live cells are the Pallas schedules' (col <= row, row - col <
// window, col < Tk, row < T); the sums run in another order than the
// plain versions' blocks, so the two agree to rounding, not bitwise.
//
// What bounds them on this card: operations.  A causal backward does
// 3 T^2 D / 2 (dq) and 2 T^2 D (dkv) multiply-adds per head against
// ~6 T D element reads and writes, far above the ~20 operations per byte
// of fp32 FMA or the ~295 of bf16 tensor cores on an H100.  What kept
// the first port (one CTA per tile, 4 x 4 scalar-read score tiles, serial
// staging, fp32 FMAs for every MXU dtype) far from that, and what this
// design does about it:
//  * the dK/dV launch: one CTA per (K/V head, k tile), 128 CTAs on 132
//    SMs at the training shape, the CTA of k tile 0 walking 64 times the
//    steps of the last.  Now the wrapper's plan (ops/flash.py bwd_plan)
//    cuts each tile's walk (every q head of its group over its live q
//    tiles) into items of at most 1/12 (fp32) or 1/6 (bf16) of an SM's
//    average work, launched longest first, one CTA each: 1,572 items of
//    at most 11 steps (fp32) or 816 of at most 22 (bf16) against 126 per
//    SM there (was 128 CTAs, the heaviest 256 steps).  An item alone on
//    its tile stores dK/dV; the items of a split tile store fp32 partials
//    and the last to arrive (an integer atomic per tile, left at zero)
//    sums them in slot order, so two launches give the same bits and no
//    float atomics run.  dq keeps one CTA per (q head, q tile), the last
//    q tiles first: 512 CTAs, already near a balanced schedule.
//  * shared-memory loads: operand tiles are [64][D] with 16-byte chunks
//    XOR-swizzled by row (no padding), read as whole chunks.
//  * staging: 16-byte cp.async into double-buffered tiles (K/V for dq;
//    q2/dO/l2/dvec for dK/dV), the next tile landing during the current
//    one's products; fp32 inputs under the bf16 MXU dtype are rounded
//    once at staging (plain loads), bf16 inputs are copied raw.
//
// Two mainloops, chosen by the MXU dtype:
//  * float32 (*_fma, 256 threads): fp32 FMA only, no TF32 and no tensor
//    core (the fp32 MXU dtype means full fp32 products).  A thread holds
//    4 x 4 of S and 4 x 4 of dP, read per 16-byte chunk of d (8 LDS.128
//    per 128 FMAs), and RA x 4 CA of each accumulator (4 x 8 at D = 128,
//    12 LDS.128 per 128 FMAs).  At D = 128: dq 208.5 KB of shared memory
//    and 168 registers, dkv 225 KB and 220 registers, 1 CTA per SM (the
//    fp32 tiles do not fit twice).
//  * bfloat16 (*_mma, 128 threads, 4 warps of 16 rows): S, dP, P^T dO,
//    dS K and dS^T q2 on mma.sync.m16n8k16 bf16 -> fp32 from ldmatrix
//    fragments of swizzled bf16 tiles; the score accumulators repacked in
//    registers, rounded to bf16, as the next product's left operand
//    (where the Pallas kernels cast P and dS); exp2, masks and dS in fp32
//    registers.  The products are exact, the sums fp32.  At D = 128: dq
//    96 KB and 241 registers, dkv 97 KB and 255 registers (72 bytes of
//    spill), 2 CTAs per SM.
// wgmma, TMA and a fused single-kernel backward are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // K/V rows per tile
constexpr int FMA_THREADS = 256;
constexpr int MMA_THREADS = 128;  // 4 warps, 16 tile rows each
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -5e29f;
constexpr float INV_LOG2E = 0.6931471805599453f;  // 1 / log2(e)

enum { DT_F32 = 0, DT_BF16 = 1 };

// One work item of the dK/dV launch (ops/flash.py bwd_plan): K/V tile
// `tile` (= kt * Nk + kv head) over steps [j0, j1) of its walk, step j
// being q head g = j / nlive of the group at q tile first + j % nlive;
// `slot` is the item's partial in the scratch when its tile is split.
struct Item {
  int tile, j0, j1, slot;
};
// Per K/V tile: how many items share it, and the slot of its first.
struct TileInfo {
  int parts, first_slot;
};

struct Params {
  const void* q2;
  const void* k;
  const void* v;
  const void* dout;
  const float* l2;
  const float* dvec;
  void* dq;
  void* dk;
  void* dv;
  const Item* items;
  const TileInfo* tiles;
  float* ws;      // split tiles' partials: [slot][2][BK][D] fp32, dK then dV
  int* counters;  // per tile: items counted in (left at zero)
  int N, Nk, T, Tk, group;
  int causal, window;  // window 0 = none
  float scale_a;
};

// ------------------------------------------------------------------------
// masks, shared by every kernel
// ------------------------------------------------------------------------
// The pair (q row, k col) of a masked tile counts: inside K, on or below
// the diagonal, inside the window.
__device__ __forceinline__ bool keep(const Params& p, int row, int col) {
  bool k = col < p.Tk;
  if (p.causal) k = k && row >= col;
  if (p.window > 0) k = k && row - col < p.window;
  return k;
}

// A tile of rows [r0, r_last] against columns [c0, c0 + BK) needs the
// per-pair test: it overhangs K, straddles the diagonal or the window edge.
__device__ __forceinline__ bool needs_mask(const Params& p, int r0, int r_last, int c0) {
  return c0 + BK > p.Tk || (p.causal && c0 + BK - 1 > r0) ||
         (p.window > 0 && r_last - c0 >= p.window);
}

// P = exp2(s - l2), zero on dead rows (past T, or lse = NEG_INF) and on
// pairs the mask drops.
__device__ __forceinline__ float prob(const Params& p, float s, float l2, bool masked, int row,
                                      int col) {
  const float e = (row >= p.T || l2 <= HALF_NEG_INF) ? 0.f : exp2f(s - l2);
  return (masked && !keep(p, row, col)) ? 0.f : e;
}

// The live k tiles of q tile qt (dq's walk): from the window's first
// visible column to the diagonal (_window_first_block, _grid_live_masked).
__device__ __forceinline__ void live_k(const Params& p, int qt, int& first, int& last) {
  const int nkt = (p.Tk + BK - 1) / BK;
  const int q0 = qt * BQ, q_last = min(q0 + BQ, p.T) - 1;
  first = p.window > 0 ? max(q0 - (p.window - 1), 0) / BK : 0;
  last = p.causal ? min(q_last / BK, nkt - 1) : nkt - 1;
}

// The live q tiles of k tile kt (dK/dV's walk, per q head): from the
// diagonal to the last row whose window still reaches the tile.  The
// plan (ops/flash.py _live_q) counts the same.
__device__ __forceinline__ void live_q(const Params& p, int kt, int& first, int& nlive) {
  const int n_qt = (p.T + BQ - 1) / BQ;
  const int k0 = kt * BK, k_last = min(k0 + BK, p.Tk) - 1;
  first = p.causal ? k0 / BQ : 0;
  const int last = p.window > 0 ? min(n_qt - 1, (k_last + p.window - 1) / BQ) : n_qt - 1;
  nlive = max(0, last - first + 1);
}

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
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------------------
// Tiles in shared memory: [64][D] row-major, each row cut in 16-byte
// chunks, chunk c of row r stored at chunk c ^ (r & SW): the 8 rows that
// one LDS.128 phase or one ldmatrix reads at the same logical chunk land
// on distinct banks, with no padding.
// ------------------------------------------------------------------------
template <typename S, int D>
struct Swz {
  static constexpr int EPC = 16 / (int)sizeof(S);  // elements per chunk
  static constexpr int CH = D / EPC;               // chunks per row
  static constexpr int SW = (CH < 8 ? CH : 8) - 1;
  __device__ static __forceinline__ int chunk(int r, int c) { return r * D + ((c ^ (r & SW)) * EPC); }
};

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stage rows [r0, r0 + 64) of a row-major [*, D] operand into a swizzled
// tile, zero past `limit`: raw by cp.async when the tile holds the input's
// own type, else converted with plain loads and stores (bf16 inputs under
// the fp32 MXU dtype widen; fp32 inputs under bf16 round to nearest once).
template <int NT, int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int limit) {
  using Z = Swz<float, D>;
  for (int i = threadIdx.x; i < 64 * Z::CH; i += NT) {
    const int r = i / Z::CH, c = i % Z::CH;
    const bool ok = r0 + r < limit;
    cp_async16(dst + Z::chunk(r, c), ok ? src + (int64_t)(r0 + r) * D + c * 4 : src, ok);
  }
}
template <int NT, int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                      int limit) {
  using Z = Swz<__nv_bfloat16, D>;
  for (int i = threadIdx.x; i < 64 * Z::CH; i += NT) {
    const int r = i / Z::CH, c = i % Z::CH;
    const bool ok = r0 + r < limit;
    cp_async16(dst + Z::chunk(r, c), ok ? src + (int64_t)(r0 + r) * D + c * 8 : src, ok);
  }
}
template <int NT, int D>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, int r0, int limit) {
  using Z = Swz<float, D>;
  for (int i = threadIdx.x; i < 64 * Z::CH; i += NT) {
    const int r = i / Z::CH, c = i % Z::CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit) {
      const uint2 u = *reinterpret_cast<const uint2*>(src + (int64_t)(r0 + r) * D + c * 4);
      x = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                      __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
    }
    *reinterpret_cast<float4*>(dst + Z::chunk(r, c)) = x;
  }
}
template <int NT, int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const float* src, int r0, int limit) {
  using Z = Swz<__nv_bfloat16, D>;
  for (int i = threadIdx.x; i < 64 * Z::CH; i += NT) {
    const int r = i / Z::CH, c = i % Z::CH;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) {
      const float4* s = reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * D + c * 8);
      const float4 a = s[0], b = s[1];
      u = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                     pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(dst + Z::chunk(r, c)) = u;
  }
}

// The 64 per-row fp32 values l2 and dvec of rows [r0, r0 + 64), zero past T
// (prob() drops those rows by index).
template <int NT>
__device__ __forceinline__ void stage_rows(float* ls, float* dvs, const float* l2,
                                           const float* dvec, int r0, int limit) {
  for (int i = threadIdx.x; i < 2 * 64; i += NT) {
    const int r = i & 63;
    const bool ok = r0 + r < limit;
    const float* src = i < 64 ? l2 : dvec;
    cp_async4((i < 64 ? ls : dvs) + r, ok ? src + r0 + r : src, ok);
  }
}

__device__ __forceinline__ void store(float* p, int64_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store2(float* p, int64_t i, float x, float y) {
  *reinterpret_cast<float2*>(p + i) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, int64_t i, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& x, int k) {
  return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
}

// ------------------------------------------------------------------------
// The end of a dK/dV item, shared by both mainloops.  `each(f)` calls
// f(r, c, dk_c, dk_c1, dv_c, dv_c1) for every pair of adjacent columns
// (c, c + 1) of tile row r that the thread holds.  An item alone on its
// tile stores dK / log2(e) and dV.  An item of a split tile stores its
// fp32 partial into its slot and counts itself in on the tile's counter
// (an integer atomic); the last to arrive sums the partials of slots
// first_slot, first_slot + 1, ... in that order, whoever arrived last, so
// two launches give the same bits, stores the tile, and sets the counter
// back to zero.
// ------------------------------------------------------------------------
template <typename T, int D, int NT, typename Each>
__device__ __forceinline__ void finish_dkv(const Params& p, const Item& it, Each each) {
  __shared__ int last;
  const int kt = it.tile / p.Nk, kvn = it.tile % p.Nk, k0 = kt * BK;
  const TileInfo info = p.tiles[it.tile];
  T* dkg = (T*)p.dk + (int64_t)kvn * p.Tk * D;
  T* dvg = (T*)p.dv + (int64_t)kvn * p.Tk * D;
  if (info.parts == 1) {
    each([&](int r, int c, float k0v, float k1v, float v0, float v1) {
      const int row = k0 + r;
      if (row >= p.Tk) return;
      store2(dkg, (int64_t)row * D + c, __fmul_rn(k0v, INV_LOG2E), __fmul_rn(k1v, INV_LOG2E));
      store2(dvg, (int64_t)row * D + c, v0, v1);
    });
    return;
  }
  float* w = p.ws + (int64_t)it.slot * 2 * BK * D;
  each([&](int r, int c, float k0v, float k1v, float v0, float v1) {
    store2(w, r * D + c, k0v, k1v);
    store2(w + BK * D, r * D + c, v0, v1);
  });
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this item's partial before its count
    last = atomicAdd(p.counters + it.tile, 1) == info.parts - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other partial is visible past the count
  const float* w0 = p.ws + (int64_t)info.first_slot * 2 * BK * D;
  for (int i = threadIdx.x; i < 2 * BK * D / 4; i += NT) {
    const int e = i * 4, hv = e / (BK * D), r = (e % (BK * D)) / D, c = e % D;
    if (k0 + r >= p.Tk) continue;
    float4 s = __ldcg(reinterpret_cast<const float4*>(w0 + e));
    for (int q = 1; q < info.parts; ++q) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(w0 + (int64_t)q * 2 * BK * D + e));
      s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
    }
    T* dst = (hv ? dvg : dkg) + (int64_t)(k0 + r) * D + c;
    if (!hv) {
      s.x = __fmul_rn(s.x, INV_LOG2E); s.y = __fmul_rn(s.y, INV_LOG2E);
      s.z = __fmul_rn(s.z, INV_LOG2E); s.w = __fmul_rn(s.w, INV_LOG2E);
    }
    store2(dst, 0, s.x, s.y);
    store2(dst, 2, s.z, s.w);
  }
  if (threadIdx.x == 0) p.counters[it.tile] = 0;  // every item of the tile has counted
}

// ------------------------------------------------------------------------
// The fp32 mainloop (MXU dtype float32): fp32 FMA only, no TF32, no
// tensor cores.  256 threads.  Score tiles (S, dP; S^T, dP^T): thread
// (ty, tx) = (tid / 16, tid % 16) holds rows 4 ty + i and columns tx +
// 16 j (i, j < 4) of both, read as 16-byte chunks along d: per chunk 4 +
// 4 LDS.128 of the row operands (two rows per warp: broadcasts) and 4 + 4
// of the column operands (16 rows per warp on distinct banks by the
// swizzle) feed 128 FMAs.  Accumulating products (dS K; P^T dO, dS^T q2):
// thread (tid / TC, tid % TC) holds RA rows by CA 16-byte column chunks
// (4 x 8 floats at D = 128), per 4 steps RA + 4 CA LDS.128 for 16 RA CA
// FMAs.
// ------------------------------------------------------------------------
template <int D>
struct AccMap {
  static constexpr int NCH = D / 4;
  static constexpr int TC = NCH < 16 ? NCH : 16;     // threads along the columns
  static constexpr int CA = NCH / TC;                // column chunks a thread holds
  static constexpr int RA = 64 * TC / FMA_THREADS;   // rows a thread holds
};

// s[i][j] = sum_d A[4 ty + i][d] B[tx + 16 j][d], t likewise from (A2,
// B2), in d order, over swizzled [64][D] tiles.
template <int D>
__device__ __forceinline__ void score2(const float* A, const float* B, const float* A2,
                                       const float* B2, float (&s)[4][4], float (&t)[4][4]) {
  using Z = Swz<float, D>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < Z::CH; ++c) {
    float4 a[4], b[4], a2[4], b2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = lds4(A + Z::chunk(4 * ty + i, c));
      a2[i] = lds4(A2 + Z::chunk(4 * ty + i, c));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = lds4(B + Z::chunk(tx + 16 * j, c));
      b2[j] = lds4(B2 + Z::chunk(tx + 16 * j, c));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(comp(a[i], kk), comp(b[j], kk), s[i][j]);
          t[i][j] = fmaf(comp(a2[i], kk), comp(b2[j], kk), t[i][j]);
        }
  }
}

// acc[i][4 h + e] += sum_c X[RA ry + i][c] Y[c][4 (cx + TC h) + e] over a
// swizzled [64][64] X and a swizzled [64][D] Y, in c order.
template <int D>
__device__ __forceinline__ void acc_product(const float* X, const float* Y,
                                            float (&acc)[AccMap<D>::RA][4 * AccMap<D>::CA]) {
  using M = AccMap<D>;
  using ZX = Swz<float, 64>;
  using ZY = Swz<float, D>;
  const int ry = threadIdx.x / M::TC, cx = threadIdx.x % M::TC;
#pragma unroll 2
  for (int kc = 0; kc < 16; ++kc) {
    float4 x[M::RA];
#pragma unroll
    for (int i = 0; i < M::RA; ++i) x[i] = lds4(X + ZX::chunk(M::RA * ry + i, kc));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 y[M::CA];
#pragma unroll
      for (int h = 0; h < M::CA; ++h) y[h] = lds4(Y + ZY::chunk(4 * kc + kk, cx + M::TC * h));
#pragma unroll
      for (int i = 0; i < M::RA; ++i) {
        const float xv = comp(x[i], kk);
#pragma unroll
        for (int h = 0; h < M::CA; ++h) {
          acc[i][4 * h] = fmaf(xv, y[h].x, acc[i][4 * h]);
          acc[i][4 * h + 1] = fmaf(xv, y[h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(xv, y[h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(xv, y[h].w, acc[i][4 * h + 3]);
        }
      }
    }
  }
}

// Score element (i, j) of the thread into a swizzled [64][64] tile.
__device__ __forceinline__ float& score_at(float* S, int i, int j) {
  const int r = 4 * (threadIdx.x >> 4) + i, c = (threadIdx.x & 15) + 16 * j;
  return S[Swz<float, 64>::chunk(r, c >> 2) + (c & 3)];
}

template <int D>
struct FmaSmem {
  static constexpr int TILE = 64 * D;
  // dq: Q, dO, K[2], V[2], dS, l2, dvec.  dkv: K, V, Q[2], dO[2], P^T,
  // dS^T, l2[2], dvec[2]
  static constexpr size_t dq = (size_t)(6 * TILE + 64 * 64 + 2 * 64) * 4;
  static constexpr size_t dkv = (size_t)(6 * TILE + 2 * 64 * 64 + 4 * 64) * 4;
};

// dq: one CTA per (packed q head, q tile), q tiles last first (under a
// causal mask the last see the most k tiles), walking the live k tiles
// with K/V double-buffered by cp.async.
template <typename T, int D>
__global__ void __launch_bounds__(FMA_THREADS, 1) flash_bwd_dq_fma(Params p) {
  using M = AccMap<D>;
  constexpr int TILE = 64 * D;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + TILE;
  float* Ks = Os + TILE;  // two buffers
  float* Vs = Ks + 2 * TILE;
  float* Ss = Vs + 2 * TILE;
  float* Ls = Ss + 64 * 64;
  float* Dv = Ls + 64;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_qt = (p.T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / p.N);
  const int n = (int)(blockIdx.x % p.N);
  const int q0 = qt * BQ, q_last = min(q0 + BQ, p.T) - 1;
  const int kvn = n / p.group;
  const T* kg = (const T*)p.k + (int64_t)kvn * p.Tk * D;
  const T* vg = (const T*)p.v + (int64_t)kvn * p.Tk * D;
  stage<FMA_THREADS, D>(Qs, (const T*)p.q2 + (int64_t)n * p.T * D, q0, p.T);
  stage<FMA_THREADS, D>(Os, (const T*)p.dout + (int64_t)n * p.T * D, q0, p.T);
  stage_rows<FMA_THREADS>(Ls, Dv, p.l2 + (int64_t)n * p.T, p.dvec + (int64_t)n * p.T, q0, p.T);
  int first, last;
  live_k(p, qt, first, last);
  if (first <= last) {
    stage<FMA_THREADS, D>(Ks, kg, first * BK, p.Tk);
    stage<FMA_THREADS, D>(Vs, vg, first * BK, p.Tk);
  }
  cp_async_commit();
  float acc[M::RA][4 * M::CA];
#pragma unroll
  for (int i = 0; i < M::RA; ++i)
#pragma unroll
    for (int j = 0; j < 4 * M::CA; ++j) acc[i][j] = 0.f;
  for (int kt = first; kt <= last; ++kt) {
    const int buf = (kt - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed; every read of tile kt - 1 and of dS is done
    if (kt < last) {
      stage<FMA_THREADS, D>(Ks + (buf ^ 1) * TILE, kg, (kt + 1) * BK, p.Tk);
      stage<FMA_THREADS, D>(Vs + (buf ^ 1) * TILE, vg, (kt + 1) * BK, p.Tk);
    }
    cp_async_commit();
    const float* Kc = Ks + buf * TILE;
    const float* Vc = Vs + buf * TILE;
    const int c0 = kt * BK;
    const bool masked = needs_mask(p, q0, q_last, c0);
    float s[4][4], dp[4][4];
    score2<D>(Qs, Kc, Os, Vc, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float l2 = Ls[r], dv = Dv[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = prob(p, s[i][j], l2, masked, q0 + r, c0 + tx + 16 * j);
        score_at(Ss, i, j) = pr * (dp[i][j] - dv);
      }
    }
    __syncthreads();
    acc_product<D>(Ss, Kc, acc);
  }
  cp_async_wait_all();
  T* dqg = (T*)p.dq + (int64_t)n * p.T * D;
  const int ry = threadIdx.x / M::TC, cx = threadIdx.x % M::TC;
#pragma unroll
  for (int i = 0; i < M::RA; ++i) {
    const int row = q0 + M::RA * ry + i;
    if (row >= p.T) continue;
#pragma unroll
    for (int h = 0; h < M::CA; ++h) {
      const int64_t o = (int64_t)row * D + 4 * (cx + M::TC * h);
      store2(dqg, o, __fmul_rn(acc[i][4 * h], p.scale_a), __fmul_rn(acc[i][4 * h + 1], p.scale_a));
      store2(dqg, o + 2, __fmul_rn(acc[i][4 * h + 2], p.scale_a),
             __fmul_rn(acc[i][4 * h + 3], p.scale_a));
    }
  }
}

// dkv: one CTA per plan item: K and V of its tile resident, the q2 / dO
// tiles of its steps double-buffered by cp.async.
template <typename T, int D>
__global__ void __launch_bounds__(FMA_THREADS, 1) flash_bwd_dkv_fma(Params p) {
  using M = AccMap<D>;
  constexpr int TILE = 64 * D;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;  // two buffers
  float* Os = Qs + 2 * TILE;
  float* Ps = Os + 2 * TILE;
  float* Ss = Ps + 64 * 64;
  float* Ls = Ss + 64 * 64;  // two buffers of 64
  float* Dv = Ls + 2 * 64;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Item it = p.items[blockIdx.x];
  const int kt = it.tile / p.Nk, kvn = it.tile % p.Nk, k0 = kt * BK;
  int first, nlive;
  live_q(p, kt, first, nlive);
  stage<FMA_THREADS, D>(Ks, (const T*)p.k + (int64_t)kvn * p.Tk * D, k0, p.Tk);
  stage<FMA_THREADS, D>(Vs, (const T*)p.v + (int64_t)kvn * p.Tk * D, k0, p.Tk);
  auto stage_step = [&](int j, int b) {
    const int n = kvn * p.group + j / nlive, q0 = (first + j % nlive) * BQ;
    stage<FMA_THREADS, D>(Qs + b * TILE, (const T*)p.q2 + (int64_t)n * p.T * D, q0, p.T);
    stage<FMA_THREADS, D>(Os + b * TILE, (const T*)p.dout + (int64_t)n * p.T * D, q0, p.T);
    stage_rows<FMA_THREADS>(Ls + b * 64, Dv + b * 64, p.l2 + (int64_t)n * p.T,
                            p.dvec + (int64_t)n * p.T, q0, p.T);
  };
  if (it.j0 < it.j1) stage_step(it.j0, 0);
  cp_async_commit();
  float dka[M::RA][4 * M::CA], dva[M::RA][4 * M::CA];
#pragma unroll
  for (int i = 0; i < M::RA; ++i)
#pragma unroll
    for (int j = 0; j < 4 * M::CA; ++j) dka[i][j] = dva[i][j] = 0.f;
  for (int j = it.j0; j < it.j1; ++j) {
    const int buf = (j - it.j0) & 1;
    cp_async_wait_all();
    __syncthreads();  // step j has landed; every read of step j - 1, P^T and dS^T is done
    if (j + 1 < it.j1) stage_step(j + 1, buf ^ 1);
    cp_async_commit();
    const float* Qc = Qs + buf * TILE;
    const float* Oc = Os + buf * TILE;
    const float* Lc = Ls + buf * 64;
    const float* Dc = Dv + buf * 64;
    const int q0 = (first + j % nlive) * BQ;
    const bool masked = needs_mask(p, q0, min(q0 + BQ, p.T) - 1, k0);
    // transposed tiles: rows are the item's k rows, columns the q rows
    float st[4][4], dpt[4][4];
    score2<D>(Ks, Qc, Vs, Oc, st, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qr = tx + 16 * jj;
        const float pr = prob(p, st[i][jj], Lc[qr], masked, q0 + qr, k0 + 4 * ty + i);
        score_at(Ps, i, jj) = pr;
        score_at(Ss, i, jj) = pr * (dpt[i][jj] - Dc[qr]);
      }
    __syncthreads();
    acc_product<D>(Ps, Oc, dva);
    acc_product<D>(Ss, Qc, dka);
  }
  cp_async_wait_all();
  const int ry = threadIdx.x / M::TC, cx = threadIdx.x % M::TC;
  finish_dkv<T, D, FMA_THREADS>(p, it, [&](auto f) {
#pragma unroll
    for (int i = 0; i < M::RA; ++i)
#pragma unroll
      for (int h = 0; h < M::CA; ++h)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          f(M::RA * ry + i, 4 * (cx + M::TC * h) + e, dka[i][4 * h + e], dka[i][4 * h + e + 1],
            dva[i][4 * h + e], dva[i][4 * h + e + 1]);
  });
}

// ------------------------------------------------------------------------
// The bf16 mainloop (MXU dtype bfloat16): every product on the tensor
// cores, mma.sync.m16n8k16 bf16 x bf16 -> fp32.  128 threads, warp w
// holding tile rows 16 w .. 16 w + 15 of every product.  Operands sit in
// swizzled bf16 tiles and reach the registers by ldmatrix (.trans for
// the accumulating products' right operand); the score accumulators are
// repacked in registers as the next product's left operand (the C layout
// of two adjacent n8 tiles is the A layout of one k16 slice), rounded to
// bf16 there, where the Pallas kernels cast P and dS to the MXU dtype.
// exp2, the masks and dS stay in fp32 registers.
// ------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[nt] (16 x 8 each, nt < 8) = A[r0 .. r0 + 16) B^T over d: a 16 x 64
// score block of the warp from two swizzled [64][D] tiles.
template <int D>
__device__ __forceinline__ void mma_score(const bf16* A, const bf16* B, int r0,
                                          float (&c)[8][4]) {
  using Z = Swz<bf16, D>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + Z::chunk(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * kk + (lane >> 4)));
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t b[4];
      ldsm_x4(b, B + Z::chunk(16 * nb + (lane & 7) + (lane >> 4) * 8, 2 * kk + ((lane >> 3) & 1)));
      mma16816(c[2 * nb], a, b[0], b[1]);
      mma16816(c[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

// The warp's 16 x 64 score block as the left operand of the next
// product: four k16 slices, rounded to bf16.
__device__ __forceinline__ void pack_a(const float (&c)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc[nt] (16 x 8 each, nt < D / 8) += a (16 x 64) Y, Y a swizzled
// [64][D] tile read row-major ([k][n]) through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_acc(const uint32_t (&a)[4][4], const bf16* Y,
                                        float (&acc)[D / 8][4]) {
  using Z = Swz<bf16, D>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      uint32_t b[4];
      ldsm_x4_t(b, Y + Z::chunk(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * nb + (lane >> 4)));
      mma16816(acc[2 * nb], a[kk], b[0], b[1]);
      mma16816(acc[2 * nb + 1], a[kk], b[2], b[3]);
    }
}

template <int D>
struct MmaSmem {
  static constexpr int TILE = 64 * D;  // bf16 elements
  // dq: Q, dO, K[2], V[2].  dkv: K, V, Q[2], dO[2], then l2[2], dvec[2] fp32
  static constexpr size_t dq = (size_t)6 * TILE * 2;
  static constexpr size_t dkv = (size_t)6 * TILE * 2 + 4 * 64 * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_bwd_dq_mma(Params p) {
  constexpr int TILE = 64 * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + TILE;
  bf16* Ks = Os + TILE;  // two buffers
  bf16* Vs = Ks + 2 * TILE;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (p.T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / p.N);
  const int n = (int)(blockIdx.x % p.N);
  const int q0 = qt * BQ, q_last = min(q0 + BQ, p.T) - 1;
  const int kvn = n / p.group;
  const T* kg = (const T*)p.k + (int64_t)kvn * p.Tk * D;
  const T* vg = (const T*)p.v + (int64_t)kvn * p.Tk * D;
  stage<MMA_THREADS, D>(Qs, (const T*)p.q2 + (int64_t)n * p.T * D, q0, p.T);
  stage<MMA_THREADS, D>(Os, (const T*)p.dout + (int64_t)n * p.T * D, q0, p.T);
  int first, last;
  live_k(p, qt, first, last);
  if (first <= last) {
    stage<MMA_THREADS, D>(Ks, kg, first * BK, p.Tk);
    stage<MMA_THREADS, D>(Vs, vg, first * BK, p.Tk);
  }
  cp_async_commit();
  int rows[2];
  float l2r[2], dvr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = q0 + r0 + g + 8 * h;
    l2r[h] = rows[h] < p.T ? p.l2[(int64_t)n * p.T + rows[h]] : NEG_INF;
    dvr[h] = rows[h] < p.T ? p.dvec[(int64_t)n * p.T + rows[h]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int kt = first; kt <= last; ++kt) {
    const int buf = (kt - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed; every read of tile kt - 1 is done
    if (kt < last) {
      stage<MMA_THREADS, D>(Ks + (buf ^ 1) * TILE, kg, (kt + 1) * BK, p.Tk);
      stage<MMA_THREADS, D>(Vs + (buf ^ 1) * TILE, vg, (kt + 1) * BK, p.Tk);
    }
    cp_async_commit();
    const bf16* Kc = Ks + buf * TILE;
    const bf16* Vc = Vs + buf * TILE;
    const int c0 = kt * BK;
    const bool masked = needs_mask(p, q0, q_last, c0);
    float s[8][4], dp[8][4];
    mma_score<D>(Qs, Kc, r0, s);
    mma_score<D>(Os, Vc, r0, dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float pr = prob(p, s[nt][e], l2r[h], masked, rows[h], c0 + 8 * nt + 2 * t + (e & 1));
        s[nt][e] = pr * (dp[nt][e] - dvr[h]);  // dS
      }
    uint32_t a[4][4];
    pack_a(s, a);
    mma_acc<D>(a, Kc, acc);
  }
  cp_async_wait_all();
  T* dqg = (T*)p.dq + (int64_t)n * p.T * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= p.T) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2(dqg, (int64_t)rows[h] * D + 8 * nt + 2 * t, __fmul_rn(acc[nt][2 * h], p.scale_a),
             __fmul_rn(acc[nt][2 * h + 1], p.scale_a));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_bwd_dkv_mma(Params p) {
  constexpr int TILE = 64 * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;  // two buffers
  bf16* Os = Qs + 2 * TILE;
  float* Ls = reinterpret_cast<float*>(Os + 2 * TILE);  // two buffers of 64
  float* Dv = Ls + 2 * 64;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const Item it = p.items[blockIdx.x];
  const int kt = it.tile / p.Nk, kvn = it.tile % p.Nk, k0 = kt * BK;
  int first, nlive;
  live_q(p, kt, first, nlive);
  stage<MMA_THREADS, D>(Ks, (const T*)p.k + (int64_t)kvn * p.Tk * D, k0, p.Tk);
  stage<MMA_THREADS, D>(Vs, (const T*)p.v + (int64_t)kvn * p.Tk * D, k0, p.Tk);
  auto stage_step = [&](int j, int b) {
    const int n = kvn * p.group + j / nlive, q0 = (first + j % nlive) * BQ;
    stage<MMA_THREADS, D>(Qs + b * TILE, (const T*)p.q2 + (int64_t)n * p.T * D, q0, p.T);
    stage<MMA_THREADS, D>(Os + b * TILE, (const T*)p.dout + (int64_t)n * p.T * D, q0, p.T);
    stage_rows<MMA_THREADS>(Ls + b * 64, Dv + b * 64, p.l2 + (int64_t)n * p.T,
                            p.dvec + (int64_t)n * p.T, q0, p.T);
  };
  if (it.j0 < it.j1) stage_step(it.j0, 0);
  cp_async_commit();
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;
  for (int j = it.j0; j < it.j1; ++j) {
    const int buf = (j - it.j0) & 1;
    cp_async_wait_all();
    __syncthreads();  // step j has landed; every read of step j - 1 is done
    if (j + 1 < it.j1) stage_step(j + 1, buf ^ 1);
    cp_async_commit();
    const bf16* Qc = Qs + buf * TILE;
    const bf16* Oc = Os + buf * TILE;
    const float* Lc = Ls + buf * 64;
    const float* Dc = Dv + buf * 64;
    const int q0 = (first + j % nlive) * BQ;
    const bool masked = needs_mask(p, q0, min(q0 + BQ, p.T) - 1, k0);
    // transposed blocks: rows are the warp's k rows, columns the q rows
    float st[8][4], dpt[8][4];
    uint32_t a[4][4];
    mma_score<D>(Ks, Qc, r0, st);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = 8 * nt + 2 * t + (e & 1);
        st[nt][e] = prob(p, st[nt][e], Lc[qr], masked, q0 + qr, k0 + r0 + g + 8 * (e >> 1));
      }
    pack_a(st, a);
    mma_acc<D>(a, Oc, dva);  // dV += P^T dO
    mma_score<D>(Vs, Oc, r0, dpt);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = 8 * nt + 2 * t + (e & 1);
        dpt[nt][e] = st[nt][e] * (dpt[nt][e] - Dc[qr]);  // dS^T
      }
    pack_a(dpt, a);
    mma_acc<D>(a, Qc, dka);  // dK += dS^T q2
  }
  cp_async_wait_all();
  finish_dkv<T, D, MMA_THREADS>(p, it, [&](auto f) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(r0 + g + 8 * h, 8 * nt + 2 * t, dka[nt][2 * h], dka[nt][2 * h + 1], dva[nt][2 * h],
          dva[nt][2 * h + 1]);
  });
}

// ------------------------------------------------------------------------
// launches
// ------------------------------------------------------------------------
template <typename T, int D, bool DQ, bool MMA>
struct Kernel {
  static void (*fn())(Params) {
    return DQ ? (MMA ? &flash_bwd_dq_mma<T, D> : &flash_bwd_dq_fma<T, D>)
              : (MMA ? &flash_bwd_dkv_mma<T, D> : &flash_bwd_dkv_fma<T, D>);
  }
  static constexpr size_t smem = MMA ? (DQ ? MmaSmem<D>::dq : MmaSmem<D>::dkv)
                                     : (DQ ? FmaSmem<D>::dq : FmaSmem<D>::dkv);
  static constexpr int threads = MMA ? MMA_THREADS : FMA_THREADS;
};

template <typename T, int D, bool DQ, bool MMA>
cudaError_t launch(const Params& p, int grid, cudaStream_t stream) {
  using K = Kernel<T, D, DQ, MMA>;
  cudaError_t e =
      cudaFuncSetAttribute(K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::smem);
  if (e != cudaSuccess) return e;
  if (grid == 0) return cudaSuccess;
  K::fn()<<<grid, K::threads, K::smem, stream>>>(p);
  return cudaGetLastError();
}

// registers, local (spill) bytes, static and dynamic shared memory and
// resident CTAs per SM of one kernel, at the footprint it launches with
template <typename T, int D, bool DQ, bool MMA>
cudaError_t info(int* out) {
  using K = Kernel<T, D, DQ, MMA>;
  cudaError_t e =
      cudaFuncSetAttribute(K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, K::fn());
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, K::fn(), K::threads, K::smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)K::smem;
  out[4] = blocks;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t pick(const Params* p, int which, int mxu_bf16, int grid, cudaStream_t st, int* out) {
  if (out)
    return which == 0 ? (mxu_bf16 ? info<T, D, true, true>(out) : info<T, D, true, false>(out))
                      : (mxu_bf16 ? info<T, D, false, true>(out) : info<T, D, false, false>(out));
  return which == 0
             ? (mxu_bf16 ? launch<T, D, true, true>(*p, grid, st)
                         : launch<T, D, true, false>(*p, grid, st))
             : (mxu_bf16 ? launch<T, D, false, true>(*p, grid, st)
                         : launch<T, D, false, false>(*p, grid, st));
}

// which 0 = dq, 1 = dkv; a launch of `grid` CTAs when out is null, else
// the kernel's footprint into out[5]
cudaError_t dispatch(const Params* p, int which, int head_dim, int dtype, int mxu_bf16, int grid,
                     int device, void* stream, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = (cudaStream_t)stream;
#define ACCL_FLASH_BWD_CASE(DIM)                                                          \
  case DIM:                                                                               \
    return dtype == DT_F32    ? pick<float, DIM>(p, which, mxu_bf16, grid, st, out)       \
           : dtype == DT_BF16 ? pick<__nv_bfloat16, DIM>(p, which, mxu_bf16, grid, st, out) \
                              : cudaErrorInvalidValue;
  switch (head_dim) {
    ACCL_FLASH_BWD_CASE(32)
    ACCL_FLASH_BWD_CASE(64)
    ACCL_FLASH_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef ACCL_FLASH_BWD_CASE
}

cudaError_t check(const Params& p) {
  if (p.N <= 0 || p.Nk <= 0 || p.T < 0 || p.Tk < 0 || p.N % p.Nk != 0)
    return cudaErrorInvalidValue;
  if (p.causal && p.T != p.Tk) return cudaErrorInvalidValue;
  if (p.window < 0 || (p.window > 0 && !p.causal)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

Params make_params(const void* q2, const void* k, const void* v, const void* dout,
                   const float* l2, const float* dvec, int N, int Nk, int T, int Tk, int causal,
                   int window) {
  Params p = {};
  p.q2 = q2;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.l2 = l2;
  p.dvec = dvec;
  p.N = N;
  p.Nk = Nk;
  p.T = T;
  p.Tk = Tk;
  p.group = Nk > 0 ? N / Nk : 1;
  p.causal = causal;
  p.window = window;
  p.scale_a = 1.f;
  return p;
}

}  // namespace

extern "C" {

const char* accl_flash_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Footprint of one kernel (which 0 = dq, 1 = dkv) at its launch
// configuration: registers, local bytes, static and dynamic shared
// memory, resident CTAs per SM
int accl_flash_bwd_kernel_info(int which, int D, int dtype, int mxu_bf16, int device, int* out) {
  return (int)dispatch(nullptr, which, D, dtype, mxu_bf16, 0, device, nullptr, out);
}

// dq: one CTA per packed q head and q tile
int accl_flash_bwd_dq(const void* q2, const void* k, const void* v, const void* dout,
                      const float* l2, const float* dvec, void* dq, int N, int Nk, int T, int Tk,
                      int D, int dtype, int causal, int window, int mxu_bf16, float scale_a,
                      int device, void* stream) {
  Params p = make_params(q2, k, v, dout, l2, dvec, N, Nk, T, Tk, causal, window);
  p.dq = dq;
  p.scale_a = scale_a;
  cudaError_t e = check(p);
  if (e != cudaSuccess) return (int)e;
  const int64_t grid = (int64_t)N * ((T + BQ - 1) / BQ);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return (int)dispatch(&p, 0, D, dtype, mxu_bf16, (int)grid, device, stream, nullptr);
}

// dkv: one CTA per item of the plan (items [n_items] of Item, tiles
// [Nk * K tiles] of TileInfo, both on the card), ws the split tiles'
// partials and counters one int per tile, zero on entry and on return
int accl_flash_bwd_dkv(const void* q2, const void* k, const void* v, const void* dout,
                       const float* l2, const float* dvec, void* dk, void* dv, const void* items,
                       const void* tiles, float* ws, int* counters, int n_items, int N, int Nk,
                       int T, int Tk, int D, int dtype, int causal, int window, int mxu_bf16,
                       int device, void* stream) {
  Params p = make_params(q2, k, v, dout, l2, dvec, N, Nk, T, Tk, causal, window);
  p.dk = dk;
  p.dv = dv;
  p.items = (const Item*)items;
  p.tiles = (const TileInfo*)tiles;
  p.ws = ws;
  p.counters = counters;
  cudaError_t e = check(p);
  if (e != cudaSuccess) return (int)e;
  if (n_items < 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(&p, 1, D, dtype, mxu_bf16, n_items, device, stream, nullptr);
}

}  // extern "C"
