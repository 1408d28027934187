// Flash-attention forward: tiled QK^T -> online softmax -> PV, with the
// running (max, denominator) carried across K tiles, so the [T, Tk] score
// matrix never reaches device memory.  Writes out [N, T, D] and the
// log-sum-exp [N, T] (fp32, natural-log units).
//
// Replaces the Pallas TPU kernels of accl_tpu/ops/flash.py, all three by
// one kernel per mainloop (entry accl_flash_fwd; the wrappers of
// ops/flash.py keep a launch count each):
//  * flash_fwd_resident <- _flash_kernel_resident (:288, call :733): the
//    K/V row of one packed head is walked whole by each q tile, causal
//    tiles split into an unmasked past run and a masked diagonal run
//    (_causal_block_bounds, :155), future tiles skipped;
//  * flash_fwd_grid <- _flash_kernel_grid (:188, call :788), also its
//    grid_resident mode: every (q tile, k tile) cell is judged by the
//    live/diagonal predicates of _grid_live_masked (:856), and a sliding
//    window bounds the k range to the tiles the q tile can see, starting
//    at _window_first_block (:848);
//  * flash_fwd_resident_skew <- _flash_kernel_resident_skew (:403, call
//    :733 via :709-714): the resident walk with the next K tile's scores
//    issued before the current tile's softmax and PV.  On this card that
//    lookahead is the tensor-core mainloop's own order in every schedule
//    (the S wgmma of tile kt + 1 runs under the softmax of tile kt); the
//    fp32 FMAs have nothing asynchronous to overlap (a register-carried
//    lookahead measured within 1 % of the resident walk).  So the skew is
//    the resident kernel, and its out and lse equal flash_fwd_resident's
//    bit for bit, as the Pallas pair's do.
//
// On a tiling of 64-row k tiles the three walks are one: q tile [q0, q0 +
// rows) folds the k tiles [first, end), first = _window_first_block (0
// without a window), end the tile past the diagonal (every tile without
// causal); a tile takes the per-cell test (col <= row, row - col <
// window, col < Tk) when it straddles the diagonal or the window edge or
// overhangs K, which at 64 rows is _causal_block_bounds' diagonal run and
// _grid_live_masked's masked set.  ops/flash.py fwd_walk computes the same
// on the host for the tests.
//
// Both mainloops fold as _softmax_fold / _fold_consume / _finalize (:36-152)
// in the log2 domain: q arrives pre-scaled by log2(e)/sqrt(D) (the product
// taken in the input dtype, a bf16 input meeting a bf16-rounded scale as
// JAX's weakly typed constant), probabilities are exp2(s - m), the shift
// is clamped to 0 while a row has seen only masked cells, masked p are
// zeroed, the row sum takes the unrounded p, and the lse is m ln2 +
// ln(max(l, 1e-38)) (NEG_INF = -1e30 for dead rows).  static_max pins the
// shift (no running max).  The running max is rescaled at every 64-column
// tile, where the plain versions rescale at the resolver's block_k, so the
// kernels agree with them to rounding, not bitwise.  Packed q row n reads
// K/V row n / (N / Nk): grouped-query attention without expansion.
//
// What bounds it on this card: operations.  A causal forward does 2 T^2 D
// multiply-adds per head against 4 T D element reads and writes: at T =
// 4096, D = 128 about 1000 operations per byte, far above the ~20 of fp32
// FMA or the ~295 of bf16 tensor cores on an H100.  Two mainloops, chosen
// by the MXU dtype at dispatch (not by a flag inside one kernel):
//
//  * float32 (flash_fwd_fma, 256 threads, one q head and 128 q rows per
//    CTA): fp32 FMA only, no TF32 and no tensor core (the fp32 MXU dtype
//    means full fp32 products).  K/V tiles are staged by 16-byte cp.async
//    into unpadded tiles whose 16-byte chunks are XOR-swizzled by row,
//    double-buffered, so tile kt + 1 lands while tile kt is multiplied.
//    Thread (ty, tx) holds rows 8 ty + i of the score tile at columns tx +
//    16 j (8 x 4) and the same rows of the output accumulator at 8 (D =
//    128) columns, every fragment read as a 16-byte chunk: per chunk of d
//    the scores take 12 LDS.128 for 128 FMAs, the PV product 16 LDS.128
//    for 256 (the first port read one scalar per 2 FMAs; 64-row tiles,
//    one LDS.128 per 8 FMAs, measured 11 % slower).  Each warp writes and
//    reads only its own 16 rows of P, so P needs a __syncwarp, not a
//    barrier: one __syncthreads a tile (was four).  At D = 128 the tiles
//    take 224 KB of shared memory, one CTA per SM.
//  * bfloat16 (flash_fwd_wgmma, one consumer warpgroup of 128 threads per
//    q head, two q heads of one GQA group per CTA where the group is
//    even): S = q K^T and O += P V on the tensor cores by wgmma.mma_async
//    bf16 -> fp32 with 64-row warpgroup tiles.  K and V sit in
//    128-byte-swizzled bf16 tiles (64-column blocks of 128-byte rows,
//    chunk c of row r at c ^ (r & 7)), double-buffered, read through
//    matrix descriptors: K K-major, V MN-major (the transpose flag); q is
//    the S product's register operand (one ldmatrix per k16 slice, once),
//    P the PV product's: the softmax runs on the S accumulator in
//    registers (a row's max and sum across the quad of threads that holds
//    it) and rounds P to bf16 there, so P never touches shared memory.
//    The S wgmma of tile kt + 1 is issued before the softmax of tile kt
//    (the skew's order), the fold order unchanged.
//    bf16 inputs at D >= 64 land by TMA: a producer warpgroup (its first
//    thread issuing, one copy per 64-column block) fills each buffer on a
//    "full" mbarrier, the consumers release it on an "empty" one, and no
//    barrier spans the CTA in the loop; the producer hands its registers
//    to the consumers (setmaxnreg 40 / 232: a ninth warp without it caps
//    a thread at 168 registers, and the consumers spill).  fp32 inputs
//    (rounded to bf16 on the way from a landing area into the tiles) and
//    D = 32 (tiles padded with zero columns to 64) land by cp.async from
//    every thread, one barrier a tile.  At the serving shape (q [8, 4096,
//    128], K/V [2, 4096, 128], causal) on an H100: cp.async 0.143 ms, TMA
//    issued between barriers 0.122, the producer warpgroup 0.102.
//
// Both launch q tiles last first: under a causal mask their work grows
// with the tile index, so the heaviest CTAs are dispatched first.
// Persistent CTAs and a pingpong of the two consumer warpgroups are later
// work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // q rows per tile (per warpgroup in flash_fwd_wgmma)
constexpr int BK = 64;           // K/V rows per tile
constexpr int FMA_THREADS = 256;
constexpr int WG_THREADS = 128;  // one warpgroup per q head
constexpr int MAX_HEADS = 2;     // q heads of one CTA of flash_fwd_wgmma
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -5e29f;
constexpr float LN2 = 0.6931471805599453f;

enum { DT_F32 = 0, DT_BF16 = 1 };

typedef __nv_bfloat16 bf16;

struct Params {
  CUtensorMap tk, tv;  // K and V as [Nk][Tk][D] bf16 for TMA (bf16 inputs, D >= 64)
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int N, Nk, T, Tk, group;
  int heads;           // q heads per CTA (flash_fwd_wgmma; 1 for flash_fwd_fma)
  int causal, window;  // window 0 = none
  int static_on;
  float static_max, scale;
};

// ------------------------------------------------------------------------
// the walk and the masks, shared by both mainloops
// ------------------------------------------------------------------------
// k tiles [first, end) of the q tile of `rows` rows starting at row q0
__device__ __forceinline__ void walk(const Params& p, int q0, int rows, int& first, int& end) {
  const int nkt = (p.Tk + BK - 1) / BK;
  first = p.window > 0 ? max(q0 - (p.window - 1), 0) / BK : 0;
  end = p.causal ? min((q0 + rows - 1) / BK + 1, nkt) : nkt;
}

// Tile kt needs the per-cell test: it overhangs K, straddles the diagonal
// or the window edge.
__device__ __forceinline__ bool tile_masked(const Params& p, int q0, int rows, int kt) {
  const int c0 = kt * BK;
  return c0 + BK > p.Tk || (p.causal && c0 + BK - 1 > q0) ||
         (p.window > 0 && c0 < q0 + rows - p.window);
}

__device__ __forceinline__ bool keep(const Params& p, int row, int col) {
  bool k = col < p.Tk;
  if (p.causal) k = k && row >= col;
  if (p.window > 0) k = k && row - col < p.window;
  return k;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Eight consecutive input elements as floats (16-byte aligned).
__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* src, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store2(float* p, int64_t i, float x, float y) {
  *reinterpret_cast<float2*>(p + i) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, int64_t i, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(x, y);
}

// The lse of one row from its final (m, l): under static_max m is the pin
// for live rows and NEG_INF for dead ones.
__device__ __forceinline__ float row_lse(const Params& p, float m, float l) {
  const float mf = p.static_on ? (l == 0.f ? NEG_INF : p.static_max) : m;
  return mf <= HALF_NEG_INF ? NEG_INF : __fadd_rn(__fmul_rn(mf, LN2), logf(fmaxf(l, 1e-38f)));
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------------------
// The fp32 mainloop (MXU dtype float32).  Tiles are [rows][D] fp32 rows
// cut in 16-byte chunks, chunk c of row r stored at chunk c ^ (r & SW):
// the 8 rows one LDS.128 phase reads at the same logical chunk land on
// distinct banks, with no padding.
// ------------------------------------------------------------------------
template <int D>
struct Swz {
  static constexpr int CH = D / 4;  // chunks per row
  static constexpr int SW = (CH < 8 ? CH : 8) - 1;
  __device__ static __forceinline__ int chunk(int r, int c) { return r * D + ((c ^ (r & SW)) * 4); }
};

// q rows per CTA of the fp32 mainloop: thread (ty, tx) = (tid / 16, tid %
// 16) holds RI = FMA_BQ / 16 rows, RI ty + i, of the score tile (at
// columns tx + 16 j, j < 4) and of the output accumulator, whose columns
// it holds in NP pieces of CW: piece h at columns CW (tx + 16 h) .. + CW
// - 1.  Warp w holds rows 2 RI w .. 2 RI w + 2 RI - 1 of both.
constexpr int FMA_BQ = 128;

template <int D>
struct FmaMap {
  static constexpr int RI = FMA_BQ / 16;
  static constexpr int CW = D >= 64 ? 4 : 2;
  static constexpr int NP = D / (16 * CW);
};

template <int D>
struct FmaSmem {
  static constexpr int TILE = BK * D;
  // Q [FMA_BQ][D], K[2], V[2], P [FMA_BQ][64]
  static constexpr size_t bytes = (size_t)(FMA_BQ * D + 4 * TILE + FMA_BQ * 64) * 4;
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& x, int k) {
  return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
}

// Stage rows [r0, r0 + 64) of a row-major [*, D] input into a swizzled
// fp32 tile, zero past `limit`: by cp.async from fp32, widened by plain
// loads and stores from bf16.
template <int D>
__device__ __forceinline__ void stage_fma(float* dst, const float* src, int r0, int limit) {
  using Z = Swz<D>;
  for (int i = threadIdx.x; i < BK * Z::CH; i += FMA_THREADS) {
    const int r = i / Z::CH, c = i % Z::CH;
    const bool ok = r0 + r < limit;
    cp_async16(dst + Z::chunk(r, c), ok ? src + (int64_t)(r0 + r) * D + c * 4 : src, ok);
  }
}
template <int D>
__device__ __forceinline__ void stage_fma(float* dst, const bf16* src, int r0, int limit) {
  using Z = Swz<D>;
  for (int i = threadIdx.x; i < BK * Z::CH; i += FMA_THREADS) {
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

template <typename T, int D>
__global__ void __launch_bounds__(FMA_THREADS, 1) flash_fwd_fma(const __grid_constant__ Params p) {
  using Z = Swz<D>;
  using ZP = Swz<64>;
  using M = FmaMap<D>;
  constexpr int RI = M::RI, TILE = BK * D;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + FMA_BQ * D;  // two buffers
  float* Vs = Ks + 2 * TILE;    // two buffers
  float* Ps = Vs + 2 * TILE;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_qt = (p.T + FMA_BQ - 1) / FMA_BQ;
  // heads inner, q tiles outer and last first
  const int qt = n_qt - 1 - (int)(blockIdx.x / p.N);
  const int n = (int)(blockIdx.x % p.N);
  const int q0 = qt * FMA_BQ;
  const int kvn = n / p.group;
  const T* qg = (const T*)p.q + (int64_t)n * p.T * D;
  const T* kg = (const T*)p.k + (int64_t)kvn * p.Tk * D;
  const T* vg = (const T*)p.v + (int64_t)kvn * p.Tk * D;
  int first, end;
  walk(p, q0, FMA_BQ, first, end);
  if (first < end) {
    stage_fma<D>(Ks, kg, first * BK, p.Tk);
    stage_fma<D>(Vs, vg, first * BK, p.Tk);
  }
  cp_async_commit();

  // pre-scaled q tile: the product is taken in the input dtype (a bf16
  // input meets a bf16-rounded scale), no further rounding under fp32
  const bool in_bf16 = sizeof(T) == 2;
  const float qscale = in_bf16 ? round_bf16(p.scale) : p.scale;
  for (int i = threadIdx.x; i < FMA_BQ * (D / 8); i += FMA_THREADS) {
    const int r = i / (D / 8), c8 = i % (D / 8);
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.f;
    if (q0 + r < p.T) {
      load8(qg + (int64_t)(q0 + r) * D + c8 * 8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = __fmul_rn(x[e], qscale);
        if (in_bf16) x[e] = round_bf16(x[e]);
      }
    }
    *reinterpret_cast<float4*>(Qs + Z::chunk(r, 2 * c8)) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(Qs + Z::chunk(r, 2 * c8 + 1)) = make_float4(x[4], x[5], x[6], x[7]);
  }

  float m[RI], l[RI], acc[RI][M::CW * M::NP];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < M::CW * M::NP; ++j) acc[i][j] = 0.f;
  }

  for (int kt = first; kt < end; ++kt) {
    const int buf = (kt - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed (and q); every read of tile kt - 1 is done
    if (kt + 1 < end) {
      stage_fma<D>(Ks + (buf ^ 1) * TILE, kg, (kt + 1) * BK, p.Tk);
      stage_fma<D>(Vs + (buf ^ 1) * TILE, vg, (kt + 1) * BK, p.Tk);
    }
    cp_async_commit();
    const float* Kc = Ks + buf * TILE;
    const float* Vc = Vs + buf * TILE;

    // s[i][j] = q[RI ty + i] . K[tx + 16 j], in d order
    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < Z::CH; ++c) {
      float4 a[RI], b[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = lds4(Qs + Z::chunk(RI * ty + i, c));
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = lds4(Kc + Z::chunk(tx + 16 * j, c));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(comp(a[i], kk), comp(b[j], kk), s[i][j]);
    }

    const bool masked = tile_masked(p, q0, FMA_BQ, kt);
    const int c0 = kt * BK;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = RI * ty + i;
      if (masked) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!keep(p, q0 + r, c0 + tx + 16 * j)) s[i][j] = NEG_INF;
      }
      float pr[4];
      float alpha = 1.f;
      if (p.static_on) {
        // pinned shift: exp2(NEG_INF - pin) flushes to 0, no clamp needed
#pragma unroll
        for (int j = 0; j < 4; ++j) pr[j] = exp2f(s[i][j] - p.static_max);
      } else {
        float mb = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off, 16));
        const float m_new = fmaxf(m[i], mb);
        // a row that has seen only masked cells keeps m at NEG_INF; clamp
        // the shift so exp2(s - shift) stays 0, not exp2(+big)
        const float shift = m_new <= HALF_NEG_INF ? 0.f : m_new;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = exp2f(s[i][j] - shift);
          pr[j] = (masked && s[i][j] <= HALF_NEG_INF) ? 0.f : e;
        }
        alpha = m[i] <= HALF_NEG_INF ? 0.f : exp2f(m[i] - shift);
        m[i] = m_new;
      }
      float rs = pr[0] + pr[1] + pr[2] + pr[3];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      l[i] = alpha * l[i] + rs;
#pragma unroll
      for (int j = 0; j < M::CW * M::NP; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        Ps[ZP::chunk(r, col >> 2) + (col & 3)] = pr[j];
      }
    }
    __syncwarp();  // the warp's rows of P are written; only this warp reads them

    // acc[i] += P[RI ty + i] V, in kv-row order
#pragma unroll 2
    for (int kc = 0; kc < BK / 4; ++kc) {
      float4 pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = lds4(Ps + ZP::chunk(RI * ty + i, kc));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = 4 * kc + kk;
        float vv[M::NP][M::CW];
#pragma unroll
        for (int h = 0; h < M::NP; ++h) {
          if constexpr (M::CW == 4) {
            const float4 y = lds4(Vc + Z::chunk(c, tx + 16 * h));
            vv[h][0] = y.x;
            vv[h][1] = y.y;
            vv[h][2] = y.z;
            vv[h][3] = y.w;
          } else {
            const float2 y =
                *reinterpret_cast<const float2*>(Vc + Z::chunk(c, tx >> 1) + 2 * (tx & 1));
            vv[h][0] = y.x;
            vv[h][1] = y.y;
          }
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float xv = comp(pv[i], kk);
#pragma unroll
          for (int h = 0; h < M::NP; ++h)
#pragma unroll
            for (int e = 0; e < M::CW; ++e)
              acc[i][h * M::CW + e] = fmaf(xv, vv[h][e], acc[i][h * M::CW + e]);
        }
      }
    }
  }
  cp_async_wait_all();

  T* og = (T*)p.out + (int64_t)n * p.T * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + RI * ty + i;
    if (row >= p.T) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int h = 0; h < M::NP; ++h)
#pragma unroll
      for (int e = 0; e < M::CW; e += 2)
        store2(og, (int64_t)row * D + M::CW * (tx + 16 * h) + e, acc[i][h * M::CW + e] / denom,
               acc[i][h * M::CW + e + 1] / denom);
    if (tx == 0) p.lse[(int64_t)n * p.T + row] = row_lse(p, m[i], l[i]);
  }
}

// ------------------------------------------------------------------------
// The bf16 mainloop (MXU dtype bfloat16): wgmma on 128-byte-swizzled bf16
// tiles.  A tile of R rows and DP (>= 64) columns is DP / 64 column
// blocks of R rows of 128 bytes; 16-byte chunk c (0..7) of row r of a
// block sits at chunk c ^ (r & 7), the layout TMA's SWIZZLE_128B writes
// and the matrix descriptors' 128-byte swizzle mode reads (tiles start on
// 1024 bytes).
// ------------------------------------------------------------------------
template <int R>
__device__ __forceinline__ int sw128(int r, int col) {  // col a multiple of 8
  return (col >> 6) * (R * 64) + r * 64 + ((((col >> 3) & 7) ^ (r & 7)) << 3);
}

// Matrix descriptor, 128-byte swizzle: start address, leading and stride
// byte offsets (16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// mbarriers and TMA
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Barrier `id` (1..15) among `count` threads
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// A warpgroup's register budget down (a producer) or up (a consumer)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Wait for the completion of the phase of parity `parity`.  A wait that
// outlasts ~10 s of clock traps, so that a fault shows as a launch error
// and not as a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}
// One K or V tile (rows r0 .. r0 + 63 of head `head`) by TMA into its
// swizzled tile, one 64-column block a copy, completing on `bar` with the
// tile's bytes.
template <int D>
__device__ __forceinline__ void tma_tile(bf16* tile, const CUtensorMap* map, uint64_t* bar, int r0,
                                         int head) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(BK * D * 2)
               : "memory");
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(tile + cb * BK * 64)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(cb * 64), "r"(r0), "r"(head)
        : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N committed wgmma groups still pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory (stores, cp.async) made visible
// to the tensor cores' reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pin registers that an asynchronous wgmma writes, so that no access is
// moved across its wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(o)                                                                              \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 64) = (acc ? d : 0) + A B, A bf16 in registers, B in shared
// memory, K-major (TB 0) or MN-major (TB 1).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// d (64 x 128) += A B, A bf16 in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef ACC8

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64<1>(d, a, db, 1);
}

// bf16 inputs at D >= 64 land by TMA, issued by a producer warpgroup
// that hands its registers to the consumers (one thread issuing the
// copies, between barriers, measured 19 % slower); fp32 inputs and D = 32
// by cp.async from every thread
template <typename T, int D>
__host__ __device__ constexpr bool wg_tma() {
  return sizeof(T) == 2 && D >= 64;
}
template <typename T, int D>
__host__ __device__ constexpr int wg_producer_threads() {
  return wg_tma<T, D>() ? WG_THREADS : 0;
}

template <int D>
struct WgSmem {
  static constexpr int DP = D < 64 ? 64 : D;  // tile columns (D = 32 padded with zeros)
  static constexpr int QT = BQ * DP;          // bf16 elements of a q tile
  static constexpr int KT = BK * DP;          // ... of a K or V tile
  // 1024 bytes of alignment slack, q tiles [heads], K[2], V[2], for fp32
  // inputs the landing area of one K and one V tile in fp32, and the four
  // buffers' full and empty mbarriers
  __host__ __device__ static constexpr size_t bytes(int heads, bool f32_in) {
    return 1024 + (size_t)heads * QT * 2 + (size_t)4 * KT * 2 +
           (f32_in ? (size_t)2 * BK * D * 4 : 0) + 8 * 8;
  }
};

// Issue the copy of rows [r0, r0 + 64) of a row-major [*, D] input (zero
// past limit): bf16 raw into the swizzled tile, fp32 into the landing
// area (row-major), rounded into the tile later by land_fp32.
template <int D>
__device__ __forceinline__ void stage_wg(bf16* tile, float*, const bf16* src, int r0, int limit,
                                         int tid, int nthr) {
  constexpr int CPR = D / 8;
  for (int i = tid; i < BK * CPR; i += nthr) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < limit;
    cp_async16(tile + sw128<BK>(r, c * 8), ok ? src + (int64_t)(r0 + r) * D + c * 8 : src, ok);
  }
}
template <int D>
__device__ __forceinline__ void stage_wg(bf16*, float* land, const float* src, int r0, int limit,
                                         int tid, int nthr) {
  constexpr int CPR = D / 4;
  for (int i = tid; i < BK * CPR; i += nthr) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < limit;
    cp_async16(land + r * D + c * 4, ok ? src + (int64_t)(r0 + r) * D + c * 4 : src, ok);
  }
}
// A landed fp32 tile rounded to nearest bf16 into its swizzled tile.
template <int D>
__device__ __forceinline__ void land_fp32(bf16* tile, const float* land, int tid, int nthr) {
  constexpr int CPR = D / 8;
  for (int i = tid; i < BK * CPR; i += nthr) {
    const int r = i / CPR, c = i % CPR;
    const float4 a = lds4(land + r * D + c * 8), b = lds4(land + r * D + c * 8 + 4);
    *reinterpret_cast<uint4*>(tile + sw128<BK>(r, c * 8)) =
        make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
}

// Fold one score tile (the warpgroup's 64 x 64 accumulator) into the
// running state of this thread's two rows (row0 and row0 + 8) and round
// its probabilities to bf16 as the PV product's A operand.  Accumulator
// element i sits at row row0 + 8 ((i >> 1) & 1), column c0 + 8 (i >> 2) +
// 2 t + (i & 1).
template <int DP>
__device__ __forceinline__ void wg_softmax(const Params& p, float (&s)[32], bool masked, int row0,
                                           int c0, int t, float (&m)[2], float (&l)[2],
                                           float (&o)[DP / 2], uint32_t (&a)[4][4]) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (!keep(p, row0 + 8 * ((i >> 1) & 1), c0 + 8 * (i >> 2) + 2 * t + (i & 1))) s[i] = NEG_INF;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float alpha = 1.f;
    if (p.static_on) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == h) s[i] = exp2f(s[i] - p.static_max);
    } else {
      float mb = NEG_INF;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == h) mb = fmaxf(mb, s[i]);
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      const float m_new = fmaxf(m[h], mb);
      const float shift = m_new <= HALF_NEG_INF ? 0.f : m_new;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == h) {
          const float e = exp2f(s[i] - shift);
          s[i] = (masked && s[i] <= HALF_NEG_INF) ? 0.f : e;
        }
      alpha = m[h] <= HALF_NEG_INF ? 0.f : exp2f(m[h] - shift);
      m[h] = m_new;
    }
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (((i >> 1) & 1) == h) rs += s[i];
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[h] = alpha * l[h] + rs;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j + 2 * h] *= alpha;
      o[4 * j + 2 * h + 1] *= alpha;
    }
  }
  // the C layout of n8 blocks 2 kk and 2 kk + 1 is the A layout of k16
  // slice kk
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(MAX_HEADS* WG_THREADS + wg_producer_threads<T, D>(), 1)
    flash_fwd_wgmma(const __grid_constant__ Params p) {
  using W = WgSmem<D>;
  constexpr int DP = W::DP, QT = W::QT, KT = W::KT;
  constexpr bool F32IN = sizeof(T) == 4;
  constexpr bool TMA = wg_tma<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
  bf16* Ks = Qs + p.heads * QT;  // two buffers
  bf16* Vs = Ks + 2 * KT;        // two buffers
  float* FK = reinterpret_cast<float*>(Vs + 2 * KT);  // fp32 inputs: landing K, V
  float* FV = FK + BK * D;
  // TMA: buffer b of K lands on full[b] and is released on empty[b], of
  // V on full[2 + b] and empty[2 + b]
  uint64_t* full = reinterpret_cast<uint64_t*>(FK + (F32IN ? 2 * BK * D : 0));
  uint64_t* empty = full + 4;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int w = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int hp = p.N / p.heads;
  const int n_qt = (p.T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / hp);
  const int n0 = (int)(blockIdx.x % hp) * p.heads;
  const int n = n0 + wg;
  const int q0 = qt * BQ;
  const int kvn = n0 / p.group;  // the CTA's heads share one K/V head
  const T* kg = (const T*)p.k + (int64_t)kvn * p.Tk * D;
  const T* vg = (const T*)p.v + (int64_t)kvn * p.Tk * D;
  int first, end;
  walk(p, q0, BQ, first, end);
  const int nt = end - first;

  // TMA: the last warpgroup produces (its first thread issuing), the
  // others consume; fill j / 2 of a buffer (tile j) completes phase j / 2
  // of its full barrier and waits for phase j / 2 - 1 of its empty
  // barrier, every consumer thread arriving
  if constexpr (TMA) {
    const int nc = p.heads * WG_THREADS;
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        mbar_init(full + b, 1);
        mbar_init(empty + b, nc);
      }
      fence_mbar_init();
    }
    __syncthreads();
    if (tid >= p.heads * WG_THREADS) {
      setmaxnreg_dec<40>();
      if (tid == p.heads * WG_THREADS && nt > 0) {
        auto fill = [&](int v, int j) {
          const int b = 2 * v + (j & 1);
          if (j >= 2) mbar_wait(empty + b, ((j >> 1) - 1) & 1);
          tma_tile<D>((v ? Vs : Ks) + (j & 1) * KT, v ? &p.tv : &p.tk, full + b, (first + j) * BK, kvn);
        };
        // in the consumers' order: K_0, then K_{i} and V_{i-1}
        fill(0, 0);
        for (int i = 1; i <= nt; ++i) {
          if (i < nt) fill(0, i);
          fill(1, i - 1);
        }
      }
      return;
    }
    setmaxnreg_inc<232>();
  }
  // K tile kj (of the walk) into K buffer kj & 1, V tile vj into V
  // buffer vj & 1, one cp.async group a call (TMA: the producer's)
  auto issue = [&](int kj, int vj) {
    if (TMA) return;
    if (kj >= 0 && kj < nt) stage_wg<D>(Ks + (kj & 1) * KT, FK, kg, (first + kj) * BK, p.Tk, tid, nthr);
    if (vj >= 0 && vj < nt) stage_wg<D>(Vs + (vj & 1) * KT, FV, vg, (first + vj) * BK, p.Tk, tid, nthr);
    cp_async_commit();
  };
  // ... landed and visible to the tensor cores (every copy done, fp32
  // rounded into the tiles); cp.async: every thread past its reads of the
  // buffers the next issue overwrites
  auto land = [&](int kj, int vj) {
    if (TMA) {
      if (kj >= 0 && kj < nt) mbar_wait(full + (kj & 1), (kj >> 1) & 1);
      if (vj >= 0 && vj < nt) mbar_wait(full + 2 + (vj & 1), (vj >> 1) & 1);
      return;
    }
    cp_async_wait_all();
    if (F32IN) {
      __syncthreads();
      if (kj >= 0 && kj < nt) land_fp32<D>(Ks + (kj & 1) * KT, FK, tid, nthr);
      if (vj >= 0 && vj < nt) land_fp32<D>(Vs + (vj & 1) * KT, FV, tid, nthr);
    }
    fence_async_shared();
    __syncthreads();
  };
  // TMA: this thread's reads of K tile kj and V tile vj are done
  auto release = [&](int kj, int vj) {
    if (!TMA) return;
    if (kj >= 0 && kj < nt) mbar_arrive(empty + (kj & 1));
    if (vj >= 0 && vj < nt) mbar_arrive(empty + 2 + (vj & 1));
  };

  issue(0, -1);

  // pre-scaled q tile of this warpgroup's head, rounded to bf16 (a bf16
  // input meets a bf16-rounded scale); D = 32 pads columns 32..63 of
  // every tile with zeros, written once here
  {
    const T* qg = (const T*)p.q + (int64_t)n * p.T * D;
    const bool in_bf16 = sizeof(T) == 2;
    const float qscale = in_bf16 ? round_bf16(p.scale) : p.scale;
    bf16* Qw = Qs + wg * QT;
    for (int i = wtid; i < BQ * (DP / 8); i += WG_THREADS) {
      const int r = i / (DP / 8), c8 = i % (DP / 8);
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
      if (c8 < D / 8 && q0 + r < p.T) {
        load8(qg + (int64_t)(q0 + r) * D + c8 * 8, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = __fmul_rn(x[e], qscale);
      }
      *reinterpret_cast<uint4*>(Qw + sw128<BQ>(r, c8 * 8)) =
          make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                     pack_bf16(x[6], x[7]));
    }
    if (TMA) named_barrier(1 + wg, WG_THREADS);  // the warpgroup's q is written
    if constexpr (D < DP) {
      constexpr int PAD = (DP - D) / 8;  // zero chunks a row
      for (int i = tid; i < 4 * BK * PAD; i += nthr) {
        const int b = i / (BK * PAD), rem = i % (BK * PAD);
        const int r = rem / PAD, c8 = D / 8 + rem % PAD;
        *reinterpret_cast<uint4*>(Ks + b * KT + sw128<BK>(r, c8 * 8)) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // descriptors: q and K K-major (rows of 128 bytes, 8-row groups 1024
  // bytes apart, k16 step kk 32 bytes into its 64-column block); V
  // MN-major (64-column blocks BK rows apart, 8-row k groups 1024 bytes
  // apart, k16 step kk 16 rows down)
  const bf16* Qw = Qs + wg * QT;
  auto k_desc = [&](int b, int kk) {
    return gmma_desc(Ks + b * KT + (kk >> 2) * (BK * 64) + (kk & 3) * 16, 16, 1024);
  };
  auto v_desc = [&](int b, int kk) { return gmma_desc(Vs + b * KT + kk * 16 * 64, BK * 128, 1024); };
  uint32_t qa[DP / 16][4];  // q as the register operand of S
  auto scores = [&](float (&s)[32], int b) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_rs_n64<0>(s, qa[kk], k_desc(b, kk), kk > 0);
    wg_commit();
  };

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  const int row0 = q0 + 16 * w + g;

  // Step j folds tile j: S_{j+1} is issued first and runs on the tensor
  // cores through the softmax of S_j; PV_j is waited for at the step's
  // end (letting it run on into the next step, with a third V buffer,
  // measured slower).
  if (nt > 0) {
    float s[32];
    land(0, -1);
    // the warp's 16 rows of q, one ldmatrix.x4 per k16 slice (the A
    // fragment layout)
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ldsm_x4(qa[kk], Qw + sw128<BQ>(16 * w + (lane & 7) + ((lane >> 3) & 1) * 8,
                                     16 * kk + (lane >> 4) * 8));
    scores(s, 0);
    issue(1, 0);
    wg_wait<0>();
    fence_regs(s);
    release(0, -1);
    for (int j = 0; j < nt; ++j) {
      const int kt = first + j;
      float s_next[32];
      land(j + 1, j);       // K_{j+1}, V_j; S_j and PV_{j-1} read by all
      issue(j + 2, j + 1);  // over K_j and V_{j-1}
      if (j + 1 < nt) scores(s_next, (j + 1) & 1);
      uint32_t a[4][4];
      wg_softmax<DP>(p, s, tile_masked(p, q0, BQ, kt), row0, kt * BK, t, m, l, o, a);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_pv<DP>(o, a[kk], v_desc(j & 1, kk));
      wg_commit();
      wg_wait<0>();  // S_{j+1} and PV_j
      fence_regs(o);
      release(j + 1, j);
      if (j + 1 < nt) {
        fence_regs(s_next);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = s_next[i];
      }
    }
  }
  cp_async_wait_all();

  T* og = (T*)p.out + (int64_t)n * p.T * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.T) continue;
    const float denom = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(og, (int64_t)row * D + 8 * j + 2 * t, o[4 * j + 2 * h] / denom,
             o[4 * j + 2 * h + 1] / denom);
    if (t == 0) p.lse[(int64_t)n * p.T + row] = row_lse(p, m[h], l[h]);
  }
}

// ------------------------------------------------------------------------
// launches
// ------------------------------------------------------------------------
template <typename T, int D, bool MMA>
struct Kernel {
  static void (*fn())(Params) { return MMA ? &flash_fwd_wgmma<T, D> : &flash_fwd_fma<T, D>; }
  static size_t smem(int heads) {
    return MMA ? WgSmem<D>::bytes(heads, sizeof(T) == 4) : FmaSmem<D>::bytes;
  }
  static int threads(int heads) {
    return MMA ? heads * WG_THREADS + wg_producer_threads<T, D>() : FMA_THREADS;
  }
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded (no link
// against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)f;
  }
  return fn;
}

// A [heads][rows][D] bf16 tensor for TMA: boxes of 64 columns by BK rows
// of one head, written 128-byte-swizzled, rows past `rows` zero.
cudaError_t tile_map(CUtensorMap* map, const void* base, int D, int rows, int heads) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)BK, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int D, bool MMA>
cudaError_t launch(const Params& p0, cudaStream_t stream) {
  using K = Kernel<T, D, MMA>;
  Params p = p0;
  if (MMA && wg_tma<T, D>() && p.Tk > 0) {
    cudaError_t e = tile_map(&p.tk, p.k, D, p.Tk, p.Nk);
    if (e == cudaSuccess) e = tile_map(&p.tv, p.v, D, p.Tk, p.Nk);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = K::smem(p.heads);
  cudaError_t e = cudaFuncSetAttribute(K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int rows = MMA ? BQ : FMA_BQ;
  const int64_t ctas = (int64_t)(p.N / p.heads) * ((p.T + rows - 1) / rows);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  K::fn()<<<(unsigned)ctas, K::threads(p.heads), smem, stream>>>(p);
  return cudaGetLastError();
}

// registers, local (spill) bytes, static and dynamic shared memory and
// resident CTAs per SM of one kernel, at the footprint it launches with
template <typename T, int D, bool MMA>
cudaError_t info(int heads, int* out) {
  using K = Kernel<T, D, MMA>;
  const size_t smem = K::smem(heads);
  cudaError_t e = cudaFuncSetAttribute(K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, K::fn());
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, K::fn(), K::threads(heads), smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = blocks;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t pick(const Params* p, int mxu_bf16, int heads, cudaStream_t st, int* out) {
  if (out) return mxu_bf16 ? info<T, D, true>(heads, out) : info<T, D, false>(heads, out);
  return mxu_bf16 ? launch<T, D, true>(*p, st) : launch<T, D, false>(*p, st);
}

// a launch when out is null, else the kernel's footprint into out[5]
cudaError_t dispatch(const Params* p, int head_dim, int dtype, int mxu_bf16, int heads, int device,
                     void* stream, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = (cudaStream_t)stream;
#define ACCL_FLASH_CASE(DIM)                                                            \
  case DIM:                                                                             \
    return dtype == DT_F32    ? pick<float, DIM>(p, mxu_bf16, heads, st, out)           \
           : dtype == DT_BF16 ? pick<__nv_bfloat16, DIM>(p, mxu_bf16, heads, st, out) \
                              : cudaErrorInvalidValue;
  switch (head_dim) {
    ACCL_FLASH_CASE(32)
    ACCL_FLASH_CASE(64)
    ACCL_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef ACCL_FLASH_CASE
}

// q heads per CTA: 1 on the fp32 mainloop; 1 or MAX_HEADS dividing the
// GQA group on the bf16 one
bool heads_ok(int heads, int group, int mxu_bf16) {
  if (!mxu_bf16) return heads == 1;
  return (heads == 1 || heads == MAX_HEADS) && group % heads == 0;
}

Params make_params(const void* q, const void* k, const void* v, void* out, float* lse, int N,
                   int Nk, int T, int Tk, int causal, int window, int static_on, float static_max,
                   float scale, int heads) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.N = N;
  p.Nk = Nk;
  p.T = T;
  p.Tk = Tk;
  p.group = Nk > 0 ? N / Nk : 1;
  p.heads = heads;
  p.causal = causal;
  p.window = window;
  p.static_on = static_on;
  p.static_max = static_max;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

const char* accl_flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Footprint of the forward kernel that takes these dtypes (the fp32 or
// the bf16 mainloop by mxu_bf16, `heads` q heads per CTA) at its launch
// configuration: registers, local bytes, static and dynamic shared
// memory, resident CTAs per SM
int accl_flash_kernel_info(int D, int dtype, int mxu_bf16, int heads, int device, int* out) {
  if (!heads_ok(heads, heads, mxu_bf16)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(nullptr, D, dtype, mxu_bf16, heads, device, nullptr, out);
}

// The forward of every schedule (resident, resident_skew, grid: one walk,
// window 0 for the resident ones): (N / heads) * ceil(T / rows) CTAs,
// `heads` q heads of one GQA group per CTA at one q tile of 64 rows
// (bf16 mainloop) or 128 (fp32).
int accl_flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int N, int Nk,
                   int T, int Tk, int D, int dtype, int causal, int window, int mxu_bf16,
                   int static_on, float static_max, float scale, int heads, int device,
                   void* stream) {
  const Params p = make_params(q, k, v, out, lse, N, Nk, T, Tk, causal, window, static_on,
                               static_max, scale, heads);
  if (N <= 0 || Nk <= 0 || T < 0 || Tk < 0 || N % Nk != 0) return (int)cudaErrorInvalidValue;
  if (causal && T != Tk) return (int)cudaErrorInvalidValue;
  if (window < 0 || (window > 0 && !causal)) return (int)cudaErrorInvalidValue;
  if (!heads_ok(heads, p.group, mxu_bf16)) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSetDevice(device);
  return (int)dispatch(&p, D, dtype, mxu_bf16, heads, device, stream, nullptr);
}

}  // extern "C"
