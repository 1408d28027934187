// Flash-attention forward: tiled QK^T -> online softmax -> PV, with the
// running (max, denominator) carried across K tiles, so the [T, Tk] score
// matrix never reaches device memory.  Writes out [N, T, D] and the
// log-sum-exp [N, T] (fp32, natural-log units).
//
// Replaces the Pallas TPU kernels of accl_tpu/ops/flash.py:
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
//    computed before the current tile's softmax and PV.  It shares the
//    stage, score and consume device functions with the resident mode and
//    folds in the same order, so its out and lse equal flash_fwd_resident's
//    bit for bit, as the Pallas pair are.  The lookahead score tile (64 x
//    64 fp32, 16 KB a CTA) lives in registers, 16 per thread: another
//    16 KB of shared memory would drop the resident mode's two CTAs per SM
//    to one, and the K tile's buffer is free again once it is scored.
//
// Both share the fold of _softmax_fold / _fold_consume / _finalize
// (:36-152), in the same log2 domain: q arrives pre-scaled by
// log2(e)/sqrt(D), probabilities are exp2(s - m), the shift is clamped to
// 0 while a row has seen only masked cells, masked p are zeroed, and the
// lse is m ln2 + ln(max(l, 1e-38)) (NEG_INF = -1e30 for dead rows).
// static_max pins the shift (no running max).  The q product, K, V and p
// are rounded to bfloat16 where the Pallas fold casts them to the MXU
// dtype (mxu_bf16); every product is accumulated in fp32 with FMAs.
// Packed q row n reads K/V row n / (N / Nk): grouped-query attention
// without expansion.
//
// The TPU kernel's blocks (256 x 512 by default) hold whole K/V rows or
// large tiles in VMEM.  A CTA here has at most 227 KB of shared memory, so
// the tiles are the kernel's own: one CTA per (packed head, 64-row q
// tile), 64-row K/V tiles staged through shared memory, 256 threads, each
// holding 4 rows x 4 columns of a score tile and 4 rows x D/16 columns of
// the output accumulator in registers.  Which cells count is the same as
// in the Pallas schedules (both reduce to col <= row, row - col < window
// and col < Tk); the running max is rescaled at 64-column steps instead of
// the resolver's block_k, so the result agrees with the plain version to
// rounding, not bitwise.
//
// What bounds it on this card: operations.  A causal forward does
// 2 T^2 D multiply-adds per head against 4 T D element reads and writes:
// at T = 4096, D = 128 about 1000 operations per byte, far above the
// ~20 that fp32 FMA needs on an H100.  This first kernel feeds its FMAs
// from shared memory (two loads per 2-4 FMAs), so shared-memory bandwidth
// sets its rate; tensor cores (wgmma on bf16), TMA staging and a
// producer/consumer split are later work.  q tiles are launched last
// first: under a causal mask their work grows with the tile index.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // K/V rows per tile
constexpr int THREADS = 256;  // ty = tid / 16 owns rows ty + 16 i; tx = tid % 16 columns tx + 16 j
constexpr int RI = BQ / 16;   // rows per thread
constexpr int CJ = BK / 16;   // score columns per thread
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -5e29f;
constexpr float LN2 = 0.6931471805599453f;

enum { DT_F32 = 0, DT_BF16 = 1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int N, Nk, T, Tk, group;
  int causal, window;  // window 0 = none
  int mxu_bf16, static_on;
  float static_max, scale;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

template <int D>
struct Smem {
  static constexpr int QS = BQ * (D + 1);  // q tile, rows padded by one float
  static constexpr int KS = BK * (D + 1);  // K tile; the p tile reuses it
  static constexpr int PS = BQ * (BK + 1);
  static constexpr int KP = KS > PS ? KS : PS;
  static constexpr int VS = BK * D;
  static constexpr size_t bytes = (size_t)(QS + KP + VS) * sizeof(float);
};

// Stage K tile kt and V tile vt into shared memory (a negative index
// stages nothing), rounded to bfloat16 under mxu_bf16; rows past Tk are
// zero.  Call between two barriers.
template <typename T, int D>
__device__ __forceinline__ void stage_tiles(const Params& p, const T* kg, const T* vg, float* Ks,
                                            float* Vs, int kt, int vt) {
  for (int i = threadIdx.x; i < BK * D; i += THREADS) {
    const int c = i / D, d = i - c * D;
    if (kt >= 0) {
      float kx = 0.f;
      if (kt * BK + c < p.Tk) {
        kx = load(kg, (int64_t)(kt * BK + c) * D + d);
        if (p.mxu_bf16) kx = round_bf16(kx);
      }
      Ks[c * (D + 1) + d] = kx;
    }
    if (vt >= 0) {
      float vx = 0.f;
      if (vt * BK + c < p.Tk) {
        vx = load(vg, (int64_t)(vt * BK + c) * D + d);
        if (p.mxu_bf16) vx = round_bf16(vx);
      }
      Vs[c * D + d] = vx;
    }
  }
}

// This thread's 4 x 4 cells of the score tile q K^T of the staged K tile.
template <int D>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks, float (&s)[RI][CJ]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RI], kv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

// Fold the scores s of K/V tile kt, with V tile kt staged in Vs, into the
// running state of this thread's rows.  masked: apply the per-cell test
// (diagonal, window edge or the ragged end of K).  The probabilities are
// written over Ks, after a barrier that ends every read of it.
template <int D>
__device__ __forceinline__ void consume_tile(const Params& p, float* Ks, const float* Vs, int q0,
                                             int kt, bool masked, float (&s)[RI][CJ],
                                             float (&m)[RI], float (&l)[RI],
                                             float (&acc)[RI][D / 16]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c0 = kt * BK;
  if (masked) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = c0 + tx + 16 * j;
        bool keep = col < p.Tk;
        if (p.causal) keep = keep && row >= col;
        if (p.window > 0) keep = keep && row - col < p.window;
        if (!keep) s[i][j] = NEG_INF;
      }
    }
  }
  __syncthreads();  // every read of Ks is done before p overwrites it

  float* Ps = Ks;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float pr[CJ];
    float alpha = 1.f;
    if (p.static_on) {
      // pinned shift: exp2(NEG_INF - pin) flushes to 0, no clamp needed
#pragma unroll
      for (int j = 0; j < CJ; ++j) pr[j] = exp2f(s[i][j] - p.static_max);
    } else {
      float mb = s[i][0];
#pragma unroll
      for (int j = 1; j < CJ; ++j) mb = fmaxf(mb, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off, 16));
      const float m_new = fmaxf(m[i], mb);
      // a row that has seen only masked cells keeps m at NEG_INF; clamp
      // the shift so exp2(s - shift) stays 0, not exp2(+big)
      const float shift = m_new <= HALF_NEG_INF ? 0.f : m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float e = exp2f(s[i][j] - shift);
        pr[j] = (masked && s[i][j] <= HALF_NEG_INF) ? 0.f : e;
      }
      alpha = m[i] <= HALF_NEG_INF ? 0.f : exp2f(m[i] - shift);
      m[i] = m_new;
    }
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) rs += pr[j];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
    l[i] = alpha * l[i] + rs;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p.mxu_bf16 ? round_bf16(pr[j]) : pr[j];
  }
  __syncthreads();

#pragma unroll 4
  for (int c = 0; c < BK; ++c) {
    float pv[RI], vv[D / 16];
#pragma unroll
    for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}

// One K/V tile folded into the running state of this thread's rows: stage
// it, score it, consume it.
template <typename T, int D>
__device__ __forceinline__ void fold_tile(const Params& p, const T* kg, const T* vg,
                                          float* Qs, float* Ks, float* Vs, int q0, int kt,
                                          bool masked, float (&m)[RI], float (&l)[RI],
                                          float (&acc)[RI][D / 16]) {
  __syncthreads();  // the previous tile's reads of Ks (as p) and Vs are done
  stage_tiles<T, D>(p, kg, vg, Ks, Vs, kt, kt);
  __syncthreads();
  float s[RI][CJ];
  score_tile<D>(Qs, Ks, s);
  consume_tile<D>(p, Ks, Vs, q0, kt, masked, s, m, l, acc);
}

enum { MODE_RESIDENT = 0, MODE_GRID = 1, MODE_SKEW = 2 };

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<D>::QS;
  float* Vs = Ks + Smem<D>::KP;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_qt = (p.T + BQ - 1) / BQ;
  // heads inner, q tiles outer and last first: the heaviest causal tiles
  // are dispatched first
  const int qt = n_qt - 1 - (int)(blockIdx.x / p.N);
  const int n = (int)(blockIdx.x % p.N);
  const int q0 = qt * BQ;
  const int kvn = n / p.group;
  const T* qg = (const T*)p.q + (int64_t)n * p.T * D;
  const T* kg = (const T*)p.k + (int64_t)kvn * p.Tk * D;
  const T* vg = (const T*)p.v + (int64_t)kvn * p.Tk * D;

  // pre-scaled q tile: the product is taken in the input dtype (a bf16
  // input meets a bf16-rounded scale, as JAX's weakly typed constant),
  // then rounded to the MXU dtype
  const bool in_bf16 = sizeof(T) == 2;
  const float qscale = in_bf16 ? round_bf16(p.scale) : p.scale;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    float x = 0.f;
    if (q0 + r < p.T) {
      x = __fmul_rn(load(qg, (int64_t)(q0 + r) * D + d), qscale);
      if (in_bf16 || p.mxu_bf16) x = round_bf16(x);
    }
    Qs[r * (D + 1) + d] = x;
  }

  float m[RI], l[RI], acc[RI][D / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int nkt = (p.Tk + BK - 1) / BK;
  const int q_last = q0 + BQ - 1;  // the tile's last row (rows past T are never stored)
  if (MODE == MODE_GRID) {
    // _grid_live_masked over this q tile's cells, the k range bounded by
    // the window (_window_first_block)
    const int first = p.window > 0 ? max(q0 - (p.window - 1), 0) / BK : 0;
    for (int kt = first; kt < nkt; ++kt) {
      const int c0 = kt * BK, c_last = c0 + BK - 1;
      bool live = true, diag = false;
      if (p.causal) {
        live = c0 <= q_last;
        diag = c_last > q0 && live;
        if (p.window > 0) {
          live = live && c_last > q0 - p.window;
          const bool wedge = c0 < q0 + BQ - p.window;
          diag = (diag || wedge) && live;
        }
      }
      if (!live) {
        if (c0 > q_last) break;  // every later tile is in the future
        continue;
      }
      fold_tile<T, D>(p, kg, vg, Qs, Ks, Vs, q0, kt, diag || c_last >= p.Tk, m, l, acc);
    }
  } else {
    // _causal_block_bounds: [0, n_past) strictly past, [n_past, n_live)
    // straddle the diagonal, the rest is future
    const int n_past = p.causal ? q0 / BK : nkt;
    const int n_live = p.causal ? min((q0 + BQ + BK - 1) / BK, nkt) : nkt;
    if (MODE == MODE_RESIDENT) {
      for (int kt = 0; kt < n_live; ++kt)
        fold_tile<T, D>(p, kg, vg, Qs, Ks, Vs, q0, kt, kt >= n_past || kt * BK + BK > p.Tk,
                        m, l, acc);
    } else {
      // the skew (_flash_kernel_resident_skew): tile kt + 1's scores are
      // computed before tile kt is consumed, and carried in registers to
      // the next step; the same device functions in the same fold order,
      // so out and lse equal the resident mode's bit for bit.  The TPU
      // kernel's discarded lookahead past the last tile is not computed.
      float s_cur[RI][CJ], s_nxt[RI][CJ];
      if (n_live > 0) {
        __syncthreads();
        stage_tiles<T, D>(p, kg, vg, Ks, Vs, 0, -1);
        __syncthreads();
        score_tile<D>(Qs, Ks, s_cur);
      }
      for (int kt = 0; kt < n_live; ++kt) {
        const bool ahead = kt + 1 < n_live;
        __syncthreads();  // the scores and the previous fold are done with Ks and Vs
        stage_tiles<T, D>(p, kg, vg, Ks, Vs, ahead ? kt + 1 : -1, kt);
        __syncthreads();
        if (ahead) score_tile<D>(Qs, Ks, s_nxt);
        consume_tile<D>(p, Ks, Vs, q0, kt, kt >= n_past || kt * BK + BK > p.Tk, s_cur, m, l,
                        acc);
        if (ahead) {
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) s_cur[i][j] = s_nxt[i][j];
        }
      }
    }
  }

  T* og = (T*)p.out + (int64_t)n * p.T * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.T) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      store(og, (int64_t)row * D + tx + 16 * j, acc[i][j] / denom);
    if (tx == 0) {
      // static_max never moved m: the pin for live rows, NEG_INF for dead
      const float mf = p.static_on ? (l[i] == 0.f ? NEG_INF : p.static_max) : m[i];
      p.lse[(int64_t)n * p.T + row] =
          mf <= HALF_NEG_INF ? NEG_INF : __fadd_rn(__fmul_rn(mf, LN2), logf(fmaxf(l[i], 1e-38f)));
    }
  }
}

template <typename T, int D, int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const auto kern = flash_fwd<T, D, MODE>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int64_t ctas = (int64_t)p.N * ((p.T + BQ - 1) / BQ);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<(unsigned)ctas, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const Params& p, int head_dim, int dtype, int device, void* stream) {
  if (p.N <= 0 || p.Nk <= 0 || p.T < 0 || p.Tk < 0 || p.N % p.Nk != 0)
    return (int)cudaErrorInvalidValue;
  if (p.causal && p.T != p.Tk) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (p.T == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
#define ACCL_FLASH_CASE(DIM)                                                              \
  case DIM:                                                                               \
    e = dtype == DT_F32    ? launch<float, DIM, MODE>(p, st)                              \
        : dtype == DT_BF16 ? launch<__nv_bfloat16, DIM, MODE>(p, st)                      \
                           : cudaErrorInvalidValue;                                       \
    break;
  switch (head_dim) {
    ACCL_FLASH_CASE(32)
    ACCL_FLASH_CASE(64)
    ACCL_FLASH_CASE(128)
    default:
      e = cudaErrorInvalidValue;
  }
#undef ACCL_FLASH_CASE
  return (int)e;
}

Params make_params(const void* q, const void* k, const void* v, void* out, float* lse, int N,
                   int Nk, int T, int Tk, int causal, int window, int mxu_bf16, int static_on,
                   float static_max, float scale) {
  Params p;
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
  p.causal = causal;
  p.window = window;
  p.mxu_bf16 = mxu_bf16;
  p.static_on = static_on;
  p.static_max = static_max;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

const char* accl_flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// CTAs one launch over N packed heads of T rows uses: one per (head, q tile)
long long accl_flash_ctas(int N, int T) { return (long long)N * ((T + BQ - 1) / BQ); }

int accl_flash_fwd_resident(const void* q, const void* k, const void* v, void* out, float* lse,
                            int N, int Nk, int T, int Tk, int D, int dtype, int causal,
                            int mxu_bf16, int static_on, float static_max, float scale,
                            int device, void* stream) {
  const Params p = make_params(q, k, v, out, lse, N, Nk, T, Tk, causal, 0, mxu_bf16, static_on,
                               static_max, scale);
  return dispatch<MODE_RESIDENT>(p, D, dtype, device, stream);
}

int accl_flash_fwd_resident_skew(const void* q, const void* k, const void* v, void* out,
                                 float* lse, int N, int Nk, int T, int Tk, int D, int dtype,
                                 int causal, int mxu_bf16, int static_on, float static_max,
                                 float scale, int device, void* stream) {
  if (static_on) return (int)cudaErrorInvalidValue;  // the resolver refuses static_max
  const Params p = make_params(q, k, v, out, lse, N, Nk, T, Tk, causal, 0, mxu_bf16, 0, 0.f,
                               scale);
  return dispatch<MODE_SKEW>(p, D, dtype, device, stream);
}

int accl_flash_fwd_grid(const void* q, const void* k, const void* v, void* out, float* lse,
                        int N, int Nk, int T, int Tk, int D, int dtype, int causal, int window,
                        int mxu_bf16, int static_on, float static_max, float scale, int device,
                        void* stream) {
  if (window < 0 || (window > 0 && !causal)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, out, lse, N, Nk, T, Tk, causal, window, mxu_bf16,
                               static_on, static_max, scale);
  return dispatch<MODE_GRID>(p, D, dtype, device, stream);
}

}  // extern "C"
