// Flash-attention backward: dQ, and dK/dV, rebuilt from the forward's
// saved log-sum-exp, so the [T, Tk] probability matrix never reaches
// device memory.
//
// Replaces the Pallas TPU kernels of accl_tpu/ops/flash.py:
//  * flash_bwd_dq  <- _flash_bwd_dq_kernel  (:873, call :1086): one CTA
//    per (packed q head, q tile) walks the live k tiles of its row;
//  * flash_bwd_dkv <- _flash_bwd_dkv_kernel (:939, call :1124): one CTA
//    per (K/V head, k tile) walks every q head of its group and each of
//    their live q tiles (the Pallas kernel's nq_eff G sequential steps),
//    so grouped K/V are never expanded and no group sum runs outside.
//
// Both take the operands _flash_backward prepares on the host: q2 = q a
// log2(e) in the input dtype, the log2 lse l2 [N, T] and dvec = rowsum(dO
// out) - g_lse [N, T] (fp32).  Per tile, as _flash_bwd_p_block:
// P = exp2(q2 k^T - l2) (0 on dead rows, lse = NEG_INF), the causal and
// window mask on straddling tiles only, dS = P (dO v^T - dvec).  dq
// accumulates dS k and is scaled by a at the end; dkv accumulates
// dV += P^T dO and dK += dS^T q2, and dK is scaled by 1/log2(e).  q2, K,
// V, dO, P and dS are rounded to bfloat16 where the Pallas kernels cast
// to the MXU dtype (mxu_bf16); every product is accumulated in fp32 with
// FMAs.  Packed q row n reads K/V row n / (N / Nk).  Neither kernel uses
// atomics: each output element is summed by one thread in a fixed order,
// so results are the same run to run.  The pair set is the Pallas
// schedules' (col <= row, row - col < window, col < Tk, row < T); the
// sums run in another order than the plain version's blocks, so the two
// agree to rounding, not bitwise.
//
// The TPU kernels fold 256 x 512 blocks held in VMEM.  Here the tiles are
// 64 x 64 with 256 threads, each holding a 4 x 4 piece of a score tile and
// 4 rows x D/16 columns of each accumulator in registers, operands staged
// through shared memory with rows padded by one float.  dq holds 4 tiles
// (q2, dO, K, V; dS reuses V's buffer), 129 KB at D = 128; dkv holds K
// and V for the whole CTA plus q2, dO, P^T and dS^T tiles, 162 KB: one
// CTA per SM.
//
// What bounds it on this card: operations.  A causal backward does
// 3 T^2 D / 2 (dq) and 2 T^2 D (dkv) multiply-adds per head against
// ~6 T D element reads and writes: far above the ~20 operations per byte
// that fp32 FMA needs on an H100.  Like the forward kernels, these feed
// their FMAs from shared memory (two loads per 2-4 FMAs).  Under a causal
// mask the work of a dq CTA grows with its q tile and that of a dkv CTA
// shrinks with its k tile, so the heavy tiles are launched first.
// Tensor cores (mma.sync / wgmma on bf16), TMA staging and a fused
// single-kernel backward are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // K/V rows per tile
constexpr int THREADS = 256;  // ty = tid / 16 owns tile rows ty + 16 i; tx = tid % 16 columns tx + 16 j
constexpr int RI = 4;         // tile rows per thread
constexpr int CJ = 4;         // tile columns per thread
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -5e29f;
constexpr float INV_LOG2E = 0.6931471805599453f;  // 1 / log2(e)

enum { DT_F32 = 0, DT_BF16 = 1 };

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
  int N, Nk, T, Tk, group;
  int causal, window;  // window 0 = none
  int mxu_bf16;
  float scale_a;
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

// Stage `rows` rows of a row-major [*, D] operand, from row r0, into shared
// memory with row stride D + 1: zero past `limit`, rounded to bf16 where the
// Pallas kernel casts to the MXU dtype.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int rows, int limit,
                                      bool rnd) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    float x = 0.f;
    if (r0 + r < limit) {
      x = load(src, (int64_t)(r0 + r) * D + d);
      if (rnd) x = round_bf16(x);
    }
    dst[r * (D + 1) + d] = x;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two staged tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, float (&s)[RI][CJ]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// The pair (q row, k col) of a masked tile counts: inside K, on or below
// the diagonal, inside the window.  Rows past T carry l2 = NEG_INF.
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

// P = exp2(s - l2), zero on dead rows and on pairs the mask drops.
__device__ __forceinline__ float prob(const Params& p, float s, float l2, bool masked, int row,
                                      int col) {
  const float e = l2 <= HALF_NEG_INF ? 0.f : exp2f(s - l2);
  return (masked && !keep(p, row, col)) ? 0.f : e;
}

template <int D>
struct DqSmem {
  static constexpr int QS = BQ * (D + 1);
  static constexpr int KS = BK * (D + 1);
  static constexpr int SS = BQ * (BK + 1);
  static constexpr int VS = KS > SS ? KS : SS;  // the V tile, then the dS tile
  static constexpr size_t bytes = (size_t)(2 * QS + KS + VS) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + DqSmem<D>::QS;
  float* Ks = Os + DqSmem<D>::QS;
  float* Vs = Ks + DqSmem<D>::KS;
  float* Ss = Vs;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_qt = (p.T + BQ - 1) / BQ;
  // heads inner, q tiles outer and last first: under a causal mask the
  // last q tiles see the most k tiles
  const int qt = n_qt - 1 - (int)(blockIdx.x / p.N);
  const int n = (int)(blockIdx.x % p.N);
  const int q0 = qt * BQ;
  const int kvn = n / p.group;
  const T* kg = (const T*)p.k + (int64_t)kvn * p.Tk * D;
  const T* vg = (const T*)p.v + (int64_t)kvn * p.Tk * D;
  const bool rnd = p.mxu_bf16 != 0;
  stage<T, D>(Qs, (const T*)p.q2 + (int64_t)n * p.T * D, q0, BQ, p.T, rnd);
  stage<T, D>(Os, (const T*)p.dout + (int64_t)n * p.T * D, q0, BQ, p.T, rnd);

  float l2r[RI], dvr[RI], acc[RI][D / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    l2r[i] = row < p.T ? p.l2[(int64_t)n * p.T + row] : NEG_INF;
    dvr[i] = row < p.T ? p.dvec[(int64_t)n * p.T + row] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int nkt = (p.Tk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, p.T) - 1;
  // the live k tiles: from the window's first visible column to the
  // diagonal (_window_first_block, _grid_live_masked)
  const int first = p.window > 0 ? max(q0 - (p.window - 1), 0) / BK : 0;
  const int last = p.causal ? min(q_last / BK, nkt - 1) : nkt - 1;
  for (int kt = first; kt <= last; ++kt) {
    const int c0 = kt * BK;
    const bool masked = needs_mask(p, q0, q_last, c0);
    __syncthreads();  // the previous tile's reads of Ks and Ss are done
    stage<T, D>(Ks, kg, c0, BK, p.Tk, rnd);
    stage<T, D>(Vs, vg, c0, BK, p.Tk, rnd);
    __syncthreads();
    float s[RI][CJ], dp[RI][CJ];
    tile_dot<D>(Qs, Ks, s);
    tile_dot<D>(Os, Vs, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pr = prob(p, s[i][j], l2r[i], masked, q0 + ty + 16 * i, c0 + tx + 16 * j);
        s[i][j] = pr * (dp[i][j] - dvr[i]);  // dS
      }
    __syncthreads();  // every read of Vs is done before dS overwrites it
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        Ss[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = rnd ? round_bf16(s[i][j]) : s[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RI], kv[D / 16];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = Ss[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) kv[j] = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  T* dqg = (T*)p.dq + (int64_t)n * p.T * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.T) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      store(dqg, (int64_t)row * D + tx + 16 * j, __fmul_rn(acc[i][j], p.scale_a));
  }
}

template <int D>
struct DkvSmem {
  static constexpr int KS = BK * (D + 1);
  static constexpr int QS = BQ * (D + 1);
  static constexpr int PS = BK * (BQ + 1);  // P^T and dS^T: k rows by q columns
  static constexpr size_t bytes = (size_t)(2 * KS + 2 * QS + 2 * PS + 2 * BQ) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv(Params p) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + DkvSmem<D>::KS;
  float* Qs = Vs + DkvSmem<D>::KS;
  float* Os = Qs + DkvSmem<D>::QS;
  float* Ps = Os + DkvSmem<D>::QS;
  float* Ss = Ps + DkvSmem<D>::PS;
  float* Ls = Ss + DkvSmem<D>::PS;  // l2 of the q tile's rows
  float* Dv = Ls + BQ;              // dvec of the q tile's rows
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // K/V heads inner, k tiles outer and first first: under a causal mask
  // the first k tiles are seen by the most q tiles
  const int kt = (int)(blockIdx.x / p.Nk);
  const int kvn = (int)(blockIdx.x % p.Nk);
  const int k0 = kt * BK;
  const bool rnd = p.mxu_bf16 != 0;
  stage<T, D>(Ks, (const T*)p.k + (int64_t)kvn * p.Tk * D, k0, BK, p.Tk, rnd);
  stage<T, D>(Vs, (const T*)p.v + (int64_t)kvn * p.Tk * D, k0, BK, p.Tk, rnd);

  float dka[RI][D / 16], dva[RI][D / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dka[i][j] = 0.f;
      dva[i][j] = 0.f;
    }

  const int n_qt = (p.T + BQ - 1) / BQ;
  const int k_last = min(k0 + BK, p.Tk) - 1;
  // the live q tiles: from the diagonal to the last row whose window
  // still reaches this k tile
  const int first = p.causal ? k0 / BQ : 0;
  const int last = p.window > 0 ? min(n_qt - 1, (k_last + p.window - 1) / BQ) : n_qt - 1;
  for (int g = 0; g < p.group; ++g) {
    const int n = kvn * p.group + g;
    const T* qg = (const T*)p.q2 + (int64_t)n * p.T * D;
    const T* og = (const T*)p.dout + (int64_t)n * p.T * D;
    for (int qt = first; qt <= last; ++qt) {
      const int q0 = qt * BQ;
      const bool masked = needs_mask(p, q0, min(q0 + BQ, p.T) - 1, k0);
      __syncthreads();  // the previous step's reads of Qs, Os, Ps, Ss, Ls and Dv are done
      stage<T, D>(Qs, qg, q0, BQ, p.T, rnd);
      stage<T, D>(Os, og, q0, BQ, p.T, rnd);
      for (int r = tid; r < BQ; r += THREADS) {
        const int row = q0 + r;
        Ls[r] = row < p.T ? p.l2[(int64_t)n * p.T + row] : NEG_INF;
        Dv[r] = row < p.T ? p.dvec[(int64_t)n * p.T + row] : 0.f;
      }
      __syncthreads();
      // transposed tiles: rows are this CTA's k rows, columns the q rows
      float st[RI][CJ], dpt[RI][CJ];
      tile_dot<D>(Ks, Qs, st);
      tile_dot<D>(Vs, Os, dpt);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int qr = tx + 16 * j;
          const float pr = prob(p, st[i][j], Ls[qr], masked, q0 + qr, k0 + ty + 16 * i);
          const float ds = pr * (dpt[i][j] - Dv[qr]);
          Ps[(ty + 16 * i) * (BQ + 1) + qr] = rnd ? round_bf16(pr) : pr;
          Ss[(ty + 16 * i) * (BQ + 1) + qr] = rnd ? round_bf16(ds) : ds;
        }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[RI], sv[RI], ov[D / 16], qv[D / 16];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = Ps[(ty + 16 * i) * (BQ + 1) + r];
          sv[i] = Ss[(ty + 16 * i) * (BQ + 1) + r];
        }
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          ov[j] = Os[r * (D + 1) + tx + 16 * j];
          qv[j] = Qs[r * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            dva[i][j] = fmaf(pv[i], ov[j], dva[i][j]);
            dka[i][j] = fmaf(sv[i], qv[j], dka[i][j]);
          }
      }
    }
  }

  T* dkg = (T*)p.dk + (int64_t)kvn * p.Tk * D;
  T* dvg = (T*)p.dv + (int64_t)kvn * p.Tk * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      store(dkg, (int64_t)row * D + tx + 16 * j, __fmul_rn(dka[i][j], INV_LOG2E));
      store(dvg, (int64_t)row * D + tx + 16 * j, dva[i][j]);
    }
  }
}

int64_t ctas(int which, int N, int Nk, int T, int Tk) {
  return which == 0 ? (int64_t)N * ((T + BQ - 1) / BQ) : (int64_t)Nk * ((Tk + BK - 1) / BK);
}

template <typename T, int D, bool DQ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  void (*kern)(Params) = DQ ? &flash_bwd_dq<T, D> : &flash_bwd_dkv<T, D>;
  const size_t smem = DQ ? DqSmem<D>::bytes : DkvSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int64_t n = ctas(DQ ? 0 : 1, p.N, p.Nk, p.T, p.Tk);
  if (n > 0x7fffffff) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  kern<<<(unsigned)n, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool DQ>
int dispatch(const Params& p, int head_dim, int dtype, int device, void* stream) {
  if (p.N <= 0 || p.Nk <= 0 || p.T < 0 || p.Tk < 0 || p.N % p.Nk != 0)
    return (int)cudaErrorInvalidValue;
  if (p.causal && p.T != p.Tk) return (int)cudaErrorInvalidValue;
  if (p.window < 0 || (p.window > 0 && !p.causal)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
#define ACCL_FLASH_BWD_CASE(DIM)                                                          \
  case DIM:                                                                               \
    e = dtype == DT_F32    ? launch<float, DIM, DQ>(p, st)                                \
        : dtype == DT_BF16 ? launch<__nv_bfloat16, DIM, DQ>(p, st)                        \
                           : cudaErrorInvalidValue;                                       \
    break;
  switch (head_dim) {
    ACCL_FLASH_BWD_CASE(32)
    ACCL_FLASH_BWD_CASE(64)
    ACCL_FLASH_BWD_CASE(128)
    default:
      e = cudaErrorInvalidValue;
  }
#undef ACCL_FLASH_BWD_CASE
  return (int)e;
}

Params make_params(const void* q2, const void* k, const void* v, const void* dout,
                   const float* l2, const float* dvec, int N, int Nk, int T, int Tk, int causal,
                   int window, int mxu_bf16) {
  Params p;
  p.q2 = q2;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.l2 = l2;
  p.dvec = dvec;
  p.dq = nullptr;
  p.dk = nullptr;
  p.dv = nullptr;
  p.N = N;
  p.Nk = Nk;
  p.T = T;
  p.Tk = Tk;
  p.group = Nk > 0 ? N / Nk : 1;
  p.causal = causal;
  p.window = window;
  p.mxu_bf16 = mxu_bf16;
  p.scale_a = 1.f;
  return p;
}

}  // namespace

extern "C" {

const char* accl_flash_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// CTAs of one launch: which = 0 for dq (one per packed q head and q tile),
// 1 for dkv (one per K/V head and k tile)
long long accl_flash_bwd_ctas(int which, int N, int Nk, int T, int Tk) {
  return (long long)ctas(which, N, Nk, T, Tk);
}

int accl_flash_bwd_dq(const void* q2, const void* k, const void* v, const void* dout,
                      const float* l2, const float* dvec, void* dq, int N, int Nk, int T, int Tk,
                      int D, int dtype, int causal, int window, int mxu_bf16, float scale_a,
                      int device, void* stream) {
  Params p = make_params(q2, k, v, dout, l2, dvec, N, Nk, T, Tk, causal, window, mxu_bf16);
  p.dq = dq;
  p.scale_a = scale_a;
  return dispatch<true>(p, D, dtype, device, stream);
}

int accl_flash_bwd_dkv(const void* q2, const void* k, const void* v, const void* dout,
                       const float* l2, const float* dvec, void* dk, void* dv, int N, int Nk,
                       int T, int Tk, int D, int dtype, int causal, int window, int mxu_bf16,
                       int device, void* stream) {
  Params p = make_params(q2, k, v, dout, l2, dvec, N, Nk, T, Tk, causal, window, mxu_bf16);
  p.dk = dk;
  p.dv = dv;
  return dispatch<false>(p, D, dtype, device, stream);
}

}  // extern "C"
