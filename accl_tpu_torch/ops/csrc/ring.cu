// Ring reduce-scatter and ring all-gather over P ranks that share one card,
// each one persistent launch that walks every segment of a call.
//
// Replaces the Pallas TPU kernels ring_reduce_scatter_pallas
// (accl_tpu/ops/ring.py:274) and ring_all_gather_pallas
// (accl_tpu/ops/ring.py:151), and the Python loop over 1 MiB segments
// around them (ring_*_segmented, accl_tpu/ops/ring.py:450-528).  On the
// TPU each rank is a chip, a hop is a remote DMA into the right
// neighbour's double-buffered VMEM slot, and a call is one launch per
// segment and phase.  Here each rank is a group of thread blocks, its
// buffers are regions of the card's memory reached through a table of
// per-rank pointers, a hop is a store into the right neighbour's
// double-buffered landing slot in a scratch buffer, published with a
// release-ordered flag, and a call is one launch per phase.
//
// Work.  The wrapper describes a call as at most two parts (the whole
// segments, and a ragged last segment).  Element j of chunk c of segment
// i sits at x_off + i x_seg + c x_chunk + j in an operand and at
// o_off + i o_seg + c o_chunk + j in a result; in the ragged segment of
// an allreduce the columns with c w + j >= lim are the padding of the
// reference's padded segment, and are neither read nor written (they
// fold only padding, which the reference throws away).  Each segment's
// chunk is cut into column tiles of at most tw elements.  Block b plays
// rank b / S on stripe k = b % S, and stripe k walks tiles k, k + S,
// k + 2S, ... : per tile, the P - 1 hops of the reference's ring.
//
// Reduce-scatter, per tile: hop 0 sends x[my-1]; step q = 1 .. P-1
// waits for the hop that landed, folds x[my-1-q] + landing (or max) and
// sends it on, the last step into the result.  Output chunk c is
// x_c[c] + (x_{c-1}[c] + (... + (x_{c+2}[c] + x_{c+1}[c]))), the chain
// the Pallas kernel builds, so fp32 results match it bit for bit.
// All-gather, per tile: hop 0 places the local chunk in out[my] and
// sends it; step q places the landed chunk my-q in out[my] and, in the
// same pass, forwards it (the last step only places it).
//
// Flow control over the long schedule.  A stripe of U tiles makes
// H = U (P-1) hops, numbered across its tiles; hop h lands in slot h % 2,
// and the slots go on cycling from one tile to the next, so a stripe
// sends tile u+1's first hop while its neighbours still fold tile u.
// Every landing is read exactly once: the reduce-scatter folds it; the
// all-gather places and forwards it in one pass (the reference relays
// through its comm slot twice, forward then place, and also writes the
// local chunk into a slot).  A slot is therefore the reference's
// reduce-scatter landing slot, and its windows are rs_waits_ack and
// rs_signals_ack (accl_tpu/ops/ring.py:132-148) over a ring of H hops in
// place of P - 1, i.e. rs_*(hop, H + 1):
//   * hop h >= 2 waits until the slot's hop h-2 has been consumed
//     (ack count >= h/2): tile_waits_ack;
//   * consuming hop h frees its slot for hop h+2, signalled only if
//     h + 2 <= H - 1, so the ledger balances: tile_signals_ack.
// Tile boundaries are not special: the windows hold across them.
// tests/test_torch_ring_segments.py replays this schedule under
// adversarial delivery for P = 2..8 and 1-5 tiles.
//
// Flags: filled[P][S][2] then ack[P][S][2] (int32).  filled[r][k][slot]
// counts the hops landed in rank r's slot; ack[r][k][slot] the times
// rank r's right neighbour freed the slot rank r writes into.  No memset
// per launch: the wrapper zeroes the region once, and every block sets
// its own four flags back to 0 when it ends.  By then every hop into its
// slots has been waited for, and every ack it will get has arrived (the
// ledger balances: the last wait reads the last ack), so nothing writes
// them again in this launch, and the next launch on the stream sees 0.
//
// What bounds it on this card: bytes.  Both kernels do one add (or max,
// or nothing) per element moved.  Per rank, hop and element the
// reduce-scatter reads the operand (HBM) and a landing slot and writes
// the next slot; the all-gather reads a slot and writes the result
// (HBM) and the next slot.  The slots of one launch, P S 2 tw elements,
// are sized by the wrapper to stay inside the 50 MB L2, so the ring's
// extra traffic is L2 traffic; landing slots are read with __ldcg (L2,
// not L1): L1 is not coherent across SMs and a slot's address recurs
// every second hop.  Accesses are 16 bytes a thread wherever the part's
// pointers and strides allow it, with a scalar tail.  A step's cost is
// mostly latency (the flag, then the slot, then the release), so a pass
// loads a batch of vectors per thread before it stores any, the
// operand's first batch is loaded before the step's waits, and a hop is
// published with one release reduction (arrive_release) after the
// block's barrier.  Measured on an H100 (PERF.md section 6) and not kept:
// streaming cache hints on operands and results, several stripes per
// block taken in turn, staging through shared memory with cp.async, and
// batches of 4 or 16 vectors were each slower; polling without
// __nanosleep, or both waits of a step behind one barrier, changed
// nothing.
//
// Device-trace stamp mode (the reference's ACCL_DEVICE_TRACE rows,
// _stamp_row at accl_tpu/ops/ring.py:79-96).  ring_kernel<T, KIND, true>
// also writes one int32 row per (segment, rank, step) into stamps, laid
// out [segment][rank][step][STAMP_COLS]: rank, step, the logical phase
// stamps 3 step + {0, 1, 2}, the tx and rx peers (right and left
// neighbour), and the tx and rx bytes of one chunk of the segment (its
// chunk width w times sizeof(T), the reference's padded chunk on a ragged
// allreduce segment).  The block that plays the segment's first tile
// writes the row once its step is done.  Segments are numbered over both
// parts, the whole ones first.  ring_kernel<T, KIND, false> is the
// kernel without the mode: the flag is a template argument, so its code,
// registers and launches are those of the kernel before the mode existed.
//
// Correctness rules the design keeps:
//  * all blocks spin on flags other blocks set, so the launch is
//    cooperative: the runtime refuses a grid that cannot be co-resident
//    instead of letting it deadlock;
//  * every offset is 64-bit;
//  * a wait that exceeds SPIN_TIMEOUT_NS traps, so a broken handshake
//    fails the launch instead of hanging the card.
#include <cuda_fp16.h>
#include <string.h>

#include "ring_sync.cuh"

#define THREADS 256
#define STAMP_COLS 9

// -- element ops ----------------------------------------------------------
template <typename T> __device__ __forceinline__ T ldcg(const T* p) { return __ldcg(p); }
template <> __device__ __forceinline__ __half ldcg<__half>(const __half* p) {
  return __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

template <typename T> __device__ __forceinline__ T fold_sum(T a, T b) { return a + b; }
template <> __device__ __forceinline__ __half fold_sum<__half>(__half a, __half b) { return __hadd(a, b); }

// NaN-propagating max, as torch.maximum and jnp.maximum: a NaN operand
// comes out as it went in (the first one, if both are)
template <typename T> __device__ __forceinline__ T fold_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <> __device__ __forceinline__ __half fold_max<__half>(__half a, __half b) {
  return (__hgt(a, b) || __hisnan(a)) ? a : b;
}

// OP: 0 sum, 1 max, 2 no fold (a copy)
enum { OP_SUM = 0, OP_MAX = 1, OP_COPY = 2 };

template <typename T, int OP> __device__ __forceinline__ T fold(T a, T b) {
  return OP == OP_MAX ? fold_max<T>(a, b) : fold_sum<T>(a, b);
}

// -- 16-byte vectors --------------------------------------------------------
template <typename T> struct alignas(16) Vec { T e[16 / sizeof(T)]; };

template <typename T> __device__ __forceinline__ Vec<T> ld_vec(const T* p, bool l2) {
  const int4 r = l2 ? __ldcg(reinterpret_cast<const int4*>(p))
                    : *reinterpret_cast<const int4*>(p);
  Vec<T> v;
  memcpy(&v, &r, 16);
  return v;
}

template <typename T> __device__ __forceinline__ void st_vec(T* p, const Vec<T>& v) {
  int4 r;
  memcpy(&r, &v, 16);
  *reinterpret_cast<int4*>(p) = r;
}

// Vectors a thread keeps in flight per array: a pass loads a batch of
// BATCH vectors (of a, and of b) before it folds and stores any of them,
// so one memory latency covers them all.  With 256 threads a batch is
// 32 KB of fp32, one default slot (ops/ring.py SLOT_BYTES); the kernel's
// registers then allow two blocks per SM (__launch_bounds__ below).
#define BATCH 8

template <typename T>
__device__ __forceinline__ void load_batch(Vec<T> (&r)[BATCH], const T* p, bool l2,
                                           int64_t v0, int64_t nv) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const int64_t v = v0 + (int64_t)u * THREADS;
    if (v < nv) r[u] = ld_vec(p + v * V, l2);
  }
}

// One step over cnt columns of a tile: v = a (read through L2 when a_l2)
// folded with b (a landing slot, read through L2) unless OP is OP_COPY;
// v is stored to d0 and, when given, d1.  Before it reads b or stores
// anything it waits for wait1 >= target1 and then wait2 >= target2 (each
// may be null); when a does not depend on them (pre_a), the first batch
// of a is loaded before the waits, so its latency hides behind theirs.
// With vec every pointer is 16-byte aligned and the vector body runs up
// to the last whole vector; the tail is scalar.
template <typename T, int OP>
__device__ __forceinline__ void pass(const T* a, bool a_l2, bool pre_a, const T* b, T* d0,
                                     T* d1, int64_t cnt, bool vec, const int* wait1,
                                     int target1, const int* wait2, int target2) {
  constexpr int V = 16 / sizeof(T);
  const int64_t nv = vec ? cnt / V : 0;
  Vec<T> ra[BATCH];
  if (pre_a) load_batch(ra, a, a_l2, threadIdx.x, nv);
  if (wait1) wait_geq(wait1, target1);
  if (wait2) wait_geq(wait2, target2);
  for (int64_t v0 = threadIdx.x; v0 < nv; v0 += (int64_t)THREADS * BATCH) {
    if (!pre_a || v0 != threadIdx.x) load_batch(ra, a, a_l2, v0, nv);
    if (OP != OP_COPY) {
      Vec<T> rb[BATCH];
      load_batch(rb, b, true, v0, nv);
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) ra[u].e[e] = fold<T, OP>(ra[u].e[e], rb[u].e[e]);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int64_t v = v0 + (int64_t)u * THREADS;
      if (v < nv) {
        if (d0) st_vec(d0 + v * V, ra[u]);
        if (d1) st_vec(d1 + v * V, ra[u]);
      }
    }
  }
  for (int64_t j = nv * V + threadIdx.x; j < cnt; j += THREADS) {
    T x = a_l2 ? ldcg(a + j) : a[j];
    if (OP != OP_COPY) x = fold<T, OP>(x, ldcg(b + j));
    if (d0) d0[j] = x;
    if (d1) d1[j] = x;
  }
}

// -- geometry of one launch, the same for every rank -------------------------
struct Part {
  int64_t nseg, w, tiles_per_seg, first_tile;
  int64_t x_off, x_seg, x_chunk;  // element (i, c, j) of an operand
  int64_t o_off, o_seg, o_chunk;  // element (i, c, j) of a result
  int64_t lim;                    // column j of chunk c is real iff c w + j < lim
  int64_t vec;                    // 1: 16-byte accesses at every j % (16 / sizeof(T)) == 0
};
struct Geometry {
  Part part[2];
  int64_t tw;      // tile width in elements (slot size)
  int64_t ntiles;  // tiles of both parts
};
#define GEOMETRY_WORDS 26
static_assert(sizeof(Geometry) == GEOMETRY_WORDS * sizeof(int64_t), "geometry layout");

__device__ __forceinline__ int64_t tiles_of(const Geometry& g, int S, int k) {
  return k < g.ntiles ? (g.ntiles - 1 - k) / S + 1 : 0;
}

// ------------------------------------------------------------------------
// Step q of tile u of stripe k, rank my (q = 0: the tile's first hop).
// KIND 0: reduce-scatter by sum, 1: by max (x = operands, out = rank my's
// reduced chunk, written at chunk index my of the result geometry);
// KIND 2: all-gather (x = rank my's chunk, read at chunk index my; out =
// every chunk).
// ------------------------------------------------------------------------
template <typename T, int KIND, bool STAMP>
__device__ __forceinline__ void ring_step(const PtrTable& xs, const OutTable& outs,
                                          const Geometry& g, int P, int S, int my, int k,
                                          int64_t u, int q, T* slots, int* flags,
                                          int* stamps) {
  constexpr bool AG = (KIND == 2);
  constexpr int OP = AG ? OP_COPY : (KIND == 1 ? OP_MAX : OP_SUM);
  const int right = (my + 1) % P, left = (my + P - 1) % P;
  const int64_t H = tiles_of(g, S, k) * (P - 1);
  int* filled = flags;
  int* ack = flags + (int64_t)P * S * 2;
  auto F = [&](int r, int64_t hop) { return filled + ((int64_t)r * S + k) * 2 + (hop & 1); };
  auto A = [&](int r, int64_t hop) { return ack + ((int64_t)r * S + k) * 2 + (hop & 1); };
  auto SL = [&](int r, int64_t hop) {
    return slots + (((int64_t)r * S + k) * 2 + (hop & 1)) * g.tw;
  };
  const T* x = static_cast<const T*>(xs.p[my]);
  T* out = static_cast<T*>(outs.p[my]);

  const int64_t t = k + u * S;
  const bool second = t >= g.part[1].first_tile;
  const Part p = second ? g.part[1] : g.part[0];
  const int64_t local = t - p.first_tile;
  const int64_t i = local / p.tiles_per_seg;
  const int64_t j0 = (local % p.tiles_per_seg) * g.tw;
  const int64_t width = p.w - j0 < g.tw ? p.w - j0 : g.tw;
  const bool vec = p.vec != 0;
  auto X = [&](int c) { return x + p.x_off + i * p.x_seg + c * p.x_chunk + j0; };
  auto O = [&](int c) { return out + p.o_off + i * p.o_seg + c * p.o_chunk + j0; };
  auto cnt = [&](int c) {  // real columns of chunk c in this tile
    const int64_t end = p.lim - c * p.w - j0;
    return end < 0 ? (int64_t)0 : (end < width ? end : width);
  };
  const int64_t h0 = u * (P - 1);

  if (q == 0) {
    // hop h0: the local chunk (all-gather) or x[my-1] (reduce-scatter)
    const int* ack0 = tile_waits_ack(h0, H) ? A(my, h0) : nullptr;
    if (AG) {
      T* own = O(my);
      pass<T, OP_COPY>(X(my), false, true, nullptr, own == X(my) ? nullptr : own,
                       SL(right, h0), cnt(my), vec, ack0, (int)(h0 / 2), nullptr, 0);
    } else {
      const int c = pmod(my - 1, P);
      pass<T, OP_COPY>(X(c), false, true, nullptr, SL(right, h0), nullptr, cnt(c), vec, ack0,
                       (int)(h0 / 2), nullptr, 0);
    }
    __syncthreads();
    if (threadIdx.x == 0) arrive_release(F(right, h0));
    return;
  }
  const int64_t h = h0 + q - 1;  // the hop consumed at this step
  const bool last = (q == P - 1);
  // the landing of hop h, then (unless last) the ack that frees the
  // right neighbour's slot for hop h + 1
  const int* ackn = !last && tile_waits_ack(h + 1, H) ? A(my, h + 1) : nullptr;
  T* fwd = last ? nullptr : SL(right, h + 1);
  if (AG) {
    const int c = pmod(my - q, P);
    pass<T, OP_COPY>(SL(my, h), true, false, nullptr, O(c), fwd, cnt(c), vec, F(my, h),
                     (int)(h / 2 + 1), ackn, (int)((h + 1) / 2));
  } else {
    const int c = pmod(my - 1 - q, P);
    pass<T, OP>(X(c), false, true, SL(my, h), last ? O(my) : fwd, nullptr, cnt(c), vec,
                F(my, h), (int)(h / 2 + 1), ackn, (int)((h + 1) / 2));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!last) arrive_release(F(right, h + 1));
    // the landing of hop h is consumed: free its slot for hop h + 2
    if (tile_signals_ack(h, H)) arrive_release(A(left, h));
    if (STAMP && j0 == 0) {
      // step q - 1 of the reference's kernel is done: its stamp row
      const int64_t seg = (second ? g.part[0].nseg : 0) + i;
      const int st = q - 1;
      const int nbytes = (int)(p.w * (int64_t)sizeof(T));
      int* row = stamps + ((seg * P + my) * (P - 1) + st) * STAMP_COLS;
      row[0] = my;
      row[1] = st;
      row[2] = 3 * st;
      row[3] = 3 * st + 1;
      row[4] = 3 * st + 2;
      row[5] = right;
      row[6] = left;
      row[7] = nbytes;
      row[8] = nbytes;
    }
  }
}

// ------------------------------------------------------------------------
// The kernel: block b plays rank b / S on stripe b % S and takes its
// steps in order, tile by tile.
// ------------------------------------------------------------------------
template <typename T, int KIND, bool STAMP>
__global__ void __launch_bounds__(THREADS, 2)
ring_kernel(PtrTable xs, OutTable outs, Geometry g, int P, int S, T* slots, int* flags,
            int* stamps) {
  const int my = blockIdx.x / S, k = blockIdx.x % S;
  const int64_t U = tiles_of(g, S, k);
  for (int64_t u = 0; u < U; ++u)
    for (int q = 0; q < P; ++q)
      ring_step<T, KIND, STAMP>(xs, outs, g, P, S, my, k, u, q, slots, flags, stamps);
  if (threadIdx.x == 0 && U > 0) {
    int* ack = flags + (int64_t)P * S * 2;
    const int64_t f = ((int64_t)my * S + k) * 2;
    flags[f] = flags[f + 1] = ack[f] = ack[f + 1] = 0;
  }
}

// ------------------------------------------------------------------------
// host side: plain C interface, bound with ctypes
// ------------------------------------------------------------------------
enum { DT_F32 = 0, DT_F16 = 1, DT_F64 = 2, DT_I32 = 3, DT_I64 = 4 };

template <typename T, bool STAMP>
static void* kernel_of(int kind) {
  switch (kind) {
    case 0: return (void*)ring_kernel<T, 0, STAMP>;
    case 1: return (void*)ring_kernel<T, 1, STAMP>;
    case 2: return (void*)ring_kernel<T, 2, STAMP>;
  }
  return nullptr;
}

template <bool STAMP>
static void* kernel_for(int kind, int dtype) {
  switch (dtype) {
    case DT_F32: return kernel_of<float, STAMP>(kind);
    case DT_F16: return kernel_of<__half, STAMP>(kind);
    case DT_F64: return kernel_of<double, STAMP>(kind);
    case DT_I32: return kernel_of<int, STAMP>(kind);
    case DT_I64: return kernel_of<long long, STAMP>(kind);
  }
  return nullptr;
}

static void* kernel_for(int kind, int dtype, int stamp) {
  return stamp ? kernel_for<true>(kind, dtype) : kernel_for<false>(kind, dtype);
}

extern "C" {

const char* accl_ring_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks of one kernel (kind 0 = reduce-scatter by sum, 1 = by max, 2 =
// all-gather; stamp 1 = the device-trace instantiation) that can be
// resident on the card together, or a negative CUDA error.
int accl_ring_resident(int kind, int dtype, int stamp, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -(int)e;
  void* fn = kernel_for(kind, dtype, stamp);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  return sms * per_sm;
}

// out[0..2]: registers, local (spill) bytes and blocks per SM of one
// instantiation, as the runtime reports them.
int accl_ring_kernel_info(int kind, int dtype, int stamp, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  void* fn = kernel_for(kind, dtype, stamp);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm;
  return 0;
}

// One launch of P * S blocks over the geometry geo (GEOMETRY_WORDS
// int64 words, the layout of struct Geometry).  slots holds P * S * 2 *
// tw elements; flags P * S * 4 int32, zero on entry and on exit.  A
// non-null stamps (segments * P * (P - 1) * STAMP_COLS int32) launches
// the device-trace instantiation, which fills it.
int accl_ring_launch(int kind, int dtype, const void* const* xs, void* const* outs, int P,
                     int S, const int64_t* geo, void* slots, int* flags, int* stamps,
                     int device, void* stream) {
  if (P < 2 || P > MAXP || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  void* fn = kernel_for(kind, dtype, stamps != nullptr);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  PtrTable xt;
  OutTable ot;
  for (int r = 0; r < P; ++r) { xt.p[r] = xs[r]; ot.p[r] = outs[r]; }
  Geometry g;
  memcpy(&g, geo, sizeof(Geometry));
  void* args[] = {&xt, &ot, &g, &P, &S, &slots, &flags, &stamps};
  e = cudaLaunchCooperativeKernel(fn, dim3(P * S), dim3(THREADS), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
