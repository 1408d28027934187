// Ring reduce-scatter and ring all-gather over P ranks, each one
// persistent launch per card that walks every segment of a call: one
// launch when the ranks share one card, one per card in the cross-card
// mode (below).
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
// Self-ring mode (the reference's ring_size argument,
// accl_tpu/ops/ring.py:151-175 and :274-294).  On a one-member axis the
// Pallas kernels run a ring of V virtual ranks on one chip, each hop a
// DMA from the chip to itself through the same slots, semaphores and ACK
// windows.  Here a launch takes P ranks and a ring length V; the mode is
// P = 1: one rank, its own right and left neighbour, takes the V - 1 hops
// of each tile through its own landing slots and flags, each hop
// published and waited for as between two ranks.  Chunk indices run
// mod V and neighbours mod P, so at P = V the kernel is the one above.
// With my = 0 the reduce-scatter folds x[0] + (x[1] + (... + x[V-1])),
// the Pallas body's order, and the all-gather writes its operand into
// all V rows of the result.  The stamp rows are the reference's: V - 1
// per segment, rank and both peers 0.
//
// Cross-card mode (ring_kernel_cross; the TPU kernels' own setting, each
// rank a chip and each hop a remote DMA into its neighbour,
// accl_tpu/ops/ring.py:218-233).  The ranks sit on several cards joined
// by peer access.  Each card gets one launch holding its ranks' blocks
// (any ranks: block b plays the rank its table names), all with the same
// geometry and S.  Rank r's landing slots and flags are its own buffers
// on its own card, reached through per-rank tables, so a hop is a store
// over NVLink into the right neighbour's slot, published by a .sys
// release reduction into its filled flag, and every wait is a .sys
// acquire on the waiting rank's own card.  The fold chain, the tiles and
// the ACK windows are the one-launch path's, so the results are bitwise
// those of one launch; the entry handshake at ring_kernel_cross keeps
// launches on different cards from overlapping on a rank's slots and
// flags.  With every rank on one card it is the per-rank-table form of
// one launch, which a one-card test can hold against the one-launch form.
//
// Correctness rules the design keeps:
//  * all blocks spin on flags other blocks set, so a launch is
//    cooperative: the runtime refuses a grid that cannot be co-resident
//    instead of letting it deadlock (across cards each card's blocks are
//    its own launch's, co-resident there);
//  * every offset is 64-bit;
//  * a wait that exceeds SPIN_TIMEOUT_NS traps, so a broken handshake
//    fails the launch instead of hanging the card.  Across cards the
//    wrapper joins the cards' streams before the launches and the blocks
//    wait for the host's gate, so neither a neighbour's earlier work nor
//    a neighbour launch that failed counts against the limit; work on
//    other streams of a card is not joined, and a cooperative launch
//    that waits for it to leave room does count.
#include <cuda_fp16.h>
#include <string.h>

#include "current_device.cuh"
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
template <typename T, int OP, int SCOPE>
__device__ __forceinline__ void pass(const T* a, bool a_l2, bool pre_a, const T* b, T* d0,
                                     T* d1, int64_t cnt, bool vec, const int* wait1,
                                     int target1, const int* wait2, int target2) {
  constexpr int V = 16 / sizeof(T);
  const int64_t nv = vec ? cnt / V : 0;
  Vec<T> ra[BATCH];
  if (pre_a) load_batch(ra, a, a_l2, threadIdx.x, nv);
  if (wait1) wait_geq<SCOPE>(wait1, target1);
  if (wait2) wait_geq<SCOPE>(wait2, target2);
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

// -- where the cross-card mode's landing slots and flags live ---------------
// The cross-card mode's per-rank tables: rank r's slots[S][2][tw] and
// flags live on rank r's card, the card that reads them.  Rank r's flags
// are HS_WORDS head words, then filled[S][2], then ack[S][2].  The head:
// the handshake counts (the blocks of its left, then of its right
// neighbour that have ended a launch); used in the flags of a launch's
// first rank only, that card's copy of the host's gate (the launches its
// block 0 saw opened, and whether it saw one given up); the blocks of
// rank r that ended every earlier launch (HS_DONE) and that have ended
// the launch under way (HS_ENDED).  HS_WORDS and the words' offsets are
// in ring_sync.cuh, shared with fused.cu's cross-card mode.
struct RankTables {
  void* slots[MAXP];
  int* flags[MAXP];
  int rank[MAXP];  // the rank that block b of this launch plays: rank[b / S]
  // The host's gate of these tables, two words of mapped host memory:
  // gate[0] counts the eager launches the host has opened (every card's
  // launch enqueued), gate[1] turns non-zero when it gave one up (a
  // card's launch failed after another card's was enqueued).  seq: this
  // launch's number.  Null for a launch captured in a CUDA graph, which
  // has no gate (cross_entry).
  const int* gate;
  int seq;
};
// A block of the cross-card mode touches three ranks' tables: its own
// (slots and flags), its right neighbour's (slots and filled) and its
// left neighbour's (ack).  Thread 0 copies their bases into shared
// memory at entry, and every use reads them from there (volatile: the
// steps have no registers to spare for five pointers, and a copy the
// compiler keeps in registers spills).
struct CrossBases {
  void* slot[2];   // mine, my right neighbour's
  int* flags[3];   // mine, my right neighbour's, my left neighbour's
};
enum { MINE = 0, RIGHT = 1, LEFT = 2 };
template <typename T> struct Tables {
  volatile const CrossBases* b;
  int S;
  int64_t tw;
  // slot: MINE or RIGHT; filled: MINE or RIGHT; ack: MINE or LEFT
  __device__ __forceinline__ T* slot(int who, int k, int64_t hop) const {
    return static_cast<T*>(b->slot[who]) + ((int64_t)k * 2 + (hop & 1)) * tw;
  }
  __device__ __forceinline__ int* filled(int who, int k, int64_t hop) const {
    return b->flags[who] + HS_WORDS + (int64_t)k * 2 + (hop & 1);
  }
  __device__ __forceinline__ int* ack(int who, int k, int64_t hop) const {
    return b->flags[who == LEFT ? 2 : 0] + HS_WORDS + (int64_t)S * 2 + (int64_t)k * 2 +
           (hop & 1);
  }
};

// ------------------------------------------------------------------------
// Step q of tile u of stripe k, rank my (q = 0: the tile's first hop).
// KIND 0: reduce-scatter by sum, 1: by max (x = operands, out = rank my's
// reduced chunk, written at chunk index my of the result geometry);
// KIND 2: all-gather (x = rank my's chunk, read at chunk index my; out =
// every chunk).
// ------------------------------------------------------------------------
template <typename T, int KIND, bool STAMP>
__device__ __forceinline__ void ring_step(const PtrTable& xs, const OutTable& outs,
                                          const Geometry& g, int P, int V, int S, int my,
                                          int k, int64_t u, int q, T* slots, int* flags,
                                          int* stamps) {
  constexpr bool AG = (KIND == 2);
  constexpr int OP = AG ? OP_COPY : (KIND == 1 ? OP_MAX : OP_SUM);
  const int right = (my + 1) % P, left = (my + P - 1) % P;
  const int64_t H = tiles_of(g, S, k) * (V - 1);
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
  const int64_t h0 = u * (V - 1);

  if (q == 0) {
    // hop h0: the local chunk (all-gather) or x[my-1] (reduce-scatter)
    const int* ack0 = tile_waits_ack(h0, H) ? A(my, h0) : nullptr;
    if (AG) {
      T* own = O(my);
      pass<T, OP_COPY, SCOPE_GPU>(X(my), false, true, nullptr, own == X(my) ? nullptr : own,
                                  SL(right, h0), cnt(my), vec, ack0, (int)(h0 / 2), nullptr, 0);
    } else {
      const int c = pmod(my - 1, V);
      pass<T, OP_COPY, SCOPE_GPU>(X(c), false, true, nullptr, SL(right, h0), nullptr, cnt(c),
                                  vec, ack0, (int)(h0 / 2), nullptr, 0);
    }
    __syncthreads();
    if (threadIdx.x == 0) arrive_release<SCOPE_GPU>(F(right, h0));
    return;
  }
  const int64_t h = h0 + q - 1;  // the hop consumed at this step
  const bool last = (q == V - 1);
  // the landing of hop h, then (unless last) the ack that frees the
  // right neighbour's slot for hop h + 1
  const int* ackn = !last && tile_waits_ack(h + 1, H) ? A(my, h + 1) : nullptr;
  T* fwd = last ? nullptr : SL(right, h + 1);
  if (AG) {
    const int c = pmod(my - q, V);
    pass<T, OP_COPY, SCOPE_GPU>(SL(my, h), true, false, nullptr, O(c), fwd, cnt(c), vec,
                                F(my, h), (int)(h / 2 + 1), ackn, (int)((h + 1) / 2));
  } else {
    const int c = pmod(my - 1 - q, V);
    pass<T, OP, SCOPE_GPU>(X(c), false, true, SL(my, h), last ? O(my) : fwd, nullptr, cnt(c),
                           vec, F(my, h), (int)(h / 2 + 1), ackn, (int)((h + 1) / 2));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!last) arrive_release<SCOPE_GPU>(F(right, h + 1));
    // the landing of hop h is consumed: free its slot for hop h + 2
    if (tile_signals_ack(h, H)) arrive_release<SCOPE_GPU>(A(left, h));
    if (STAMP && j0 == 0) {
      // step q - 1 of the reference's kernel is done: its stamp row
      const int64_t seg = (second ? g.part[0].nseg : 0) + i;
      const int st = q - 1;
      const int nbytes = (int)(p.w * (int64_t)sizeof(T));
      int* row = stamps + ((seg * P + my) * (V - 1) + st) * STAMP_COLS;
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
// ring_step of the cross-card mode: the same step over the per-rank
// tables, its flags at .sys scope.  The one-launch path keeps its own
// ring_step above, so that its compiled code stays what it was: one step
// shared by both through an addressing template compiled every
// one-launch instantiation to other machine code (PERF.md).
// ------------------------------------------------------------------------
template <typename T, int KIND, bool STAMP>
__device__ __forceinline__ void ring_step_cross(const PtrTable& xs, const OutTable& outs,
                                                const Geometry& g, int P, int S, int my, int k,
                                                int64_t u, int q, const Tables<T>& sc,
                                                int* stamps) {
  const int V = P;
  constexpr bool AG = (KIND == 2);
  constexpr int OP = AG ? OP_COPY : (KIND == 1 ? OP_MAX : OP_SUM);
  const int right = (my + 1) % P, left = (my + P - 1) % P;
  const int64_t H = tiles_of(g, S, k) * (V - 1);
  // mine (read here) and my neighbours' (written from here)
  auto F_my = [&](int64_t hop) { return sc.filled(MINE, k, hop); };
  auto F_right = [&](int64_t hop) { return sc.filled(RIGHT, k, hop); };
  auto A_my = [&](int64_t hop) { return sc.ack(MINE, k, hop); };
  auto A_left = [&](int64_t hop) { return sc.ack(LEFT, k, hop); };
  auto SL_my = [&](int64_t hop) { return sc.slot(MINE, k, hop); };
  auto SL_right = [&](int64_t hop) { return sc.slot(RIGHT, k, hop); };
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
  const int64_t h0 = u * (V - 1);

  if (q == 0) {
    // hop h0: the local chunk (all-gather) or x[my-1] (reduce-scatter)
    const int* ack0 = tile_waits_ack(h0, H) ? A_my(h0) : nullptr;
    if (AG) {
      T* own = O(my);
      pass<T, OP_COPY, SCOPE_SYS>(X(my), false, true, nullptr, own == X(my) ? nullptr : own,
                                  SL_right(h0), cnt(my), vec, ack0, (int)(h0 / 2), nullptr, 0);
    } else {
      const int c = pmod(my - 1, V);
      pass<T, OP_COPY, SCOPE_SYS>(X(c), false, true, nullptr, SL_right(h0), nullptr, cnt(c),
                                  vec, ack0, (int)(h0 / 2), nullptr, 0);
    }
    __syncthreads();
    if (threadIdx.x == 0) arrive_release<SCOPE_SYS>(F_right(h0));
    return;
  }
  const int64_t h = h0 + q - 1;  // the hop consumed at this step
  const bool last = (q == V - 1);
  // the landing of hop h, then (unless last) the ack that frees the
  // right neighbour's slot for hop h + 1
  const int* ackn = !last && tile_waits_ack(h + 1, H) ? A_my(h + 1) : nullptr;
  T* fwd = last ? nullptr : SL_right(h + 1);
  if (AG) {
    const int c = pmod(my - q, V);
    pass<T, OP_COPY, SCOPE_SYS>(SL_my(h), true, false, nullptr, O(c), fwd, cnt(c), vec,
                                F_my(h), (int)(h / 2 + 1), ackn, (int)((h + 1) / 2));
  } else {
    const int c = pmod(my - 1 - q, V);
    pass<T, OP, SCOPE_SYS>(X(c), false, true, SL_my(h), last ? O(my) : fwd, nullptr, cnt(c),
                           vec, F_my(h), (int)(h / 2 + 1), ackn, (int)((h + 1) / 2));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!last) arrive_release<SCOPE_SYS>(F_right(h + 1));
    // the landing of hop h is consumed: free its slot for hop h + 2
    if (tile_signals_ack(h, H)) arrive_release<SCOPE_SYS>(A_left(h));
    if (STAMP && j0 == 0) {
      // step q - 1 of the reference's kernel is done: its stamp row
      const int64_t seg = (second ? g.part[0].nseg : 0) + i;
      const int st = q - 1;
      const int nbytes = (int)(p.w * (int64_t)sizeof(T));
      int* row = stamps + ((seg * P + my) * (V - 1) + st) * STAMP_COLS;
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
// steps in order, tile by tile.  P ranks play a ring of V = P; in the
// self-ring mode one rank (P = 1) plays a ring of V.
// ------------------------------------------------------------------------
template <typename T, int KIND, bool STAMP>
__global__ void __launch_bounds__(THREADS, 2)
ring_kernel(PtrTable xs, OutTable outs, Geometry g, int P, int V, int S, T* slots,
            int* flags, int* stamps) {
  const int my = blockIdx.x / S, k = blockIdx.x % S;
  const int64_t U = tiles_of(g, S, k);
  for (int64_t u = 0; u < U; ++u)
    for (int q = 0; q < V; ++q)
      ring_step<T, KIND, STAMP>(xs, outs, g, P, V, S, my, k, u, q, slots, flags, stamps);
  if (threadIdx.x == 0 && U > 0) {
    int* ack = flags + (int64_t)P * S * 2;
    const int64_t f = ((int64_t)my * S + k) * 2;
    flags[f] = flags[f + 1] = ack[f] = ack[f + 1] = 0;
  }
}

// ------------------------------------------------------------------------
// The cross-card mode: one launch per card, holding the blocks of that
// card's ranks (block b plays rank tabs.rank[b / S] on stripe b % S), in
// a ring of V = P over every card.  Slots and flags come from the
// per-rank tables, each on the receiving rank's card; a hop is a store
// into the right neighbour's slot over NVLink, and every flag is .sys.
//
// Before a launch, the wrapper joins the cards' streams (accl_ring_join:
// each card's stream waits for the work queued on every other card's),
// so no card's blocks start while another card's stream is still busy
// with work queued before its launch: every wait below then counts
// against SPIN_TIMEOUT_NS only the ring's own time; after the launches
// the first card's stream waits for every card's (accl_ring_join_back),
// so work queued there after the launch (a graph's end, under capture)
// follows every card's blocks.  The blocks of an eager launch also wait
// for the host's gate (wait_gate), which the host opens once every
// card's launch is enqueued, or gives up when one card's launch fails:
// the blocks already on the other cards then end at once instead of
// waiting for ranks that never start.  A launch captured in a CUDA graph
// has no gate: a graph launch enqueues all of its kernels or none.
//
// The joins already order launch N + 1 on every card after launch N on
// every card.  The entry handshake is the kernel's own guard of that
// order, the TPU kernel's barrier, so that the kernel does not rest on
// what its caller joins.  Without either, a fast card's next launch could store into a slot its neighbour has not read
// yet, or count up a flag its neighbour is about to set back to 0.  The
// entry handshake (the job of the TPU kernel's barrier semaphore with
// both neighbours, accl_tpu/ops/ring.py:192-198) rules that out: every
// block, as it ends, sets its own flags back to 0 and then counts
// itself, with a release, into its left neighbour's second handshake
// word and its right neighbour's first; every block, before anything
// else, waits until both of its own words count every block of every
// earlier launch on these tables.  A neighbour's block ends only after
// its last landing and its last ack arrived and were read, so when the
// wait passes, nothing of the last launch is still to be read or counted
// on this rank, and its flags are 0.  The counts only grow (wrapping at
// 2^32), so no launch relies on a word being set back.  A neighbour is
// therefore at most one launch ahead, and only after this rank's blocks
// have ended.
//
// The count the handshake waits for is kept on the card, not by the
// host, so that a launch replayed from a CUDA graph, whose arguments are
// fixed at capture, waits for the right one: each rank's HS_DONE counts
// its blocks that ended every earlier launch on these tables; every
// block reads it at entry (cross_entry), and the rank's last block to
// end advances it by S (count_out), after every block of the rank has
// read it.  The launches on one set of tables follow each other on each
// card (the card's stream, or the graph's edges; the joins order a graph
// between eager launches), so a launch reads the count its predecessor
// left, whether each was launched eagerly or replayed, in any order.
// (The right neighbour's word is the one the schedule needs: a rank
// writes into its left neighbour's ack only after reading that
// neighbour's landing of the same launch.  Both are waited for, as the
// TPU kernel's barrier waits for both neighbours; tests/
// test_torch_multicard.py replays the schedule with either.)
// ------------------------------------------------------------------------
// cross_entry (the gate and the handshake) and count_out are in
// ring_sync.cuh, shared with fused.cu's cross-card mode.

template <typename T, int KIND, bool STAMP>
__global__ void __launch_bounds__(THREADS, 2)
ring_kernel_cross(PtrTable xs, OutTable outs, Geometry g, int P, int S, RankTables tabs,
                  int* stamps) {
  const int my = tabs.rank[blockIdx.x / S], k = blockIdx.x % S;
  const int left = (my + P - 1) % P, right = (my + 1) % P;
  __shared__ CrossBases bases;
  __shared__ int opened;
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
  const int64_t U = tiles_of(g, S, k);
  const Tables<T> sc{&bases, S, g.tw};
  for (int64_t u = 0; u < U; ++u)
    for (int q = 0; q < P; ++q)
      ring_step_cross<T, KIND, STAMP>(xs, outs, g, P, S, my, k, u, q, sc, stamps);
  if (threadIdx.x == 0) {
    if (U > 0) {
      int* f = tabs.flags[my] + HS_WORDS;
      f[k * 2] = f[k * 2 + 1] = f[S * 2 + k * 2] = f[S * 2 + k * 2 + 1] = 0;
    }
    arrive_release<SCOPE_SYS>(tabs.flags[left] + 1);
    arrive_release<SCOPE_SYS>(tabs.flags[right]);
    count_out(tabs.flags[my], S);
  }
}

// ------------------------------------------------------------------------
// host side: plain C interface, bound with ctypes
// ------------------------------------------------------------------------
enum { DT_F32 = 0, DT_F16 = 1, DT_F64 = 2, DT_I32 = 3, DT_I64 = 4 };

template <typename T, bool STAMP, bool CROSS>
static void* kernel_of(int kind) {
  switch (kind) {
    case 0: return CROSS ? (void*)ring_kernel_cross<T, 0, STAMP> : (void*)ring_kernel<T, 0, STAMP>;
    case 1: return CROSS ? (void*)ring_kernel_cross<T, 1, STAMP> : (void*)ring_kernel<T, 1, STAMP>;
    case 2: return CROSS ? (void*)ring_kernel_cross<T, 2, STAMP> : (void*)ring_kernel<T, 2, STAMP>;
  }
  return nullptr;
}

template <bool STAMP, bool CROSS>
static void* kernel_for(int kind, int dtype) {
  switch (dtype) {
    case DT_F32: return kernel_of<float, STAMP, CROSS>(kind);
    case DT_F16: return kernel_of<__half, STAMP, CROSS>(kind);
    case DT_F64: return kernel_of<double, STAMP, CROSS>(kind);
    case DT_I32: return kernel_of<int, STAMP, CROSS>(kind);
    case DT_I64: return kernel_of<long long, STAMP, CROSS>(kind);
  }
  return nullptr;
}

// variant: bit 0 the device-trace instantiation, bit 1 the cross-card mode
static void* kernel_for(int kind, int dtype, int variant) {
  switch (variant) {
    case 0: return kernel_for<false, false>(kind, dtype);
    case 1: return kernel_for<true, false>(kind, dtype);
    case 2: return kernel_for<false, true>(kind, dtype);
    case 3: return kernel_for<true, true>(kind, dtype);
  }
  return nullptr;
}

extern "C" {

const char* accl_ring_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks of one kernel (kind 0 = reduce-scatter by sum, 1 = by max, 2 =
// all-gather; variant bit 0 = the device-trace instantiation, bit 1 =
// the cross-card mode) that can be resident on the card together, or a
// negative CUDA error.
int accl_ring_resident(int kind, int dtype, int stamp, int device) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return -(int)on.err;
  cudaError_t e;
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
// instantiation (kind and variant as above), as the runtime reports them.
int accl_ring_kernel_info(int kind, int dtype, int stamp, int device, int* out) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t e;
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
// int64 words, the layout of struct Geometry), for a ring of V hops per
// tile: V = P, or the self-ring mode's P = 1 and any V >= 2.  slots
// holds P * S * 2 * tw elements; flags P * S * 4 int32, zero on entry
// and on exit.  A non-null stamps (segments * P * (V - 1) * STAMP_COLS
// int32) launches the device-trace instantiation, which fills it.
int accl_ring_launch(int kind, int dtype, const void* const* xs, void* const* outs, int P,
                     int V, int S, const int64_t* geo, void* slots, int* flags, int* stamps,
                     int device, void* stream) {
  if (P < 1 || P > MAXP || V < 2 || (V != P && P != 1) || S < 1)
    return (int)cudaErrorInvalidValue;
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t e;
  void* fn = kernel_for(kind, dtype, stamps != nullptr ? 1 : 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  PtrTable xt;
  OutTable ot;
  for (int r = 0; r < P; ++r) { xt.p[r] = xs[r]; ot.p[r] = outs[r]; }
  Geometry g;
  memcpy(&g, geo, sizeof(Geometry));
  void* args[] = {&xt, &ot, &g, &P, &V, &S, &slots, &flags, &stamps};
  e = cudaLaunchCooperativeKernel(fn, dim3(P * S), dim3(THREADS), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Enable peer access between every pair of the n devices.  A pair the
// hardware cannot join fails with cudaErrorPeerAccessUnsupported and its
// two devices in pair[0..1]; access that is already enabled is no error.
int accl_ring_enable_peers(const int* devices, int n, int* pair) {
  if (n < 1) return 0;
  const CurrentDevice keep(devices[0]);  // each i is made current below
  if (keep.err != cudaSuccess) return (int)keep.err;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      if (devices[i] == devices[j]) continue;
      int can = 0;
      cudaError_t e = cudaDeviceCanAccessPeer(&can, devices[i], devices[j]);
      if (e != cudaSuccess) return (int)e;
      if (!can) {
        pair[0] = devices[i];
        pair[1] = devices[j];
        return (int)cudaErrorPeerAccessUnsupported;
      }
      e = cudaSetDevice(devices[i]);
      if (e != cudaSuccess) return (int)e;
      e = cudaDeviceEnablePeerAccess(devices[j], 0);
      if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // clear it: the access is there
      } else if (e != cudaSuccess) {
        pair[0] = devices[i];
        pair[1] = devices[j];
        return (int)e;
      }
    }
  return 0;
}

// Joins of the streams of n cards around a cross-card launch, the first
// stream (streams[0], on devices[0]) the root.  Nothing is waited for on
// the host.  One event a device, made at first use and recorded again by
// every join: a wait takes the record made before it.  Callers serialize
// the joins (ops/ring.py holds one lock around a launch and its joins).
#define MAX_DEVICES 64
static cudaEvent_t join_events[MAX_DEVICES];

// Stream j waits for what was queued on stream i so far, for each j in
// to[0..nto) (indices into devices and streams).
static cudaError_t wait_for(const int* devices, void* const* streams, int i, const int* to,
                            int nto) {
  cudaEvent_t* ev = &join_events[devices[i]];
  cudaError_t e = cudaSetDevice(devices[i]);
  if (e == cudaSuccess && *ev == nullptr) e = cudaEventCreateWithFlags(ev, cudaEventDisableTiming);
  if (e == cudaSuccess) e = cudaEventRecord(*ev, (cudaStream_t)streams[i]);
  for (int t = 0; e == cudaSuccess && t < nto; ++t) {
    e = cudaSetDevice(devices[to[t]]);
    if (e == cudaSuccess) e = cudaStreamWaitEvent((cudaStream_t)streams[to[t]], *ev, 0);
  }
  return e;
}

static cudaError_t check_devices(const int* devices, int n) {
  for (int i = 0; i < n; ++i)
    if (devices[i] < 0 || devices[i] >= MAX_DEVICES) return cudaErrorInvalidValue;
  return n > MAXP ? cudaErrorInvalidValue : cudaSuccess;
}

// Before a cross-card launch: every stream waits for what was queued on
// every other one, so no card's launch starts before every card's stream
// has reached it: the root waits for each of the others, then each of
// them for the root.  With fork, the others first wait for the root:
// under CUDA graph capture on the root's stream, that forks the streams
// not yet capturing into the capture (a stream that is not capturing may
// not be waited for from one that is).
int accl_ring_join(const int* devices, void* const* streams, int n, int fork) {
  if (n < 2) return 0;
  cudaError_t e = check_devices(devices, n);
  if (e != cudaSuccess) return (int)e;
  int others[MAXP], root = 0;
  for (int i = 1; i < n; ++i) others[i - 1] = i;
  const CurrentDevice keep(devices[0]);  // each card is made current below
  e = keep.err;
  if (e == cudaSuccess && fork) e = wait_for(devices, streams, 0, others, n - 1);
  for (int i = 1; e == cudaSuccess && i < n; ++i) e = wait_for(devices, streams, i, &root, 1);
  if (e == cudaSuccess) e = wait_for(devices, streams, 0, others, n - 1);
  return (int)e;
}

// After a cross-card launch: the root waits for every other card's
// stream, so what is queued on the root after the launch follows every
// card's blocks (a later launch on the same tables, a graph replayed on
// the root's stream; under capture, the other streams' launches are
// joined back into the root's).
int accl_ring_join_back(const int* devices, void* const* streams, int n) {
  if (n < 2) return 0;
  cudaError_t e = check_devices(devices, n);
  if (e != cudaSuccess) return (int)e;
  const int root = 0;
  const CurrentDevice keep(devices[0]);
  e = keep.err;
  for (int i = 1; e == cudaSuccess && i < n; ++i) e = wait_for(devices, streams, i, &root, 1);
  return (int)e;
}

// Two words of mapped host memory, zero, for a set of tables' gate
// (RankTables::gate).  Under unified addressing the kernels use the host
// address itself.  Never freed: a launch given up may still read it.
int accl_ring_gate_new(int** gate) {
  int* p = nullptr;
  cudaError_t e = cudaHostAlloc((void**)&p, 2 * sizeof(int),
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  void* dp = nullptr;
  e = cudaHostGetDevicePointer(&dp, p, 0);
  if (e != cudaSuccess) return (int)e;
  if (dp != (void*)p) return (int)cudaErrorInvalidValue;
  p[0] = p[1] = 0;
  *gate = p;
  return 0;
}

// One card's launch of the cross-card mode: n * S blocks, block b playing
// rank ranks[b / S] of a ring of P over every card.  xs, outs, slots and
// flags hold one entry per rank of the ring (rank r's slots S * 2 * tw
// elements and flags HS_WORDS + S * 4 int32 on rank r's card, zero when
// first made; the flags' head keeps the handshake's count, so every launch
// on one set of tables passes the same flags).  An eager launch passes
// its gate (from accl_ring_gate_new): its blocks start once gate[0]
// reaches seq, and end at once if gate[1] is set first.  A launch
// captured in a CUDA graph passes a null gate.  A non-null stamps
// (segments * P * (P - 1) * STAMP_COLS int32 on this card) takes the rows
// of this card's ranks.
int accl_ring_launch_cross(int kind, int dtype, const void* const* xs, void* const* outs,
                           int P, const int* ranks, int n, int S, const int64_t* geo,
                           void* const* slots, int* const* flags, const int* gate,
                           int seq, int* stamps, int device, void* stream) {
  if (P < 2 || P > MAXP || n < 1 || n > P || S < 1) return (int)cudaErrorInvalidValue;
  void* fn = kernel_for(kind, dtype, stamps != nullptr ? 3 : 2);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  PtrTable xt;
  OutTable ot;
  RankTables tabs;
  for (int r = 0; r < P; ++r) {
    xt.p[r] = xs[r];
    ot.p[r] = outs[r];
    tabs.slots[r] = slots[r];
    tabs.flags[r] = flags[r];
  }
  tabs.gate = gate;
  tabs.seq = seq;
  for (int i = 0; i < n; ++i) {
    if (ranks[i] < 0 || ranks[i] >= P) return (int)cudaErrorInvalidValue;
    tabs.rank[i] = ranks[i];
  }
  Geometry g;
  memcpy(&g, geo, sizeof(Geometry));
  void* args[] = {&xt, &ot, &g, &P, &S, &tabs, &stamps};
  cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(n * S), dim3(THREADS), args, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// -- buffers shared with other processes (CUDA IPC) ---------------------------
// The cross-process form of the cross-card mode (ops/ring.py) keeps each
// rank's slots and flags in an allocation of its own, made here with
// cudaMalloc, so that an IPC handle names the buffer's own base: a
// tensor of PyTorch's caching allocator is a sub-block of a cached
// segment (its handle would name the segment, and an offset would have
// to travel with it), and memory of expandable segments cannot be
// exported this way at all.  Another process opens the handle
// (accl_ipc_open) and its kernels store into the buffer as a neighbour
// card's do over NVLink.  The same entries serve the staging buffers of
// utils/ipc.py, which carry a tensor from one process to another.

// Bytes of one cudaIpcMemHandle_t.
int accl_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// nbytes of device memory on device, zeroed, in *ptr.
int accl_ipc_malloc(long long nbytes, int device, void** ptr) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  void* p = nullptr;
  cudaError_t e = cudaMalloc(&p, (size_t)nbytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(p, 0, (size_t)nbytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e != cudaSuccess) {
    cudaFree(p);
    return (int)e;
  }
  *ptr = p;
  return 0;
}

// Frees what accl_ipc_malloc made (after every process that opened it
// has closed it).
int accl_ipc_free(void* ptr, int device) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  return (int)cudaFree(ptr);
}

// The IPC handle of ptr (the base of an accl_ipc_malloc buffer), written
// into handle (accl_ipc_handle_bytes bytes).
int accl_ipc_export(void* ptr, int device, void* handle) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  return (int)cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, ptr);
}

// Opens another process's handle on device, its address in *ptr; peer
// access to the exporting card is enabled as the mapping needs it.
int accl_ipc_open(const void* handle, int device, void** ptr) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// Unmaps what accl_ipc_open mapped.
int accl_ipc_close(void* ptr, int device) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  return (int)cudaIpcCloseMemHandle(ptr);
}

// nbytes from src to dst (device memory of this process, or opened from
// another's) on stream, ordered as any work on it.
int accl_ipc_copy(void* dst, const void* src, long long nbytes, int device, void* stream) {
  const CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  return (int)cudaMemcpyAsync(dst, src, (size_t)nbytes, cudaMemcpyDeviceToDevice,
                              (cudaStream_t)stream);
}

}  // extern "C"
