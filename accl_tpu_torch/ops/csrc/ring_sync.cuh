// Ring flow control shared by the kernels of ring.cu and fused.cu: the
// per-rank pointer tables, the ACK-window algebra of the reference
// (accl_tpu/ops/ring.py:132-148) and the release/acquire flags with
// their wait, which traps when one wait passes SPIN_TIMEOUT_NS.
//
// The flags' memory scope is a template argument.  SCOPE_GPU (.gpu)
// orders what the threads of one card see, and is the scope of fused.cu
// and of a ring launch whose ranks share one card.  SCOPE_SYS (.sys)
// also orders what a peer card writes over NVLink and reads back: the
// scope of the cross-card modes of ring.cu and fused.cu, whose hops
// store into another card's memory.
//
// The cross-card modes also share the head of a rank's flags (HS_WORDS
// words: the entry handshake's two counts, a card's copy of the host's
// gate, and the rank's own count of its ended blocks), the gate's wait
// (wait_gate), a block's entry (cross_entry) and its count at its end
// (count_out): see ring.cu ring_kernel_cross.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define MAXP 32
#define SPIN_TIMEOUT_NS 10000000000ULL

struct PtrTable { const void* p[MAXP]; };
struct OutTable { void* p[MAXP]; };

// -- flow-control algebra (twin of accl_tpu/ops/ring.py:132-148) ----------
__host__ __device__ __forceinline__ bool ag_waits_ack(int step, int P) { return step >= 1; }
__host__ __device__ __forceinline__ bool ag_signals_ack(int step, int P) { return step <= P - 3; }
__host__ __device__ __forceinline__ bool rs_waits_ack(int step, int P) { return step >= 2; }
__host__ __device__ __forceinline__ bool rs_signals_ack(int step, int P) { return step <= P - 4; }

// -- the long schedule of a persistent launch (ring.cu) ---------------------
// A stripe of U tiles makes H = U (P - 1) hops, numbered across its tiles,
// hop h landing in slot h % 2, each landing read once: the windows of the
// reduce-scatter's landing slot over a ring of H hops, rs_*(hop, H + 1).
__host__ __device__ __forceinline__ bool tile_waits_ack(int64_t hop, int64_t H) { return hop >= 2; }
__host__ __device__ __forceinline__ bool tile_signals_ack(int64_t hop, int64_t H) { return hop <= H - 3; }

// -- flags ----------------------------------------------------------------
enum { SCOPE_GPU = 0, SCOPE_SYS = 1 };

template <int SCOPE>
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  if (SCOPE == SCOPE_SYS)
    asm volatile("ld.acquire.sys.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Publish, after a __syncthreads, what the whole block wrote: one
// thread's release reduction.  The barrier orders the block's writes
// before it, and a release is cumulative, so a reader that acquires the
// count sees them all (the pattern of CUTLASS's GenericBarrier, whose
// fence.acq_rel + red.relaxed is the same release; a __threadfence
// before it, the heavier fence.sc, is not needed).
template <int SCOPE>
__device__ __forceinline__ void arrive_release(int* p) {
  if (SCOPE == SCOPE_SYS)
    asm volatile("red.release.sys.global.add.s32 [%0], 1;" :: "l"(p) : "memory");
  else
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;" :: "l"(p) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Block-wide wait until *p >= target.  Thread 0 spins; the barrier after
// it orders every thread's later loads after the acquire.  The time limit
// counts from the start of this wait, not from kernel entry.
template <int SCOPE>
__device__ __forceinline__ void wait_geq(const int* p, int target) {
  if (threadIdx.x == 0) {
    uint64_t t0 = global_ns();
    while (ld_acquire<SCOPE>(p) < target) {
      __nanosleep(64);
      if (global_ns() - t0 > SPIN_TIMEOUT_NS) __trap();
    }
  }
  __syncthreads();
}

// Thread 0's wait until the count *p has reached target, for a count
// that only grows and may wrap around 2^32: the difference is compared,
// as in a sequence number.  No barrier: the caller's follows.
template <int SCOPE>
__device__ __forceinline__ void wait_reached(const int* p, int target) {
  uint64_t t0 = global_ns();
  while ((int)((unsigned)ld_acquire<SCOPE>(p) - (unsigned)target) < 0) {
    __nanosleep(64);
    if (global_ns() - t0 > SPIN_TIMEOUT_NS) __trap();
  }
}

__device__ __forceinline__ int pmod(int a, int P) { return ((a % P) + P) % P; }

// -- the cross-card modes' entry and exit -------------------------------------
// Words at the head of a rank's flags in the cross-card modes (their
// layout: ring.cu, RankTables): 0 and 1 the handshake's counts, 2 and 3
// a card's copy of the host's gate, HS_DONE the blocks of this rank that
// ended every earlier launch on these tables (the count the handshake
// waits for), HS_ENDED the blocks of this rank that have ended the
// launch under way.
#define HS_WORDS 6
#define HS_DONE 4
#define HS_ENDED 5

__device__ __forceinline__ void store_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// Thread 0's wait for the word on launch seq, in the host's gate or a
// card's copy of it (both hold the number of the last launch opened):
// 1 when launch seq was opened (gate[0] has reached seq, a count that
// may wrap), 0 when it was given up (gate[1] set).  gate[1] is read
// first: every earlier launch is opened before one is given up, so a
// launch that sees gate[1] set and gate[0] short of it is the one given
// up.
__device__ __forceinline__ int wait_gate(const int* gate, int seq) {
  uint64_t t0 = global_ns();
  for (;;) {
    const int given_up = ld_acquire<SCOPE_SYS>(gate + 1);
    if ((int)((unsigned)ld_acquire<SCOPE_SYS>(gate) - (unsigned)seq) >= 0) return 1;
    if (given_up) return 0;
    __nanosleep(64);
    if (global_ns() - t0 > SPIN_TIMEOUT_NS) __trap();
  }
}

// Thread 0's entry of a block in the cross-card modes, for the rank whose
// flags start at head.  An eager launch (gate non-null) first waits for
// the host's gate on launch seq: block 0 of the card reads it over the
// bus and copies what it saw into the card's words card_gate (words 2
// and 3 of the card's first rank), the other blocks wait on those
// (hundreds of blocks polling host memory would crowd the bus the host's
// launches on the other cards go over).  A captured launch (gate null)
// has no gate: a graph launch enqueues every card's kernel or none.  Then
// the handshake: both of the rank's words must count every block of
// every earlier launch on these tables, which the rank's HS_DONE holds
// (count_out), so the count comes from the card and a replayed launch
// reads the count of its replay.  Returns 0 for a launch given up: its
// block then touches nothing and counts nothing.
__device__ __forceinline__ int cross_entry(const int* gate, int seq, int* card_gate,
                                           const int* head) {
  if (gate != nullptr) {
    int opened;
    if (blockIdx.x == 0) {
      opened = wait_gate(gate, seq);
      store_release_sys(opened ? card_gate : card_gate + 1, opened ? seq : 1);
    } else {
      opened = wait_gate(card_gate, seq);
    }
    if (!opened) return 0;
  }
  const int base = ld_acquire<SCOPE_GPU>(head + HS_DONE);
  wait_reached<SCOPE_SYS>(head, base);
  wait_reached<SCOPE_SYS>(head + 1, base);
  return 1;
}

// Thread 0 of a block of rank r as it ends, after its handshake counts:
// counts the block out of the launch in r's HS_ENDED (on r's card, the
// card of the launch), and r's last block to end sets that count back to
// 0 and advances r's HS_DONE by S, the count that the next launch's
// blocks of r read at entry.  Every block of r read HS_DONE before it
// counted itself out (acq_rel), so none of this launch reads the
// advanced count; the card's stream, or a graph's edges, order the next
// launch on these tables on this card after this one ended.  The count
// wraps at 2^32, as the handshake's do.
__device__ __forceinline__ void count_out(int* head, int S) {
  int ended;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(ended) : "l"(head + HS_ENDED) : "memory");
  if (ended == S - 1) {
    head[HS_ENDED] = 0;
    head[HS_DONE] = (int)((unsigned)head[HS_DONE] + (unsigned)S);
  }
}
