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
// words: the entry handshake's two counts, then a card's copy of the
// host's gate) and the gate's wait (wait_gate): see ring.cu
// ring_kernel_cross.
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

// -- the cross-card modes' entry ----------------------------------------------
// Words at the head of a rank's flags in the cross-card modes (their
// layout: ring.cu, RankTables).
#define HS_WORDS 4

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
