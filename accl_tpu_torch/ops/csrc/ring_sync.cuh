// Ring flow control shared by the kernels of ring.cu and fused.cu: the
// per-rank pointer tables, the ACK-window algebra of the reference
// (accl_tpu/ops/ring.py:132-148) and the release/acquire flags with
// their wait, which traps when one wait passes SPIN_TIMEOUT_NS.
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
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Publish, after a __syncthreads, what the whole block wrote: one
// thread's release reduction.  The barrier orders the block's writes
// before it, and a release is cumulative, so a reader that acquires the
// count sees them all (the pattern of CUTLASS's GenericBarrier, whose
// fence.acq_rel + red.relaxed is the same release; a __threadfence
// before it, the heavier fence.sc, is not needed).
__device__ __forceinline__ void arrive_release(int* p) {
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
__device__ __forceinline__ void wait_geq(const int* p, int target) {
  if (threadIdx.x == 0) {
    uint64_t t0 = global_ns();
    while (ld_acquire(p) < target) {
      __nanosleep(64);
      if (global_ns() - t0 > SPIN_TIMEOUT_NS) __trap();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int pmod(int a, int P) { return ((a % P) + P) % P; }
