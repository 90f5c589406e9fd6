// Hopper bulk async copies into a ring of shared-memory stages, and the
// 16-byte lane reads of the kernels that consume them.
//
// One thread asks the copy engine for a contiguous run of bytes
// (cp.async.bulk, global -> shared); the bytes land in a stage of the ring
// and are counted off an mbarrier's transaction count, so the other threads
// wait on the barrier's phase instead of issuing loads themselves.  Every
// address handed to a bulk copy is 16-byte aligned and every size a
// multiple of 16 bytes; the wrappers refuse tensors that would break that.
//
// Protocol of the kernels (one producer warp, several consumer warps):
// stage s has a "full" barrier (one arrival: the producer's
// arrive.expect_tx, plus the bytes of its copies) and an "empty" barrier
// (one arrival per consumer warp after the warp's last read of the stage,
// or, where the stage is written back by a bulk store, one arrival once
// the store has read it).  The k-th fill of a stage (k = 0, 1, ...) is
// awaited by the consumers with parity k & 1; before it, the producer
// awaits the empty barrier with parity (k & 1) ^ 1, which a fresh barrier
// passes at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `count` arrivals complete a phase.
__device__ __forceinline__ void init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// A plain arrival (a consumer warp releasing a stage).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Makes the initialised barriers visible to the copy engine; follow it
// with __syncthreads() before any thread uses them.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's arrival: the phase completes once `bytes` have landed.
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16) from global `src` to shared `dst`,
// both 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void load(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Spin until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk copy of `bytes` (a multiple of 16) from shared `src` to global
// `dst`, both 16-byte aligned, in the thread's current bulk group.  The
// threads that wrote `src` first run fence_async() and meet at a barrier.
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// Closes the thread's current bulk group of stores ...
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ... and waits until every committed group but the `kPending` most
// recent ones has read its shared memory, after which those stages may
// be refilled.
template <int kPending>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// Orders this thread's shared-memory writes before later bulk copies
// (the async proxy) read them.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier 1 over the first `threads` threads (the consumer warps), which
// leaves the producer warp out.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Position in a ring of `stages`: the stage and the parity its waiters pass.
struct Cursor {
  int stage = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      parity ^= 1u;
    }
  }
};

// Grid of a persistent (tiles x pods) kernel: how many `tile`-coordinate
// chunks one stage holds (the largest power of two up to `max_chunks`
// that still leaves `target` blocks work) and the grid's x extent.
struct Grid {
  int chunks, gx;
};

inline Grid persistent_grid(int n, int pods, int tile, int max_chunks,
                            int target) {
  int chunks = 1;
  while (chunks < max_chunks &&
         (int64_t)((n + 2 * chunks * tile - 1) / (2 * chunks * tile)) * pods >=
             target)
    chunks *= 2;
  const int n_tiles = (n + chunks * tile - 1) / (chunks * tile);
  int gx = (target + pods - 1) / pods;
  return {chunks, gx < n_tiles ? gx : n_tiles};
}

// A consumer lane reads 16 bytes of a stage: kVec coordinates of T.
template <typename T> struct Lane;
template <> struct Lane<float> {
  static constexpr int kVec = 4;
};
template <> struct Lane<__nv_bfloat16> {
  static constexpr int kVec = 8;
};

__device__ __forceinline__ void unpack(uint4 raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}

// bf16 -> f32 is exact: the 16 bits become the high half of the float.
__device__ __forceinline__ void unpack(uint4 raw, float (&x)[8]) {
  const uint32_t h[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(h[i] << 16);
    x[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
  }
}

// The card's SM count, which sizes the persistent grids (read once per
// process: the port drives one card type at a time).
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

}  // namespace ring
