// tally_acc: for every pod p, device d and coordinate i,
//   x = f32(u[p, d, i]) + rho * f32(delta[p, i])      (no delta: x = u)
//   tally[p, d, i] <- T(int32(tally[p, d, i]) + w[p, d] * sgn(x))
//
// Replaces the TPU kernel src/repro/kernels/tally_acc.py::tally_acc
// (_tally_acc_kernel), the per-client step of DC-HierSignSGD's streamed
// virtual-client sweep: one client's DC-corrected sign plane is folded,
// weighted by the client's vote weight, into the persistent signed
// tally, which is int8, int16 or int32 by the static weight bound.  The
// sign plane itself never reaches device memory.  Like the TPU kernel's
// input_output_aliases, the tally is updated in place.
//
// Bound on the H100: bytes.  u is read once (4 B f32 or 2 B bf16), the
// correction once per pod (P*n, not P*D*n), the tally read and written
// once, the weights once: P*D*n*(sizeof(u) + 2*sizeof(T)) +
// P*n*sizeof(delta) + 4*P*D bytes at 3.35 TB/s.  A handful of integer
// and float operations per coordinate is far below the compute rate.
//
// Design (Hopper), sign_pack.cu's load path with a bulk store behind it.
// The grid is (coordinate tiles, pods[, row groups]): blockIdx.y is the
// pod, and a block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// of its pod (one wave of two blocks per SM).  A tile is 1, 2 or 4 chunks
// of 1024 coordinates, as many as still leave the ring 4 stages.  A block
// has one producer warp and 8 (f32 u) or 4 (bf16 u) consumer warps.  What
// the first design (one thread per coordinate in an (n/256, D, P) grid)
// lost, and what this one does about it:
//   1. 1-2 B tally loads and stores and 2 B bf16 loads per lane, so its
//      time barely moved with the bytes (0.30-0.37 ms at [4, 5, 2^22]
//      against bounds of 0.110-0.320 ms): one lane of the producer warp
//      copies each row's u tile and tally tile into one stage of a
//      shared-memory ring (cp.async.bulk, both completing on the stage's
//      "full" mbarrier, bulk_ring.cuh); each consumer lane reads 16 B of u
//      (4 f32 or 8 bf16 coordinates) and their 4-32 B of tally, adds w*s
//      in int32 and writes the narrowed tally back into the stage; the
//      tile then goes out as ONE bulk store (cp.async.bulk ... bulk_group),
//      so an int8 tally is written at full width.  The store's thread
//      follows this order: every consumer fences its shared writes to the
//      async proxy, the consumers meet at a named barrier, one thread
//      issues and commits the store; it makes the stage's "empty" arrival
//      only once the store has read the stage, so the producer never
//      refills a stage that a store still reads.  It waits for that one
//      stage later (wait_group.read 1 after the next store, which then
//      releases the previous stage), so the read is off the consumers'
//      path; a stage costs the ring one slot longer;
//   2. the correction was re-read for each of the D device rows: the
//      producer copies the pod's correction tile once, first in the tile,
//      and the consumers keep rho*delta in registers for all D rows;
//   3. few tiles (the main path's [4, 5, 53248] has 52 a pod): when the
//      tiles are fewer than the wave's blocks, blockIdx.z splits each
//      pod's rows, and the correction's extra reads come from L2.
// The first design's times, which this one replaces (chip_smoke.py on an
// H100 80GB HBM3 at a 700 W power limit): 0.006426 ms device at
// [4, 5, 53248] (f32 u, int16 tally, correction); at [4, 5, 2^22]
// 0.3742 ms with the same types (bound 0.2204 ms).
//
// Rounding: the same as sign_pack.cu, which the merged mode runs on the
// same directions: rho*delta is rounded before the add (__fmul_rn /
// __fadd_rn, and the build passes -fmad=false), so the streamed and
// merged modes see the same signs bit for bit.  The sign is
// x > -FLT_MIN: -0.0 and negative subnormals give +1 (the reference
// flushes subnormals), NaN gives -1.  The product w*s and the add are
// int32 (wrapping, as the reference's); every partial tally lies within
// the weight bound, so the narrowing store (the low bytes) is exact.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kTile = 1024;        // coordinates of one chunk
constexpr int kMaxChunks = 4;      // chunks of one row per stage
constexpr int kBlocksPerSm = 2;
constexpr int kRingBytes = 64 * 1024;
// chunks shrink until this many stages fit: a stage is released one
// store late, so a ring that is refilled needs at least 3
constexpr int kMinStages = 4;
constexpr int kMaxStages = 16;

// The V tally values of one lane (V * sizeof(A) bytes: 4 to 32), as
// 32-bit words in registers.
template <typename A, int V>
struct Tallies {
  static constexpr int kWords = V * (int)sizeof(A) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const unsigned char* p) {
    if constexpr (kWords == 1) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (kWords == 2) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x;
      w[1] = t.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 t = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = t.x;
        w[4 * i + 1] = t.y;
        w[4 * i + 2] = t.z;
        w[4 * i + 3] = t.w;
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* p) const {
    if constexpr (kWords == 1) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else if constexpr (kWords == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i)
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    }
  }

  // value i, sign-extended to 32 bits
  __device__ __forceinline__ uint32_t get(int i) const {
    if constexpr (sizeof(A) == 1)
      return (uint32_t)(int32_t)(int8_t)(w[i / 4] >> (8 * (i % 4)));
    else if constexpr (sizeof(A) == 2)
      return (uint32_t)(int32_t)(int16_t)(w[i / 2] >> (16 * (i % 2)));
    else
      return w[i];
  }

  // replaces value i by the low bytes of x (the narrowing)
  __device__ __forceinline__ void set(int i, uint32_t x) {
    if constexpr (sizeof(A) == 4) {
      w[i] = x;
    } else {
      constexpr int kPer = 4 / (int)sizeof(A);
      constexpr uint32_t kMask = (1u << (8 * sizeof(A))) - 1u;
      const int sh = 8 * (int)sizeof(A) * (i % kPer);
      w[i / kPer] = (w[i / kPer] & ~(kMask << sh)) | ((x & kMask) << sh);
    }
  }
};

// Each stage holds `chunks` x kTile coordinates of one row: the
// correction's (row r0 - 1, first of each tile when kDelta), or u's and
// then the tally's of device row r.
template <typename T, typename A, bool kDelta>
__global__ void __launch_bounds__(kTile / ring::Lane<T>::kVec + 32)
    tally_acc_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                     float rho, const int32_t* __restrict__ weights,
                     A* __restrict__ tally, int devices, int n, int chunks,
                     int stages, int rows) {
  constexpr int V = ring::Lane<T>::kVec;
  constexpr int kConsumers = kTile / V;            // 256 (f32) or 128 (bf16)
  constexpr int kConsumerWarps = kConsumers / 32;
  constexpr int kUChunk = kTile * (int)sizeof(T);  // bytes of a chunk
  constexpr int kTChunk = kTile * (int)sizeof(A);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.y;
  const int span = chunks * kTile;                // coordinates of a tile
  const int n_tiles = (n + span - 1) / span;
  const int r0 = blockIdx.z * rows;               // this block's rows
  const int r1 = min(devices, r0 + rows);
  const int total = ((n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) *
                    (r1 - r0 + (kDelta ? 1 : 0));  // stages to consume
  const int tally_at = chunks * kUChunk;          // in a stage
  const int stage_bytes = tally_at + chunks * kTChunk;
  const int64_t row0 = (int64_t)p * devices;      // the pod's first row
  const T* d_pod = kDelta ? delta + (int64_t)p * n : nullptr;
  const int first_row = kDelta ? r0 - 1 : r0;     // r0 - 1: the correction

  // The producer warp's lane 0 sets up the ring and fills its first
  // stages before the block-wide barrier, then refills each stage as its
  // bulk store (or, for the correction, the consumers) releases it.
  ring::Cursor c;
  int t = blockIdx.x, r = first_row, j = 0;
  const bool producer = warp == kConsumerWarps && lane == 0;
  auto produce = [&](int until) {
    for (; j < until; ++j) {
      ring::wait(&empty[c.stage], c.parity ^ 1u);
      const int c0 = t * span;
      const uint32_t len = (uint32_t)min(span, n - c0);
      unsigned char* dst = smem + (size_t)c.stage * stage_bytes;
      if (r < r0) {
        ring::expect(&full[c.stage], len * sizeof(T));
        ring::load(dst, d_pod + c0, len * sizeof(T), &full[c.stage]);
      } else {
        const int64_t o = (row0 + r) * n + c0;
        ring::expect(&full[c.stage], len * (sizeof(T) + sizeof(A)));
        ring::load(dst, u + o, len * sizeof(T), &full[c.stage]);
        ring::load(dst + tally_at, tally + o, len * sizeof(A),
                   &full[c.stage]);
      }
      c.advance(stages);
      if (++r == r1) {
        r = first_row;
        t += gridDim.x;
      }
    }
  };
  if (producer) {
    for (int s = 0; s < stages; ++s) {
      ring::init(&full[s], 1);
      ring::init(&empty[s], 1);
    }
    ring::fence_init();
    produce(min(stages, total));    // fresh stages: no wait
  }
  __syncthreads();
  if (warp == kConsumerWarps) {
    if (producer) produce(total);
    return;
  }

  float rd[kMaxChunks][V];  // rho * delta of this lane's coordinates
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) rd[k][i] = 0.0f;
  int stored = -1;          // thread 0: the stage of the last store, if any
  for (int j = 0; j < total; ++j) {
    const bool corr = kDelta && r < r0;
    // the row's vote weight, read before the wait (r0 for the correction)
    const uint32_t w = (uint32_t)__ldg(weights + row0 + (corr ? r0 : r));
    ring::wait(&full[c.stage], c.parity);
    unsigned char* st = smem + (size_t)c.stage * stage_bytes;
    const int c0 = t * span;
    const int len = min(span, n - c0);
    if (corr) {
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        if (k >= chunks || k * kTile + tid * V >= len) continue;
        float dv[V];
        ring::unpack(reinterpret_cast<const uint4*>(st + k * kUChunk)[tid],
                     dv);
#pragma unroll
        for (int i = 0; i < V; ++i) rd[k][i] = __fmul_rn(rho, dv[i]);
      }
      ring::consumers_sync(kConsumers);       // all have read the stage
      if (tid == 0) ring::arrive(&empty[c.stage]);
    } else {
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        if (k >= chunks || k * kTile + tid * V >= len) continue;
        float x[V];
        ring::unpack(reinterpret_cast<const uint4*>(st + k * kUChunk)[tid],
                     x);
        unsigned char* tp = st + tally_at + k * kTChunk + tid * V * sizeof(A);
        Tallies<A, V> tv;
        tv.load(tp);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xi = kDelta ? __fadd_rn(x[i], rd[k][i]) : x[i];
          tv.set(i, tv.get(i) + (xi > -FLT_MIN ? w : 0u - w));
        }
        tv.store(tp);
      }
      ring::fence_async();                    // the writes, to the store
      ring::consumers_sync(kConsumers);
      if (tid == 0) {
        ring::store(tally + (row0 + r) * n + c0, st + tally_at,
                    (uint32_t)len * sizeof(A));
        ring::commit();
        if (stored >= 0) {                    // the previous store has read
          ring::wait_read<1>();               // its stage: refill it
          ring::arrive(&empty[stored]);
        }
        stored = c.stage;
      }
    }
    c.advance(stages);
    if (++r == r1) {
      r = first_row;
      t += gridDim.x;
    }
  }
  if (tid == 0) ring::wait_read<0>();   // shared memory outlives the reads
}

template <typename T, typename A, bool kDelta>
int launch_t(const void* u, const void* delta, float rho, const void* weights,
             void* tally, int pods, int devices, int n, cudaStream_t stream) {
  constexpr int kChunkBytes = kTile * (int)(sizeof(T) + sizeof(A));
  const int target = kBlocksPerSm * ring::sm_count();
  int max_chunks = kMaxChunks;
  while (max_chunks > 1 && kRingBytes / (max_chunks * kChunkBytes) < kMinStages)
    max_chunks /= 2;
  const ring::Grid g =
      ring::persistent_grid(n, pods, kTile, max_chunks, target);
  const int stage_bytes = g.chunks * kChunkBytes;
  // Fewer tiles than the wave has blocks (the main path's 53248
  // coordinates): split each pod's rows over blockIdx.z, as sign_pack.
  const int groups_wanted = (target + g.gx * pods - 1) / (g.gx * pods);
  const int rows = (devices + groups_wanted - 1) / groups_wanted;
  const int groups = (devices + rows - 1) / rows;
  // no more stages than one block consumes, so short runs keep the
  // shared memory of a block small and more blocks fit on an SM
  const int n_tiles = (n + g.chunks * kTile - 1) / (g.chunks * kTile);
  const int most = (n_tiles + g.gx - 1) / g.gx * (rows + (kDelta ? 1 : 0));
  int stages = kRingBytes / stage_bytes;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages > most) stages = most;
  auto kernel = tally_acc_kernel<T, A, kDelta>;
  // Once per instance, the most any launch asks for (kRingBytes, above
  // the 48 KB a launch takes unasked); on the current card, as the port
  // drives one card per process (as sm_count does).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3((unsigned)g.gx, (unsigned)pods, (unsigned)groups),
           kTile / ring::Lane<T>::kVec + 32, stages * stage_bytes,
           stream>>>((const T*)u, (const T*)delta, rho,
                     (const int32_t*)weights, (A*)tally, devices, n,
                     g.chunks, stages, rows);
  return (int)cudaGetLastError();
}

template <typename T, typename A>
int launch(const void* u, const void* delta, float rho, const void* weights,
           void* tally, int pods, int devices, int n, cudaStream_t s) {
  return delta != nullptr
             ? launch_t<T, A, true>(u, delta, rho, weights, tally, pods,
                                    devices, n, s)
             : launch_t<T, A, false>(u, delta, rho, weights, tally, pods,
                                     devices, n, s);
}

template <typename T>
int launch_tally(const void* u, const void* delta, float rho,
                 const void* weights, void* tally, int tally_bytes, int pods,
                 int devices, int n, cudaStream_t s) {
  switch (tally_bytes) {
    case 1:
      return launch<T, int8_t>(u, delta, rho, weights, tally, pods, devices,
                               n, s);
    case 2:
      return launch<T, int16_t>(u, delta, rho, weights, tally, pods, devices,
                                n, s);
    case 4:
      return launch<T, int32_t>(u, delta, rho, weights, tally, pods, devices,
                                n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// u: [P, D, n] contiguous, f32 or (u_is_bf16) bf16; delta: [P, n] of u's
// type, or null; weights: [P, D] int32; tally: [P, D, n] signed integers
// of tally_bytes (1, 2 or 4) bytes, updated in place.  u, delta and tally
// 16-byte aligned and n % 128 == 0 (bulk copies of whole 16-byte runs of
// an int8 tally).  Returns cudaGetLastError() after the launch.
extern "C" int repro_tally_acc(const void* u, const void* delta, float rho,
                               const void* weights, void* tally,
                               int u_is_bf16, int tally_bytes, int pods,
                               int devices, int n, void* stream) {
  if (pods == 0 || devices == 0 || n == 0) return (int)cudaSuccess;
  if (n % 128 != 0 || ((uintptr_t)u & 15) != 0 ||
      ((uintptr_t)delta & 15) != 0 || ((uintptr_t)tally & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (u_is_bf16) {
    return launch_tally<__nv_bfloat16>(u, delta, rho, weights, tally,
                                       tally_bytes, pods, devices, n, s);
  }
  return launch_tally<float>(u, delta, rho, weights, tally, tally_bytes,
                             pods, devices, n, s);
}
