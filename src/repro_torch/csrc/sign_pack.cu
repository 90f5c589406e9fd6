// sign_pack: for every pod p, device d and word w,
//   words[p, d, w] = pack_{j<32} sgn(f32(u[p, d, i]) + rho*f32(delta[p, i])),
//   i = 32w + j
//
// Replaces the TPU kernel src/repro/kernels/sign_pack.py::sign_pack
// (_sign_pack_kernel), the device-side half of DC-HierSignSGD's fused
// transport: the DC-corrected sign of every voter coordinate, packed to
// one bit (bit j of word w is coordinate 32w + j; a set bit is +1).
//
// Bound on the H100: bytes.  Each coordinate is read once (4 B f32 or
// 2 B bf16), the correction once per pod (P*n, not P*D*n), and 1/8 B is
// written: P*D*n*sizeof(u) + P*n*sizeof(delta) + P*D*n/8 bytes at
// 3.35 TB/s.  There is no arithmetic worth counting.
//
// Design (Hopper).  The grid is (coordinate tiles, pods[, row groups]):
// blockIdx.y is the pod, and a block walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of its pod: one wave of two blocks per SM.
// A tile is 1, 2 or 4 chunks of 1024 coordinates (4 when the buffer is
// long enough, e.g. [4, 5, 2^22]: 4096 tiles for 264 blocks; 1 at the main
// path's [4, 5, 53248]).  A block has one producer warp and 8 (f32) or 4
// (bf16) consumer warps; for each tile it reads the pod's correction, then
// the D voter rows.  What the first design (one warp per word, a grid-
// stride loop over [P, D, n/32]) lost, and what this one does about it:
//   1. two 64-bit divides per lane and word to find (pod, row) for the
//      correction: offsets now come from blockIdx and the loop counters,
//      by multiplication; no lane divides;
//   2. the correction was read once per voter row (D times per pod): a
//      block reads its tile of delta[p] once, before the tile's rows, and
//      keeps rho*delta in registers for all D rows;
//   3. 4 B (f32) or 2 B (bf16) loads per lane: one lane of the producer
//      warp copies each row tile (4-16 KB) into a ring of shared-memory
//      stages (32 KB; cp.async.bulk completing on an mbarrier,
//      bulk_ring.cuh) and refills a stage as soon as the consumer warps
//      release it, so the copies never wait on the packing.  Each consumer
//      lane reads 16 B (4 f32 or 8 bf16 consecutive coordinates) from
//      shared memory; the 8 (f32) or 4 (bf16) lanes of a word OR their bits
//      together by shuffles, and consecutive lanes store the warp's words;
//   4. 4160 blocks of one coordinate per thread at the main shape: 1024-
//      coordinate chunks give 208 tiles there (>= 132 SMs); when the tiles
//      are fewer than the wave's blocks, blockIdx.z splits each pod's rows
//      (416 blocks at the main shape), and the correction's extra reads
//      come from L2.
// The first design's times, which this one replaces (chip_smoke.py on an
// H100 80GB HBM3 at a 700 W power limit):
// 0.006554 ms device at [4, 5, 53248] f32 with the correction; at
// [4, 5, 2^22] 0.3174 ms (f32) and 0.3597 ms (bf16) with the correction.
//
// Rounding: the reference adds rho*delta as a separate f32 multiply and
// add; __fmul_rn/__fadd_rn keep nvcc from contracting them into an FMA,
// which would move signs of coordinates near zero.  The bit is
// x > -FLT_MIN: -0.0 and negative subnormals give +1, as in the reference
// (XLA's CPU backend and the TPU flush subnormals to zero), NaN gives -1.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kTile = 1024;        // coordinates of one chunk
constexpr int kMaxChunks = 4;      // chunks of one row per stage
constexpr int kBlocksPerSm = 2;
constexpr int kRingBytes = 32 * 1024;
constexpr int kMaxStages = 16;     // kRingBytes over a one-chunk bf16 stage

// Each stage holds `chunks` x kTile coordinates of one row: of the
// correction (row -1, first of each tile when kDelta) or of voter row r.
template <typename T, bool kDelta>
__global__ void __launch_bounds__(kTile / ring::Lane<T>::kVec + 32)
    sign_pack_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                     float rho, int32_t* __restrict__ words, int devices,
                     int n, int chunks, int stages, int rows) {
  constexpr int V = ring::Lane<T>::kVec;
  constexpr int kConsumerWarps = kTile / V / 32;  // 8 (f32) or 4 (bf16)
  constexpr int kLanesPerWord = 32 / V;           // 8 (f32) or 4 (bf16)
  constexpr int kWordsPerWarp = 32 / kLanesPerWord;
  constexpr int kChunkBytes = kTile * (int)sizeof(T);
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
  const int stage_bytes = chunks * kChunkBytes;
  const int64_t n_words = n / 32;
  const T* u_pod = u + (int64_t)p * devices * n;
  const T* d_pod = kDelta ? delta + (int64_t)p * n : nullptr;
  int32_t* w_pod = words + (int64_t)p * devices * n_words;
  const int first_row = kDelta ? r0 - 1 : r0;     // r0 - 1: the correction

  // The producer warp's lane 0 sets up the ring and fills its first
  // stages before the block-wide barrier, so the copies are in flight
  // while the consumers start; it then refills each stage as it empties.
  ring::Cursor c;
  int t = blockIdx.x, r = first_row, j = 0;
  const bool producer = warp == kConsumerWarps && lane == 0;
  auto produce = [&](int until) {
    for (; j < until; ++j) {
      ring::wait(&empty[c.stage], c.parity ^ 1u);
      const int c0 = t * span;
      const uint32_t bytes = (uint32_t)min(span, n - c0) * sizeof(T);
      ring::expect(&full[c.stage], bytes);
      ring::load(smem + (size_t)c.stage * stage_bytes,
                 r < r0 ? d_pod + c0 : u_pod + (int64_t)r * n + c0, bytes,
                 &full[c.stage]);
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
      ring::init(&empty[s], kConsumerWarps);
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
  const int warp_c = warp * 32 * V;    // the warp's first coordinate
  for (int j = 0; j < total; ++j) {
    ring::wait(&full[c.stage], c.parity);
    const unsigned char* st = smem + (size_t)c.stage * stage_bytes;
    const int c0 = t * span;
    const int len = min(span, n - c0);
    uint4 raw[kMaxChunks];
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k)
      raw[k] = k < chunks && k * kTile + tid * V < len
                   ? reinterpret_cast<const uint4*>(st + k * kChunkBytes)[tid]
                   : make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
    if (lane == 0) ring::arrive(&empty[c.stage]);   // the stage is free

    if (kDelta && r < r0) {
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        float dv[V];
        ring::unpack(raw[k], dv);
#pragma unroll
        for (int i = 0; i < V; ++i) rd[k][i] = __fmul_rn(rho, dv[i]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        if (k >= chunks) continue;                    // uniform
        float x[V];
        ring::unpack(raw[k], x);
        unsigned bits = 0;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xi = kDelta ? __fadd_rn(x[i], rd[k][i]) : x[i];
          bits |= (unsigned)(xi > -FLT_MIN) << i;
        }
        // the lanes of one word OR their pieces together ...
        unsigned word = bits << (V * (lane % kLanesPerWord));
#pragma unroll
        for (int o = 1; o < kLanesPerWord; o <<= 1)
          word |= __shfl_xor_sync(0xffffffffu, word, o);
        // ... and lane i < kWordsPerWarp stores the warp's i-th word
        const unsigned mine =
            __shfl_sync(0xffffffffu, word, (lane * kLanesPerWord) & 31);
        const int wc = k * kTile + warp_c + lane * 32;
        if (lane < kWordsPerWarp && wc < len)
          w_pod[r * n_words + (c0 + wc) / 32] = (int32_t)mine;
      }
    }
    c.advance(stages);
    if (++r == r1) {
      r = first_row;
      t += gridDim.x;
    }
  }
}

template <typename T, bool kDelta>
int launch_t(const void* u, const void* delta, float rho, void* words,
             int pods, int devices, int n, cudaStream_t stream) {
  const int target = kBlocksPerSm * ring::sm_count();
  const ring::Grid g =
      ring::persistent_grid(n, pods, kTile, kMaxChunks, target);
  const int stage_bytes = g.chunks * kTile * (int)sizeof(T);
  int stages = kRingBytes / stage_bytes;
  if (stages > kMaxStages) stages = kMaxStages;
  // at most kRingBytes: below the 48 KB of dynamic shared memory a launch
  // may take without raising cudaFuncAttributeMaxDynamicSharedMemorySize
  const int smem = stages * stage_bytes;
  // Fewer tiles than the wave has blocks (the main path's 53248
  // coordinates, or many voters on a short buffer): split each pod's rows
  // over blockIdx.z; the correction is then read once per group, from L2
  // after the first.
  const int groups_wanted = (target + g.gx * pods - 1) / (g.gx * pods);
  const int rows = (devices + groups_wanted - 1) / groups_wanted;
  const int groups = (devices + rows - 1) / rows;
  sign_pack_kernel<T, kDelta>
      <<<dim3((unsigned)g.gx, (unsigned)pods, (unsigned)groups),
         kTile / ring::Lane<T>::kVec + 32, smem, stream>>>(
      (const T*)u, (const T*)delta, rho, (int32_t*)words, devices, n,
      g.chunks, stages, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* u, const void* delta, float rho, void* words,
           int pods, int devices, int n_words, void* stream) {
  if ((int64_t)pods * devices * n_words == 0) return (int)cudaSuccess;
  // bulk copies move 16-byte-aligned runs of whole 128-coordinate blocks
  if (n_words % 4 != 0 || ((uintptr_t)u & 15) != 0 ||
      ((uintptr_t)delta & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = n_words * 32;
  return delta != nullptr
             ? launch_t<T, true>(u, delta, rho, words, pods, devices, n, s)
             : launch_t<T, false>(u, delta, rho, words, pods, devices, n, s);
}

}  // namespace

// u: [P, D, 32 * n_words] contiguous, 16-byte aligned; delta: [P, 32 *
// n_words] (16-byte aligned) or null; words: [P, D, n_words] int32;
// n_words % 4 == 0.  Returns cudaGetLastError() after the launch.
extern "C" int repro_sign_pack_f32(const void* u, const void* delta,
                                   float rho, void* words, int pods,
                                   int devices, int n_words, void* stream) {
  return launch<float>(u, delta, rho, words, pods, devices, n_words, stream);
}

extern "C" int repro_sign_pack_bf16(const void* u, const void* delta,
                                    float rho, void* words, int pods,
                                    int devices, int n_words, void* stream) {
  return launch<__nv_bfloat16>(u, delta, rho, words, pods, devices, n_words,
                               stream);
}
