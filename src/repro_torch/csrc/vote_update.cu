// vote_update: per pod p and coordinate i,
//   pos   = sum_k w[p, k] * bit(words[p, k], i)          (int32)
//   n_eff = sum_k w[p, k]                 (D when no weights are given)
//   vote  = 2 * pos >= n_eff ? +1 : -1   (0 if weights are given, n_eff <= 0)
//   v[p, i] <- flush(flush(v[p, i]) - flush(mu) * vote)   (in place),
//   or vote_out[p, i] = vote
//
// Replaces the TPU kernel src/repro/kernels/vote_update.py::vote_update
// (_vote_update_kernel), the edge-side half of the fused transport: the
// weighted popcount majority vote over the D voters' one-bit payloads and
// the sign-descent read-modify-write of the edge model.  Like the TPU
// kernel's input_output_aliases={1: 0}, v is updated in place.
//
// Bound on the H100: bytes.  The packed words are read once
// (P*D*n/8 bytes) and v is read and written once (2*P*n*4 bytes; the
// vote-only form writes P*n int8 instead), at 3.35 TB/s.
//
// Design (Hopper).  The grid is (coordinate tiles, pods): a block owns
// tiles of one pod (blockIdx.y), walking blockIdx.x, blockIdx.x +
// gridDim.x, ... -- one wave of four blocks per SM.  A tile is 1, 2 or 4
// chunks of 1024 coordinates (up to 8 in the bit-sliced vote form below):
// 4 at [4, 5, 2^22], 1 at the main path's [4, 5, 53248] (208 blocks).  A
// block has one producer warp and 8 consumer warps.  What the first
// design (one thread per coordinate, 65,536 blocks at 2^22) lost, and
// what this one does about it:
//   - every thread reloaded the D words and D weights and recomputed
//     n_eff per coordinate: warp 0 lists the pod's voters of non-zero
//     weight (word offsets and weights, compacted by a ballot) and n_eff
//     once per block, while the producer warp already copies.  The
//     producer's lanes copy a tile's D word rows (128 B per chunk each)
//     and its v tile (4 KB per chunk) at once into a ring of shared-memory
//     stages (up to 16, 32 KB; cp.async.bulk on an mbarrier,
//     bulk_ring.cuh), refilling a stage as soon as the consumers release
//     it;
//   - v moved 4 B per lane: each consumer lane owns 4 consecutive
//     coordinates per chunk, takes their 4 bits of a word at once, reads
//     v from shared memory and writes it back as one 16-byte vector.
//     Without integer weights and with at most 127 voters the 4 counts
//     are byte counters in one register ((nibble * 0x00204081) &
//     0x01010101), compared with ceil(n_eff / 2) in one subtraction;
//     otherwise four int32 counters add each listed voter's weight;
//   - the vote-only form wrote 1 B per lane and was bound by
//     instructions: without integer weights a lane owns a whole word (32
//     coordinates), counts its voters bit-sliced (plane b holds bit b of
//     the 32 counts; 3 planes up to 7 voters, else 10) and stores its 32
//     int8 votes as two 16-byte vectors; with integer weights four
//     lanes' votes are gathered by shuffles into one 16-byte store.
// The first design's times, which this one replaces (chip_smoke.py on an
// H100 80GB HBM3 at a 700 W power limit):
// 0.003507 ms device at [4, 5, 53248] with the all-voters bool mask; at
// [4, 5, 2^22] 0.1305 ms (update, bool mask), 0.1499 ms (update, integer
// weights) and 0.0964 ms (vote only, bool mask).
//
// Arithmetic: the int32 tally with the reference's tie rule (ties -> +1)
// and empty-quorum rule (vote 0).  __fmul_rn/__fsub_rn keep the update a
// separate f32 multiply and subtract, as in the reference, whose eager
// XLA CPU ops (and the TPU) treat a subnormal operand as zero and flush a
// subnormal result to a zero of its sign: flush() below does both, so an
// abstaining pod's subnormal coordinates become signed zeros.
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kTile = 1024;                // coordinates of one chunk
constexpr int kConsumers = kTile / 4;      // 4 coordinates a lane
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kChunkWords = kTile / 32;    // 128 B per voter and chunk
constexpr int kMaxChunks = 4;              // chunks a stage holds, or
constexpr int kMaxWordChunks = 8;          // in the bit-sliced vote form
constexpr int kBlocksPerSm = 4;
constexpr int kRingBytes = 32 * 1024;      // stages while they fit
constexpr int kMaxRingBytes = 192 * 1024;  // two stages at the most voters
constexpr int kMaxStages = 16;
constexpr int kMaxVoters = 512;

enum WeightKind { kNone = 0, kBool = 1, kInt = 2 };

// a subnormal float -> the zero of its sign (XLA's flush); others unchanged
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? __int_as_float(__float_as_int(x) & 0x80000000)
                            : x;
}

__host__ __device__ __forceinline__ int stage_bytes_of(bool update,
                                                       int devices,
                                                       int chunks) {
  return chunks * (devices * kChunkWords * 4 + (update ? kTile * 4 : 0));
}

// Bit-sliced count of one word's 32 coordinates over the listed voters:
// plane b holds bit b of the 32 counts (kPlanes bits hold n_list).
// Returns the bits j whose count is >= thr (compared MSB first).
template <int kPlanes>
__device__ __forceinline__ uint32_t count_at_least(const uint32_t* w,
                                                   const int32_t* offs,
                                                   bool listed, int row_words,
                                                   int n_list, uint32_t thr) {
  uint32_t plane[kPlanes];
#pragma unroll
  for (int b = 0; b < kPlanes; ++b) plane[b] = 0;
#pragma unroll 2
  for (int i = 0; i < n_list; ++i) {
    uint32_t carry = w[listed ? offs[i] : i * row_words];
#pragma unroll
    for (int b = 0; b < kPlanes; ++b) {
      const uint32_t next = plane[b] & carry;
      plane[b] ^= carry;
      carry = next;
    }
  }
  uint32_t gt = 0, eq = 0xffffffffu;
#pragma unroll
  for (int b = kPlanes - 1; b >= 0; --b) {
    if ((thr >> b) & 1u) {
      eq &= plane[b];
    } else {
      gt |= eq & plane[b];
      eq &= ~plane[b];
    }
  }
  return gt | eq;
}

// The pod's voters with a non-zero weight, compacted by warp 0 before the
// main loop: their word offsets in a stage and weights, how many there
// are, and n_eff (D without weights, else the sum of the weights, int32
// with wrap-around as in the reference).
__device__ __forceinline__ void list_voters(int kw, const void* weights,
                                            int p, int devices, int row_words,
                                            int32_t* offs, int32_t* wts,
                                            int* n_list, int32_t* n_eff) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  uint32_t sum = 0;
  for (int k0 = 0; k0 < devices; k0 += 32) {
    const int k = k0 + lane;
    int32_t wk = 0;
    if (k < devices)
      wk = kw == kNone   ? 1
           : kw == kBool ? (int32_t)((const uint8_t*)weights)[p * devices + k]
                         : ((const int32_t*)weights)[(int64_t)p * devices + k];
    const unsigned live = __ballot_sync(0xffffffffu, wk != 0);
    if (wk != 0) {
      const int at = base + __popc(live & ((1u << lane) - 1u));
      offs[at] = k * row_words;
      wts[at] = wk;
    }
    base += __popc(live);
    uint32_t s = (uint32_t)wk;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    sum += s;
  }
  if (lane == 0) {
    *n_list = base;
    *n_eff = (int32_t)sum;
  }
}

// Each stage holds, for `chunks` x kTile coordinates of the pod, the D
// voters' words (voter k at k * chunks * kChunkWords) and, for the update,
// the coordinates of v.
template <bool kUpdate, int kW>
__global__ void __launch_bounds__(kConsumers + 32)
    vote_update_kernel(const int32_t* __restrict__ words,
                       const void* __restrict__ weights,
                       float* __restrict__ v, int8_t* __restrict__ vote_out,
                       float mu, int devices, int n, int chunks, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int n_list_shared;
  __shared__ int32_t n_eff_shared;
  const int row_words = chunks * kChunkWords;    // one voter, one stage
  const int words_bytes = devices * row_words * 4;
  const int stage_bytes = stage_bytes_of(kUpdate, devices, chunks);
  int32_t* offs =
      reinterpret_cast<int32_t*>(smem + (size_t)stages * stage_bytes);
  int32_t* wts = offs + devices;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.y;
  const int span = chunks * kTile;
  const int n_words = n / 32;
  const int n_tiles = (n + span - 1) / span;
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int32_t* w_pod = words + (int64_t)p * devices * n_words;
  float* v_pod = kUpdate ? v + (int64_t)p * n : nullptr;

  // The producer warp sets up the ring and fills its first stages while
  // warp 0 lists the voters; after the block-wide barrier it refills each
  // stage as it empties.  Its lanes issue the stage's copies at once.
  ring::Cursor c;
  int t = blockIdx.x, j = 0;
  auto produce = [&](int until) {
    for (; j < until; ++j) {
      const int c0 = t * span;
      const int len = min(span, n - c0);
      unsigned char* dst = smem + (size_t)c.stage * stage_bytes;
      if (lane == 0) {
        ring::wait(&empty[c.stage], c.parity ^ 1u);
        ring::expect(&full[c.stage], (uint32_t)(devices * (len / 8) +
                                                (kUpdate ? len * 4 : 0)));
      }
      __syncwarp();
      for (int k = lane; k < devices; k += 32)
        ring::load(dst + k * row_words * 4,
                   w_pod + (int64_t)k * n_words + c0 / 32,
                   (uint32_t)(len / 8), &full[c.stage]);
      if (kUpdate && lane == 31)
        ring::load(dst + words_bytes, v_pod + c0, (uint32_t)(len * 4),
                   &full[c.stage]);
      c.advance(stages);
      t += gridDim.x;
    }
  };
  if (warp == kConsumerWarps) {
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) {
        ring::init(&full[s], 1);
        ring::init(&empty[s], kConsumerWarps);
      }
      ring::fence_init();
    }
    __syncwarp();
    produce(min(stages, my_tiles));   // fresh stages: no wait
  } else if (warp == 0) {
    list_voters(kW, weights, p, devices, row_words, offs, wts,
                &n_list_shared, &n_eff_shared);
  }
  __syncthreads();
  if (warp == kConsumerWarps) {
    produce(my_tiles);
    return;
  }

  const int n_list = n_list_shared;
  const int32_t n_eff = n_eff_shared;
  const bool abstain = kW != kNone && !(n_eff > 0);
  // unit weights and at most 127 voters: four byte counters compare with
  // ceil(n_eff / 2) at once ((c | 0x80) - thr keeps bit 7 iff c >= thr)
  const bool bytewise = kW != kInt && n_list <= 127;
  const uint32_t thr4 = (uint32_t)((n_eff + 1) >> 1) * 0x01010101u;
  if constexpr (!kUpdate && kW != kInt) {
    // Vote form, unit weights: a lane owns one word (32 coordinates) of
    // the tile, counts it bit-sliced and stores its 32 int8 votes.
    const bool listed = kW == kBool;
    const int my_word = tid;               // of chunks * kChunkWords
    for (int jc = 0; jc < my_tiles; ++jc) {
      ring::wait(&full[c.stage], c.parity);
      const uint32_t* wsm = reinterpret_cast<const uint32_t*>(
          smem + (size_t)c.stage * stage_bytes) + my_word;
      const int c0 = t * span;
      const bool active = my_word < chunks * kChunkWords &&
                          my_word * 32 < min(span, n - c0);
      const uint32_t thr = (uint32_t)(n_eff + 1) >> 1;
      uint32_t plus = 0;
      if (active)
        plus = n_list <= 7 ? count_at_least<3>(wsm, offs, listed, row_words,
                                                n_list, thr)
                           : count_at_least<10>(wsm, offs, listed, row_words,
                                                n_list, thr);
      __syncwarp();
      if (lane == 0) ring::arrive(&empty[c.stage]);   // the stage is free
      if (active) {
        uint32_t out[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) {  // 4 votes a register: +1 / -1 bytes
          const uint32_t one =
              (((plus >> (4 * b)) & 0xfu) * 0x00204081u) & 0x01010101u;
          out[b] = abstain ? 0u : one | ((one ^ 0x01010101u) * 0xffu);
        }
        uint4* dst = reinterpret_cast<uint4*>(vote_out + (int64_t)p * n + c0 +
                                              my_word * 32);
        dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
        dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
      }
      c.advance(stages);
      t += gridDim.x;
    }
    return;
  }

  const float mu_f = flush(mu);
  const int tw = tid >> 3;                 // this lane's word in a chunk
  const int sh = 4 * (tid & 7);            // and its 4 bits in that word
  for (int jc = 0; jc < my_tiles; ++jc) {
    ring::wait(&full[c.stage], c.parity);
    const unsigned char* st = smem + (size_t)c.stage * stage_bytes;
    const uint32_t* wsm = reinterpret_cast<const uint32_t*>(st);
    const int c0 = t * span;
    const int len = min(span, n - c0);

    uint32_t votes[kMaxChunks];   // four int8 votes (+1, -1 or 0) per chunk
    float4 vv[kMaxChunks];
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) {
      votes[q] = 0;
      vv[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q >= chunks) continue;                       // uniform
      const uint32_t* wq = wsm + q * kChunkWords + tw;
      if (bytewise) {
        uint32_t acc = 0;
#pragma unroll 4
        for (int i = 0; i < n_list; ++i) {
          const int off = kW == kNone ? i * row_words : offs[i];
          acc += (((wq[off] >> sh) & 0xfu) * 0x00204081u) & 0x01010101u;
        }
        const uint32_t plus = (((acc | 0x80808080u) - thr4) >> 7) &
                              0x01010101u;             // 1 where c >= thr
        votes[q] = plus | ((plus ^ 0x01010101u) * 0xffu);
      } else {                 // integer weights, or > 127 unit weights
        int32_t pos[4] = {0, 0, 0, 0};
        for (int i = 0; i < n_list; ++i) {
          const uint32_t nib = wq[offs[i]] >> sh;
          const int32_t wk = wts[i];
#pragma unroll
          for (int b = 0; b < 4; ++b) pos[b] += ((nib >> b) & 1u) ? wk : 0;
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          // 2 * pos with int32 wrap-around, as the reference's int32 tally
          const int32_t twice = (int32_t)((uint32_t)pos[b] << 1);
          votes[q] |= (twice >= n_eff ? 0x01u : 0xffu) << (8 * b);
        }
      }
      if (abstain) votes[q] = 0;
      if (kUpdate && q * kTile + tid * 4 < len)
        vv[q] = reinterpret_cast<const float4*>(st + words_bytes)
            [q * kConsumers + tid];
    }
    __syncwarp();
    if (lane == 0) ring::arrive(&empty[c.stage]);     // the stage is free

#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) {
      if (q >= chunks) continue;                       // uniform
      const int i = c0 + q * kTile + tid * 4;        // first coordinate
      const bool active = q * kTile + tid * 4 < len;
      if (kUpdate) {
        if (active) {
          const float in[4] = {vv[q].x, vv[q].y, vv[q].z, vv[q].w};
          float out[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float vote = (float)(int8_t)(votes[q] >> (8 * b));
            out[b] = flush(__fsub_rn(flush(in[b]), __fmul_rn(mu_f, vote)));
          }
          *reinterpret_cast<float4*>(v_pod + i) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      } else {
        const uint32_t a1 = __shfl_down_sync(0xffffffffu, votes[q], 1);
        const uint32_t a2 = __shfl_down_sync(0xffffffffu, votes[q], 2);
        const uint32_t a3 = __shfl_down_sync(0xffffffffu, votes[q], 3);
        if ((lane & 3) == 0 && active)
          *reinterpret_cast<uint4*>(vote_out + (int64_t)p * n + i) =
              make_uint4(votes[q], a1, a2, a3);
      }
    }
    c.advance(stages);
    t += gridDim.x;
  }
}

template <bool kUpdate, int kW>
int launch_t(const void* words, const void* weights, void* v, void* vote_out,
             float mu, int pods, int devices, int n, cudaStream_t stream) {
  // two stages must fit, whatever D is
  int max_chunks = !kUpdate && kW != kInt ? kMaxWordChunks : kMaxChunks;
  while (max_chunks > 1 &&
         2 * stage_bytes_of(kUpdate, devices, max_chunks) > kMaxRingBytes)
    max_chunks /= 2;
  const ring::Grid g = ring::persistent_grid(
      n, pods, kTile, max_chunks, kBlocksPerSm * ring::sm_count());
  const int stage_bytes = stage_bytes_of(kUpdate, devices, g.chunks);
  int stages = kRingBytes / stage_bytes;
  stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
  const int smem = stages * stage_bytes + devices * 8;   // + voter list
  auto kernel = vote_update_kernel<kUpdate, kW>;
  // Once per instance, the most any launch above asks for (two stages of
  // at most kMaxRingBytes, and the list of kMaxVoters): on the current
  // card, as the port drives one card per process (as sm_count does).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxRingBytes + kMaxVoters * 8);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3((unsigned)g.gx, (unsigned)pods), kConsumers + 32, smem,
           stream>>>((const int32_t*)words, weights, (float*)v,
                     (int8_t*)vote_out, mu, devices, n, g.chunks, stages);
  return (int)cudaGetLastError();
}

template <bool kUpdate>
int launch(const void* words, const void* weights, int weights_are_bool,
           void* v, void* vote_out, float mu, int pods, int devices, int n,
           cudaStream_t s) {
  if (weights == nullptr)
    return launch_t<kUpdate, kNone>(words, weights, v, vote_out, mu, pods,
                                    devices, n, s);
  if (weights_are_bool)
    return launch_t<kUpdate, kBool>(words, weights, v, vote_out, mu, pods,
                                    devices, n, s);
  return launch_t<kUpdate, kInt>(words, weights, v, vote_out, mu, pods,
                                 devices, n, s);
}

}  // namespace

// words: [P, D, n_words] int32, 16-byte aligned, n_words % 4 == 0,
// 1 <= D <= 512; weights: [P, D] or null, int32 or, with
// weights_are_bool, one byte each (a bool mask, read without a cast
// kernel); exactly one of v ([P, 32 * n_words] f32, 16-byte aligned,
// updated in place) and vote_out ([P, 32 * n_words] int8, 16-byte
// aligned) is non-null.  Returns cudaGetLastError() after the launch.
extern "C" int repro_vote_update(const void* words, const void* weights,
                                 int weights_are_bool, void* v,
                                 void* vote_out, float mu, int pods,
                                 int devices, int n_words, void* stream) {
  if (pods == 0 || n_words == 0) return (int)cudaSuccess;
  if ((v == nullptr) == (vote_out == nullptr) || devices < 1 ||
      devices > kMaxVoters || n_words % 4 != 0 ||
      ((uintptr_t)words & 15) != 0 || ((uintptr_t)v & 15) != 0 ||
      ((uintptr_t)vote_out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = n_words * 32;
  return v != nullptr ? launch<true>(words, weights, weights_are_bool, v,
                                     nullptr, mu, pods, devices, n, s)
                      : launch<false>(words, weights, weights_are_bool,
                                      nullptr, vote_out, mu, pods, devices, n,
                                      s);
}
