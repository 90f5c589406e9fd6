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
// Any D: a stage holds the words of at most kGroup = 512 voters (two
// stages of them and the voter list fit in shared memory).  With more
// voters (merged clients, D*K > 512) the kernel counts over voter
// groups, one group per stage, stage after stage: the producer warp
// lists each group's voters of non-zero weight (a ballot over the
// group's weights) and their weight sum into the group's stage as it
// fills it, so shared memory does not grow with D; each consumer lane
// keeps its four int32 counters in registers across the groups of a
// tile, sums n_eff over the groups, and applies the threshold and the
// update or vote store after the last group (whose stage also carries
// the v tile).  The grouped form always counts in int32 (the bit-sliced
// planes hold at most 1023 voters), with the same tie and empty-quorum
// rules.  D <= 512 keeps the one-pass paths above.
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
constexpr int kGroup = 512;                // the most voters a stage holds

enum WeightKind { kNone = 0, kBool = 1, kInt = 2 };

// a subnormal float -> the zero of its sign (XLA's flush); others unchanged
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? __int_as_float(__float_as_int(x) & 0x80000000)
                            : x;
}

// A stage of `voters` voters' words (and v's tile for the update); in
// the grouped form it also carries the group's voter list: word offsets
// and weights of `voters` entries, then its length and weight sum, padded
// to 16 bytes so that the next stage stays 16-byte aligned.
__host__ __device__ __forceinline__ int stage_bytes_of(bool update,
                                                       int voters,
                                                       int chunks,
                                                       bool grouped) {
  return chunks * (voters * kChunkWords * 4 + (update ? kTile * 4 : 0)) +
         (grouped ? (voters * 8 + 8 + 15) / 16 * 16 : 0);
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

// Voters k0 .. k0 + count - 1 of the pod with a non-zero weight,
// compacted by one warp: their word offsets in a stage (voter k0 + i at
// i * row_words) and weights, then in meta[0] how many there are and in
// meta[1] the sum of their weights (count without weights; int32 with
// wrap-around as in the reference).  Warp 0 lists all D voters once
// before the main loop; in the grouped form the producer warp lists each
// group into its stage.
__device__ __forceinline__ void list_voters(int kw, const void* weights,
                                            int p, int devices, int k0,
                                            int count, int row_words,
                                            int32_t* offs, int32_t* wts,
                                            int32_t* meta) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  uint32_t sum = 0;
  for (int i0 = 0; i0 < count; i0 += 32) {
    const int i = i0 + lane;
    const int64_t k = (int64_t)p * devices + k0 + i;
    int32_t wk = 0;
    if (i < count)
      wk = kw == kNone   ? 1
           : kw == kBool ? (int32_t)((const uint8_t*)weights)[k]
                         : ((const int32_t*)weights)[k];
    const unsigned live = __ballot_sync(0xffffffffu, wk != 0);
    if (wk != 0) {
      const int at = base + __popc(live & ((1u << lane) - 1u));
      offs[at] = i * row_words;
      wts[at] = wk;
    }
    base += __popc(live);
    uint32_t s = (uint32_t)wk;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    sum += s;
  }
  if (lane == 0) {
    meta[0] = base;
    meta[1] = (int32_t)sum;
  }
}

// Adds each listed voter's weight to the four int32 counts of this lane's
// coordinates (bits sh .. sh + 3 of its word; wq is the word of voter 0).
__device__ __forceinline__ void count_weights(const uint32_t* wq,
                                              const int32_t* offs,
                                              const int32_t* wts, int n_list,
                                              int sh, int32_t (&pos)[4]) {
  for (int i = 0; i < n_list; ++i) {
    const uint32_t nib = wq[offs[i]] >> sh;
    const int32_t wk = wts[i];
#pragma unroll
    for (int b = 0; b < 4; ++b) pos[b] += ((nib >> b) & 1u) ? wk : 0;
  }
}

// Four int8 votes (+1 or -1 bytes) from four int32 counts.
__device__ __forceinline__ uint32_t votes_of(const int32_t (&pos)[4],
                                             int32_t n_eff) {
  uint32_t votes = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    // 2 * pos with int32 wrap-around, as the reference's int32 tally
    const int32_t twice = (int32_t)((uint32_t)pos[b] << 1);
    votes |= (twice >= n_eff ? 0x01u : 0xffu) << (8 * b);
  }
  return votes;
}

// A tile's end, once its votes are known: v <- v - mu * vote on this
// lane's four coordinates of each chunk (vv: their v, from the stage), or
// the vote store, four lanes' votes gathered into one 16-byte vector.
template <bool kUpdate>
__device__ __forceinline__ void finish_tile(
    const uint32_t (&votes)[kMaxChunks], const float4 (&vv)[kMaxChunks],
    int chunks, int c0, int len, float mu_f, float* v_pod,
    int8_t* vote_pod) {
  const int tid = threadIdx.x, lane = tid & 31;
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
        *reinterpret_cast<uint4*>(vote_pod + i) =
            make_uint4(votes[q], a1, a2, a3);
    }
  }
}

// Each stage holds, for `chunks` x kTile coordinates of the pod, the
// words of `voters` voters (voter k at k * chunks * kChunkWords; all D
// unless kGrouped, else one group of them and its voter list) and, for
// the update, the coordinates of v (in the grouped form, in a tile's last
// group's stage).
template <bool kUpdate, int kW, bool kGrouped>
__global__ void __launch_bounds__(kConsumers + 32)
    vote_update_kernel(const int32_t* __restrict__ words,
                       const void* __restrict__ weights,
                       float* __restrict__ v, int8_t* __restrict__ vote_out,
                       float mu, int devices, int n, int chunks, int stages,
                       int group_voters) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int32_t meta_shared[2];              // n_list, n_eff
  const int voters = kGrouped ? group_voters : devices;    // of a stage
  const int groups = kGrouped ? (devices + voters - 1) / voters : 1;
  const int row_words = chunks * kChunkWords;    // one voter, one stage
  const int words_bytes = voters * row_words * 4;
  const int list_at = words_bytes + (kUpdate ? chunks * kTile * 4 : 0);
  const int stage_bytes = stage_bytes_of(kUpdate, voters, chunks, kGrouped);
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
  int8_t* vote_pod = kUpdate ? nullptr : vote_out + (int64_t)p * n;

  // The producer warp sets up the ring and fills its first stages while
  // warp 0 lists the voters; after the block-wide barrier it refills each
  // stage as it empties.  Its lanes issue the stage's copies at once.
  // In the grouped form it first lists the stage's group of voters into
  // the stage (its writes reach the consumers through the "full"
  // barrier, which lane 0's arrival releases after the warp's __syncwarp).
  ring::Cursor c;
  int t = blockIdx.x, g = 0, j = 0;
  auto produce = [&](int until) {
    for (; j < until; ++j) {
      const int c0 = t * span;
      const int len = min(span, n - c0);
      const int k0 = g * voters;                 // the group's voters
      const int count = min(voters, devices - k0);
      const bool with_v = kUpdate && g == groups - 1;
      unsigned char* dst = smem + (size_t)c.stage * stage_bytes;
      const uint32_t bytes = count * (len / 8) + (with_v ? len * 4 : 0);
      if (lane == 0) {
        ring::wait(&empty[c.stage], c.parity ^ 1u);
        if (!kGrouped) ring::expect(&full[c.stage], bytes);
      }
      __syncwarp();
      if constexpr (kGrouped) {
        int32_t* lst = reinterpret_cast<int32_t*>(dst + list_at);
        list_voters(kW, weights, p, devices, k0, count, row_words, lst,
                    lst + voters, lst + 2 * voters);
        __syncwarp();
        if (lane == 0) ring::expect(&full[c.stage], bytes);
        __syncwarp();
      }
      for (int k = lane; k < count; k += 32)
        ring::load(dst + k * row_words * 4,
                   w_pod + (int64_t)(k0 + k) * n_words + c0 / 32,
                   (uint32_t)(len / 8), &full[c.stage]);
      if (with_v && lane == 31)
        ring::load(dst + words_bytes, v_pod + c0, (uint32_t)(len * 4),
                   &full[c.stage]);
      c.advance(stages);
      if (++g == groups) {
        g = 0;
        t += gridDim.x;
      }
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
    produce(min(stages, my_tiles * groups));   // fresh stages: no wait
  } else if (warp == 0 && !kGrouped) {
    list_voters(kW, weights, p, devices, 0, devices, row_words, offs, wts,
                meta_shared);
  }
  __syncthreads();
  if (warp == kConsumerWarps) {
    produce(my_tiles * groups);
    return;
  }

  const float mu_f = flush(mu);
  const int tw = tid >> 3;                 // this lane's word in a chunk
  const int sh = 4 * (tid & 7);            // and its 4 bits in that word
  if constexpr (kGrouped) {
    // Counts over the groups of each tile, then the tile's votes.
    for (int jc = 0; jc < my_tiles; ++jc) {
      int32_t pos[kMaxChunks][4];
      float4 vv[kMaxChunks];
#pragma unroll
      for (int q = 0; q < kMaxChunks; ++q) {
        vv[q] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int b = 0; b < 4; ++b) pos[q][b] = 0;
      }
      uint32_t n_eff = 0;
      const int c0 = t * span;
      const int len = min(span, n - c0);
      for (int gi = 0; gi < groups; ++gi) {
        ring::wait(&full[c.stage], c.parity);
        const unsigned char* st = smem + (size_t)c.stage * stage_bytes;
        const int32_t* lst = reinterpret_cast<const int32_t*>(st + list_at);
        const int n_list = lst[2 * voters];
        n_eff += (uint32_t)lst[2 * voters + 1];
#pragma unroll
        for (int q = 0; q < kMaxChunks; ++q) {
          if (q >= chunks) continue;                   // uniform
          count_weights(reinterpret_cast<const uint32_t*>(st) +
                            q * kChunkWords + tw,
                        lst, lst + voters, n_list, sh, pos[q]);
          if (kUpdate && gi == groups - 1 && q * kTile + tid * 4 < len)
            vv[q] = reinterpret_cast<const float4*>(st + words_bytes)
                [q * kConsumers + tid];
        }
        __syncwarp();
        if (lane == 0) ring::arrive(&empty[c.stage]);  // the stage is free
        c.advance(stages);
      }
      const bool abstain = kW != kNone && !((int32_t)n_eff > 0);
      uint32_t votes[kMaxChunks];
#pragma unroll
      for (int q = 0; q < kMaxChunks; ++q)
        votes[q] = abstain ? 0u : votes_of(pos[q], (int32_t)n_eff);
      finish_tile<kUpdate>(votes, vv, chunks, c0, len, mu_f, v_pod,
                           vote_pod);
      t += gridDim.x;
    }
    return;
  }

  const int n_list = meta_shared[0];
  const int32_t n_eff = meta_shared[1];
  const bool abstain = kW != kNone && !(n_eff > 0);
  // unit weights and at most 127 voters: four byte counters compare with
  // ceil(n_eff / 2) at once ((c | 0x80) - thr keeps bit 7 iff c >= thr)
  const bool bytewise = kW != kInt && n_list <= 127;
  const uint32_t thr4 = (uint32_t)((n_eff + 1) >> 1) * 0x01010101u;
  if constexpr (!kUpdate && kW != kInt && !kGrouped) {
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
        uint4* dst = reinterpret_cast<uint4*>(vote_pod + c0 + my_word * 32);
        dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
        dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
      }
      c.advance(stages);
      t += gridDim.x;
    }
    return;
  }

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
        count_weights(wq, offs, wts, n_list, sh, pos);
        votes[q] = votes_of(pos, n_eff);
      }
      if (abstain) votes[q] = 0;
      if (kUpdate && q * kTile + tid * 4 < len)
        vv[q] = reinterpret_cast<const float4*>(st + words_bytes)
            [q * kConsumers + tid];
    }
    __syncwarp();
    if (lane == 0) ring::arrive(&empty[c.stage]);     // the stage is free
    finish_tile<kUpdate>(votes, vv, chunks, c0, len, mu_f, v_pod, vote_pod);
    c.advance(stages);
    t += gridDim.x;
  }
}

template <bool kUpdate, int kW, bool kGrouped>
int launch_t(const void* words, const void* weights, void* v, void* vote_out,
             float mu, int pods, int devices, int n, cudaStream_t stream) {
  // the voters of a stage: all D, or D split into groups of at most
  // kGroup that differ by at most one voter
  const int groups = kGrouped ? (devices + kGroup - 1) / kGroup : 1;
  const int voters = (devices + groups - 1) / groups;
  // two stages must fit, whatever D is
  int max_chunks =
      !kUpdate && kW != kInt && !kGrouped ? kMaxWordChunks : kMaxChunks;
  while (max_chunks > 1 &&
         2 * stage_bytes_of(kUpdate, voters, max_chunks, kGrouped) >
             kMaxRingBytes)
    max_chunks /= 2;
  const ring::Grid g = ring::persistent_grid(
      n, pods, kTile, max_chunks, kBlocksPerSm * ring::sm_count());
  const int stage_bytes = stage_bytes_of(kUpdate, voters, g.chunks, kGrouped);
  int stages = kRingBytes / stage_bytes;
  stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
  // + the block's voter list, unless each stage carries its group's
  const int smem = stages * stage_bytes + (kGrouped ? 0 : devices * 8);
  auto kernel = vote_update_kernel<kUpdate, kW, kGrouped>;
  // Once per instance, the most any launch above asks for (two stages of
  // at most kMaxRingBytes, and the block's list of at most kGroup voters):
  // on the current card, as the port drives one card per process (as
  // sm_count does).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxRingBytes + kGroup * 8);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3((unsigned)g.gx, (unsigned)pods), kConsumers + 32, smem,
           stream>>>((const int32_t*)words, weights, (float*)v,
                     (int8_t*)vote_out, mu, devices, n, g.chunks, stages,
                     voters);
  return (int)cudaGetLastError();
}

template <bool kUpdate, int kW>
int launch_w(const void* words, const void* weights, void* v, void* vote_out,
             float mu, int pods, int devices, int n, cudaStream_t s) {
  return devices > kGroup
             ? launch_t<kUpdate, kW, true>(words, weights, v, vote_out, mu,
                                           pods, devices, n, s)
             : launch_t<kUpdate, kW, false>(words, weights, v, vote_out, mu,
                                            pods, devices, n, s);
}

template <bool kUpdate>
int launch(const void* words, const void* weights, int weights_are_bool,
           void* v, void* vote_out, float mu, int pods, int devices, int n,
           cudaStream_t s) {
  if (weights == nullptr)
    return launch_w<kUpdate, kNone>(words, weights, v, vote_out, mu, pods,
                                    devices, n, s);
  if (weights_are_bool)
    return launch_w<kUpdate, kBool>(words, weights, v, vote_out, mu, pods,
                                    devices, n, s);
  return launch_w<kUpdate, kInt>(words, weights, v, vote_out, mu, pods,
                                 devices, n, s);
}

}  // namespace

// words: [P, D, n_words] int32, 16-byte aligned, n_words % 4 == 0,
// D >= 1; weights: [P, D] or null, int32 or, with
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
      n_words % 4 != 0 ||
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
