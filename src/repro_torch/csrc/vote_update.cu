// vote_update: per pod p and coordinate i,
//   pos   = sum_k w[p, k] * bit(words[p, k], i)          (int32)
//   n_eff = sum_k w[p, k]                 (D when no weights are given)
//   vote  = 2 * pos >= n_eff ? +1 : -1   (0 if weights are given, n_eff <= 0)
//   v[p, i] <- f32(v[p, i]) - mu * vote   (in place), or vote_out[p, i] = vote
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
// Design: one thread per coordinate; blockIdx.y is the pod, so one launch
// covers all P pods.  The 32 lanes of a warp cover the 32 bits of one
// word, so each voter's word load is a broadcast and the D loads of a
// warp are D cache lines shared by 32 threads; the v loads and stores
// are coalesced.  The tally is int32 with the reference's tie rule
// (ties -> +1) and empty-quorum rule (vote 0 leaves v untouched).
// __fmul_rn/__fsub_rn keep the update a separate f32 multiply and
// subtract, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kUpdate, typename W>
__global__ void vote_update_kernel(const int32_t* __restrict__ words,
                                   const W* __restrict__ weights,
                                   float* __restrict__ v,
                                   int8_t* __restrict__ vote_out, float mu,
                                   int devices, int64_t n_words) {
  const int64_t n = n_words * 32;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int p = blockIdx.y;
  const int64_t wi = i >> 5;
  const unsigned bit = (unsigned)(i & 31);
  const int32_t* row = words + (int64_t)p * devices * n_words + wi;
  int32_t pos = 0;
  int32_t n_eff = devices;
  if (weights != nullptr) {
    const W* wp = weights + (int64_t)p * devices;
    n_eff = 0;
    for (int k = 0; k < devices; ++k) {
      const int32_t wk = (int32_t)wp[k];
      pos += wk * (int32_t)(((uint32_t)row[k * n_words] >> bit) & 1u);
      n_eff += wk;
    }
  } else {
    for (int k = 0; k < devices; ++k)
      pos += (int32_t)(((uint32_t)row[k * n_words] >> bit) & 1u);
  }
  int vote = (2 * pos >= n_eff) ? 1 : -1;
  if (weights != nullptr && !(n_eff > 0)) vote = 0;
  const int64_t o = (int64_t)p * n + i;
  if (kUpdate) {
    v[o] = __fsub_rn(v[o], __fmul_rn(mu, (float)vote));
  } else {
    vote_out[o] = (int8_t)vote;
  }
}

template <typename W>
void launch(const void* words, const void* weights, void* v, void* vote_out,
            float mu, int pods, int devices, int64_t n_words,
            cudaStream_t s) {
  const int64_t n = n_words * 32;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)pods);
  if (v != nullptr) {
    vote_update_kernel<true, W><<<grid, kThreads, 0, s>>>(
        (const int32_t*)words, (const W*)weights, (float*)v, nullptr, mu,
        devices, n_words);
  } else {
    vote_update_kernel<false, W><<<grid, kThreads, 0, s>>>(
        (const int32_t*)words, (const W*)weights, nullptr, (int8_t*)vote_out,
        mu, devices, n_words);
  }
}

}  // namespace

// words: [P, D, n_words] int32; weights: [P, D] or null, int32 or, with
// weights_are_bool, one byte each (a bool mask, read without a cast
// kernel); exactly one of v ([P, 32 * n_words] f32, updated in place)
// and vote_out ([P, 32 * n_words] int8) is non-null.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_vote_update(const void* words, const void* weights,
                                 int weights_are_bool, void* v,
                                 void* vote_out, float mu, int pods,
                                 int devices, int n_words, void* stream) {
  if (pods == 0 || n_words == 0) return (int)cudaSuccess;
  if ((v == nullptr) == (vote_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (weights_are_bool) {
    launch<uint8_t>(words, weights, v, vote_out, mu, pods, devices, n_words,
                    s);
  } else {
    launch<int32_t>(words, weights, v, vote_out, mu, pods, devices, n_words,
                    s);
  }
  return (int)cudaGetLastError();
}
