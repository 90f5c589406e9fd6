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
// Design: warp w packs word w.  Lane j loads coordinate 32w + j (one
// 128 B coalesced load of u per warp for f32), forms the float value,
// and __ballot_sync(sign bit) IS the packed word (lane j -> bit j); lane 0
// stores it.  The correction is indexed as (p, i) directly -- the TPU's
// slab index map -- so no [P, D, n] copy of delta exists.  A grid-stride
// loop keeps the grid size fixed for any n.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void sign_pack_kernel(const T* __restrict__ u,
                                 const T* __restrict__ delta, float rho,
                                 int32_t* __restrict__ words, int devices,
                                 int64_t n_words, int64_t total_words) {
  const int lane = threadIdx.x & 31;
  const int64_t warp0 =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t n = n_words * 32;
  for (int64_t w = warp0; w < total_words; w += stride) {
    float x = to_f32(u[w * 32 + lane]);
    if (delta != nullptr) {
      const int64_t pd = w / n_words;          // (pod, device) row
      const int64_t i = (w - pd * n_words) * 32 + lane;
      const int64_t p = pd / devices;
      x = __fadd_rn(x, __fmul_rn(rho, to_f32(delta[p * n + i])));
    }
    const unsigned bits = __ballot_sync(0xffffffffu, x > -FLT_MIN);
    if (lane == 0) words[w] = (int32_t)bits;
  }
}

template <typename T>
int launch(const void* u, const void* delta, float rho, void* words,
           int pods, int devices, int n_words, void* stream) {
  const int64_t total = (int64_t)pods * devices * n_words;
  if (total == 0) return (int)cudaSuccess;
  int64_t blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t max_blocks = 132 * 32;   // a few waves; the loop does the rest
  if (blocks > max_blocks) blocks = max_blocks;
  sign_pack_kernel<T><<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const T*)u, (const T*)delta, rho, (int32_t*)words, devices,
      (int64_t)n_words, total);
  return (int)cudaGetLastError();
}

}  // namespace

// u: [P, D, 32 * n_words] contiguous; delta: [P, 32 * n_words] or null;
// words: [P, D, n_words] int32.  Returns cudaGetLastError() after launch.
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
