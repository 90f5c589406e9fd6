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
// Design: one thread per coordinate, a 3-D grid: blockIdx.z is the pod
// and blockIdx.y the device, so a block's (p, d) and its voter weight
// need no divide, and the weight load is the same address for the whole
// block (a broadcast).  Loads of u, delta and the tally and the tally
// store are coalesced along i.
//
// Rounding: the same as sign_pack.cu, which the merged mode runs on the
// same directions: rho*delta is rounded before the add (__fmul_rn /
// __fadd_rn, and the build passes -fmad=false), so the streamed and
// merged modes see the same signs bit for bit.  The sign is
// x > -FLT_MIN: -0.0 and negative subnormals give +1 (the reference
// flushes subnormals), NaN gives -1.  The product w*s and the add are
// int32; every partial tally lies within the weight bound, so the
// narrowing store is exact.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, typename A, bool kDelta>
__global__ void tally_acc_kernel(const T* __restrict__ u,
                                 const T* __restrict__ delta, float rho,
                                 const int32_t* __restrict__ weights,
                                 A* __restrict__ tally, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int p = blockIdx.z;
  const int64_t r = (int64_t)p * gridDim.y + blockIdx.y;   // voter row
  const int32_t w = weights[r];
  const int64_t o = r * n + i;
  float x = to_f32(u[o]);
  if (kDelta) x = __fadd_rn(x, __fmul_rn(rho, to_f32(delta[p * n + i])));
  const int32_t s = x > -FLT_MIN ? 1 : -1;
  tally[o] = (A)((int32_t)tally[o] + w * s);
}

template <typename T, typename A>
void launch(const void* u, const void* delta, float rho, const void* weights,
            void* tally, int pods, int devices, int64_t n, cudaStream_t s) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads),
                  (unsigned)devices, (unsigned)pods);
  if (delta != nullptr) {
    tally_acc_kernel<T, A, true><<<grid, kThreads, 0, s>>>(
        (const T*)u, (const T*)delta, rho, (const int32_t*)weights,
        (A*)tally, n);
  } else {
    tally_acc_kernel<T, A, false><<<grid, kThreads, 0, s>>>(
        (const T*)u, nullptr, rho, (const int32_t*)weights, (A*)tally, n);
  }
}

template <typename T>
int launch_tally(const void* u, const void* delta, float rho,
                 const void* weights, void* tally, int tally_bytes, int pods,
                 int devices, int64_t n, cudaStream_t s) {
  switch (tally_bytes) {
    case 1:
      launch<T, int8_t>(u, delta, rho, weights, tally, pods, devices, n, s);
      break;
    case 2:
      launch<T, int16_t>(u, delta, rho, weights, tally, pods, devices, n, s);
      break;
    case 4:
      launch<T, int32_t>(u, delta, rho, weights, tally, pods, devices, n, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// u: [P, D, n] contiguous, f32 or (u_is_bf16) bf16; delta: [P, n] of u's
// type, or null; weights: [P, D] int32; tally: [P, D, n] signed integers
// of tally_bytes (1, 2 or 4) bytes, updated in place.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_tally_acc(const void* u, const void* delta, float rho,
                               const void* weights, void* tally,
                               int u_is_bf16, int tally_bytes, int pods,
                               int devices, int n, void* stream) {
  if (pods == 0 || devices == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (u_is_bf16) {
    return launch_tally<__nv_bfloat16>(u, delta, rho, weights, tally,
                                       tally_bytes, pods, devices, n, s);
  }
  return launch_tally<float>(u, delta, rho, weights, tally, tally_bytes,
                             pods, devices, n, s);
}
