// ternary_quant: for every coordinate i of x (f32 or bf16),
//   p      = |x_i| / max(norm, 1e-30)            (IEEE division)
//   out_i  = u_i < p ? norm * sign(x_i) : 0     (sign(0) = 0)
//   out    = 0 everywhere when norm <= 0,  out in x's type
//
// Replaces the TPU kernel src/repro/kernels/ternary_quant.py::ternary_quant
// (_ternary_kernel), the stochastic ternary compressor of the
// Hier-Local-QSGD baseline: unbiased, since E[out_i] = x_i.  The l2 norm
// (one reduction) and the uniforms u are inputs, as on the TPU; the norm
// is read from device memory, so the caller never waits for it.
//
// Bound on the H100: bytes.  x is read and the output written once
// (sizeof(x) each), u read once (4 B): N*(2*sizeof(x) + 4) bytes at
// 3.35 TB/s.
//
// Design: one thread per coordinate, coalesced loads and store; the
// norm is a broadcast load.
//
// Subnormals: the reference runs on XLA's CPU backend, which flushes
// them, and on the TPU, which has none.  So a subnormal |x|, norm or p
// counts as 0 here too (with u = 0 a subnormal x quantizes to 0, not to
// norm*sign(x)).  __fdiv_rn / __fmul_rn pin IEEE rounding.
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
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;
}

template <typename T>
__global__ void ternary_quant_kernel(const T* __restrict__ x,
                                     const float* __restrict__ u,
                                     const float* __restrict__ norm_ptr,
                                     T* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float norm = flush(*norm_ptr);
  const float xv = to_f32(x[i]);
  const float p = flush(__fdiv_rn(flush(fabsf(xv)), fmaxf(norm, 1e-30f)));
  const float sign = xv > 0.0f ? 1.0f : (xv < 0.0f ? -1.0f : 0.0f);
  const float q = u[i] < p ? __fmul_rn(norm, sign) : 0.0f;
  out[i] = from_f32<T>(norm > 0.0f ? q : 0.0f);
}

}  // namespace

// x, out: [N] contiguous, f32 or (x_is_bf16) bf16; u: [N] f32; norm: one
// f32 in device memory.  Returns cudaGetLastError() after the launch.
extern "C" int repro_ternary_quant(const void* x, const void* u,
                                   const void* norm, void* out,
                                   int x_is_bf16, int n, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)(((int64_t)n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16) {
    ternary_quant_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)u, (const float*)norm,
        (__nv_bfloat16*)out, n);
  } else {
    ternary_quant_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)u, (const float*)norm, (float*)out,
        n);
  }
  return (int)cudaGetLastError();
}
