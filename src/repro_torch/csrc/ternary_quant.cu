// ternary_quant: x (f32 or bf16) holds R rows of C coordinates, row r
// with its own l2 norm norms[r].  For every coordinate i of row r = i / C,
//   p      = |x_i| / max(norms[r], 1e-30)        (IEEE division)
//   out_i  = u_i < p ? norms[r] * sign(x_i) : 0 (sign(0) = 0)
//   out    = 0 on a row whose norm is <= 0,  out in x's type
//
// Replaces the TPU kernel src/repro/kernels/ternary_quant.py::ternary_quant
// (_ternary_kernel), the stochastic ternary compressor of the
// Hier-Local-QSGD baseline: unbiased, since E[out_i] = x_i.  The l2 norms
// (one reduction per row) and the uniforms u are inputs, as on the TPU;
// the norms are read from device memory, so the caller never waits for
// them.  R = 1, C = n is one norm for the whole tensor.  The QSGD step
// quantizes each gradient leaf [P, V, *leaf] as R = P*V rows of
// C = numel(leaf): one launch per leaf.
//
// Bound on the H100: bytes.  x is read and the output written once
// (sizeof(x) each), u read once (4 B), the norms once (4 B a row):
// N*(2*sizeof(x) + 4) + 4*R bytes at 3.35 TB/s.
//
// Design: a streaming pass.  The first design (one thread per
// coordinate: one 4 B or 2 B load of x, one 4 B load of u and one narrow
// store) kept too few bytes in flight per thread for a 50 MB stream, with
// half-width transactions for bf16 (52 % and 40 % of the bound at 2^22).
// Here a thread takes one 16-byte vector of x (4 f32 or 8 bf16
// coordinates) and issues its independent 16-byte loads at once, x and
// u (2 for f32; 3 for bf16, whose 8 uniforms are 32 B), before it
// computes; it stores the result as 16 B.  Blocks of 128 threads take
// consecutive runs of 128 vectors, so the scheduler refills an SM as its
// blocks finish and short vectors still spread over the SMs.  (A grid of
// one wave walking the vector in strides, and 4 vectors a thread, were
// no faster at 2^22 and slower at the MLP's sizes: PERF.md.)  The last
// n % 4 (f32) or n % 8 (bf16) coordinates, which fill no vector, take a
// scalar path in the last block.  x, u and out are 16-byte aligned (the
// wrapper refuses other x and u and allocates out).
//
// Rows of any length: a vector may straddle rows (the MLP's leaves are
// rows of 10, 64, 640 and 50176 coordinates, and a row of 10 ends inside
// a vector), so a thread finds the row of its first coordinate with one
// division and walks its V coordinates, stepping to the next row's norm
// where a row ends.  The norm loads go through the read-only cache: the
// rows' norms are few and every thread of a row reads the same one.
// The first design's times, which this one replaces (chip_smoke.py on an
// H100 80GB HBM3 at a 700 W power limit): 0.002321 ms device at 53248
// f32 coordinates; at 2^22 0.02882 ms (f32) and 0.0250 ms (bf16).
//
// Subnormals: the reference runs on XLA's CPU backend, which flushes
// them, and on the TPU, which has none.  So a subnormal |x|, norm or p
// counts as 0 here too (with u = 0 a subnormal x quantizes to 0, not to
// norm*sign(x)).  __fdiv_rn / __fmul_rn pin IEEE rounding.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 128;

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

// One coordinate, given the flushed norm.  A zero |x| (after the flush)
// gives p = 0 whatever the norm, without the division, whose IEEE
// sequence takes its slow path on a zero numerator: a thread of 4 or 8
// coordinates would pay it for each zero, and gradients hold many.
__device__ __forceinline__ float quant(float xv, float uv, float norm) {
  const float ax = flush(fabsf(xv));
  const float p = ax == 0.0f ? 0.0f
                             : flush(__fdiv_rn(ax, fmaxf(norm, 1e-30f)));
  const float sign = xv > 0.0f ? 1.0f : (xv < 0.0f ? -1.0f : 0.0f);
  const float q = uv < p ? __fmul_rn(norm, sign) : 0.0f;
  return norm > 0.0f ? q : 0.0f;
}

// The 16-byte output vector of V coordinates.
__device__ __forceinline__ uint4 pack(const float (&q)[4]) {
  return make_uint4(__float_as_uint(q[0]), __float_as_uint(q[1]),
                    __float_as_uint(q[2]), __float_as_uint(q[3]));
}

__device__ __forceinline__ uint4 pack(const float (&q)[8]) {
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(q[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(q[2 * i + 1]))
            << 16);
  return make_uint4(h[0], h[1], h[2], h[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ternary_quant_kernel(const T* __restrict__ x,
                         const float* __restrict__ u,
                         const float* __restrict__ norms,
                         T* __restrict__ out, uint32_t n, uint32_t cols) {
  constexpr int V = ring::Lane<T>::kVec;    // coordinates of a vector
  constexpr int kUVecs = V / 4;             // 16-byte vectors of u in one
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* uv = reinterpret_cast<const uint4*>(u);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const uint32_t n_vec = n / V;
  const uint32_t v = blockIdx.x * kThreads + threadIdx.x;
  if (v < n_vec) {
    uint4 ur[kUVecs];                        // every load first ...
    const uint4 xr = __ldcs(xv + v);
#pragma unroll
    for (int h = 0; h < kUVecs; ++h) ur[h] = __ldcs(uv + v * kUVecs + h);
    // ... and the row of the first coordinate, and its norm
    uint32_t row = v * V / cols;
    uint32_t col = v * V - row * cols;
    float norm = flush(__ldg(norms + row));
    float xf[V], uf[V], q[V];                // then the arithmetic
    ring::unpack(xr, xf);
#pragma unroll
    for (int h = 0; h < kUVecs; ++h) {
      float part[4];
      ring::unpack(ur[h], part);
#pragma unroll
      for (int e = 0; e < 4; ++e) uf[4 * h + e] = part[e];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      q[e] = quant(xf[e], uf[e], norm);
      if (++col == cols && e + 1 < V) {      // the next coordinate starts
        col = 0;                             // a row: its norm
        norm = flush(__ldg(norms + ++row));
      }
    }
    __stcs(ov + v, pack(q));
  }
  // the ragged tail: fewer than V coordinates, in the last block
  const uint32_t i = n_vec * V + threadIdx.x;
  if (blockIdx.x == gridDim.x - 1 && i < n)
    out[i] = from_f32<T>(
        quant(to_f32(x[i]), u[i], flush(__ldg(norms + i / cols))));
}

template <typename T>
int launch(const void* x, const void* u, const void* norms, void* out,
           uint32_t n, uint32_t cols, cudaStream_t s) {
  const uint32_t n_vec = n / ring::Lane<T>::kVec;
  uint32_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;                // the tail alone
  ternary_quant_kernel<T><<<blocks, kThreads, 0, s>>>(
      (const T*)x, (const float*)u, (const float*)norms, (T*)out, n, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [rows * cols] contiguous, f32 or (x_is_bf16) bf16; u: the same
// count of f32; all three 16-byte aligned; norms: rows f32 in device
// memory, norms[r] the l2 norm of row r.  rows * cols < 2^31 (the wrapper
// checks it).  Returns cudaGetLastError() after the launch.
extern "C" int repro_ternary_quant(const void* x, const void* u,
                                   const void* norms, void* out,
                                   int x_is_bf16, int rows, int cols,
                                   void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  const int64_t n = (int64_t)rows * cols;
  if (n >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x & 15) != 0 || ((uintptr_t)u & 15) != 0 ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return x_is_bf16
             ? launch<__nv_bfloat16>(x, u, norms, out, (uint32_t)n,
                                     (uint32_t)cols, s)
             : launch<float>(x, u, norms, out, (uint32_t)n, (uint32_t)cols,
                             s);
}
