// Shared device helpers of the port's level-2 CUDA kernels (gemv.cu,
// symv.cu): element conversions, a warp sum, 16-byte loads, and the
// fixed-order combine of per-block partials.
//
// Every C entry point returns cudaGetLastError() after its launches;
// the Python wrapper raises when that is not cudaSuccess. Nothing here
// allocates or synchronises: the wrapper allocates outputs and scratch
// with torch.empty and the kernels run on the stream it passes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with kernels/cuda.py
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// elements of T in one 16-byte load
template <typename T>
__host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

// one 16-byte load of VEC elements of a streamed operand (evict-first:
// the matrix is read once and would only push x out of the caches)
template <typename T>
__device__ __forceinline__ void load_stream(const T* p, float* out) {
  float4 raw = __ldcs(reinterpret_cast<const float4*>(p));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < vec_width<T>(); ++k) out[k] = to_f(v[k]);
}

// the same through the read-only cache, for the reused vector x
template <typename T>
__device__ __forceinline__ void load_cached(const T* p, float* out) {
  float4 raw = __ldg(reinterpret_cast<const float4*>(p));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < vec_width<T>(); ++k) out[k] = to_f(v[k]);
}

// butterfly sum over the 32 lanes of a warp; the order is fixed, so a
// result repeats bitwise
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

inline bool aligned16(const void* p) {  // host: picks the 16-byte path
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// out[i] = alpha * sum_s work[s, i] + beta * y[i], s in order 0..S-1.
// It takes the place of the TPU kernels' sequential grid axis, which
// carried one accumulator from step to step: blocks here run in
// parallel, so each writes a float32 partial and this second launch
// folds them in a fixed order, with no float atomics.
template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ work, const T* __restrict__ y,
               T* __restrict__ out, const float* __restrict__ scal,
               int64_t len, int splits) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += work[s * len + i];
  out[i] = from_f<T>(scal[0] * acc + scal[1] * to_f(y[i]));
}

template <typename T>
void launch_combine(const float* work, const T* y, T* out,
                    const float* scal, int64_t len, int splits,
                    cudaStream_t stream) {
  unsigned blocks = static_cast<unsigned>((len + 255) / 256);
  combine_kernel<T><<<blocks, 256, 0, stream>>>(work, y, out, scal, len,
                                                splits);
}

}  // namespace repro

// instantiate `body` (a lambda over a typed null pointer) for the
// dtype code; returns cudaErrorInvalidValue for an unknown code
#define REPRO_DISPATCH(dtype, body)                              \
  switch (dtype) {                                               \
    case repro::kF32: body(static_cast<float*>(nullptr)); break; \
    case repro::kBF16:                                           \
      body(static_cast<__nv_bfloat16*>(nullptr));                \
      break;                                                     \
    case repro::kF16: body(static_cast<__half*>(nullptr)); break; \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }
