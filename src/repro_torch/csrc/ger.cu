// BLAS level-2 ger (A' = alpha x y^T + A), the rank-1 update, for Hopper
// (sm_90a), into a new matrix: A itself is never written, since a
// program may read it again.
//
// Replaces src/repro/kernels/ger.py::ger (pallas_call at ger.py:38, body
// _ger_kernel :21). As there, x, y and A are read as float32, alpha is
// float32, and the result is rounded once to A's dtype. The float32
// arithmetic is the Pallas body's, in its order and with no fused
// multiply-add: (alpha * x_i) * y_j + A_ij, each step rounded, so the
// kernel repeats its plain version bit for bit.
//
// Bound on an H100 SXM: HBM bytes. A is read once and A' written once
// (2 flops per element, far below the ridge), so the least time is
// 2 * 4 * m * n bytes at 3.35 TB/s: 0.641 ms for a 16384 x 16384
// float32 A.
//
// Design: a block of 256 threads owns a tile of 16 rows by 256 * V
// columns (V elements in 16 bytes: 4 float32, 8 bfloat16 or float16).
// Each thread holds its V entries of y in registers for the whole tile
// and walks the 16 rows, x_i broadcast to the block through the
// read-only cache; A is streamed in with evict-first 16-byte loads and
// A' streamed out with 16-byte stores. Where n is not a multiple of V,
// or a pointer is not 16-byte aligned, the same kernel takes a scalar
// path whose threads own V columns 256 apart (still coalesced). The
// ragged edge is masked, never padded; offsets are 64-bit.
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kGerThreads = 256;
constexpr int kGerRows = 16;  // rows of one block's tile

template <typename T, bool VEC>
__global__ void __launch_bounds__(kGerThreads)
ger_kernel(const T* __restrict__ x, const T* __restrict__ y,
           const T* __restrict__ a, T* __restrict__ out,
           const float* __restrict__ scal, int64_t m, int64_t n) {
  constexpr int V = vec_width<T>();
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kGerRows;
  const int64_t r1 = r0 + kGerRows < m ? r0 + kGerRows : m;
  const int64_t tile = static_cast<int64_t>(blockIdx.y) * (kGerThreads * V);
  // VEC: columns col0 .. col0 + V - 1; scalar: col0 + k * kGerThreads
  const int64_t col0 = VEC ? tile + threadIdx.x * V : tile + threadIdx.x;
  const int64_t step = VEC ? 1 : kGerThreads;
  const float alpha = scal[0];
  float yv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t col = col0 + k * step;
    yv[k] = col < n ? to_f(y[col]) : 0.f;
  }
  if constexpr (VEC) {
    if (col0 >= n) return;  // n % V == 0: the whole 16 bytes are in range
    for (int64_t r = r0; r < r1; ++r) {
      const float ax = __fmul_rn(alpha, to_f(__ldg(x + r)));
      float av[V];
      load_stream(a + r * n + col0, av);
      alignas(16) T o[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        o[k] = from_f<T>(__fadd_rn(__fmul_rn(ax, yv[k]), av[k]));
      __stcs(reinterpret_cast<float4*>(out + r * n + col0),
             *reinterpret_cast<const float4*>(o));
    }
  } else {
    for (int64_t r = r0; r < r1; ++r) {
      const float ax = __fmul_rn(alpha, to_f(x[r]));
      const T* arow = a + r * n;
      T* orow = out + r * n;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t col = col0 + k * step;
        if (col < n)
          orow[col] = from_f<T>(__fadd_rn(__fmul_rn(ax, yv[k]),
                                          to_f(arow[col])));
      }
    }
  }
}

}  // namespace repro

// x (m,), y (n,), a and out (m, n) row-major contiguous, all of one
// dtype; scal = {alpha} float32 on the device.
extern "C" int repro_ger(int dtype, const void* x, const void* y,
                         const void* a, void* out, const float* scal,
                         int64_t m, int64_t n, void* stream) {
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int V = repro::vec_width<T>();
    const int64_t tile = static_cast<int64_t>(repro::kGerThreads) * V;
    dim3 grid(static_cast<unsigned>((m + repro::kGerRows - 1) /
                                    repro::kGerRows),
              static_cast<unsigned>((n + tile - 1) / tile));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* X = static_cast<const T*>(x);
    const T* Y = static_cast<const T*>(y);
    const T* A = static_cast<const T*>(a);
    T* O = static_cast<T*>(out);
    const bool vec = n % V == 0 && repro::aligned16(a) &&
                     repro::aligned16(out);
    if (vec)
      repro::ger_kernel<T, true><<<grid, repro::kGerThreads, 0, s>>>(
          X, Y, A, O, scal, m, n);
    else
      repro::ger_kernel<T, false><<<grid, repro::kGerThreads, 0, s>>>(
          X, Y, A, O, scal, m, n);
  };
  REPRO_DISPATCH(dtype, run);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory one block of the kernel requests (static, from
// cudaFuncGetAttributes; the launch passes no dynamic bytes), for the
// check of kernels/ger.py's footprint: `vec` 1 for the 16-byte path,
// 0 for the scalar one.
extern "C" int repro_ger_smem(int dtype, int vec, long long* bytes) {
  int err = 0;
  auto body = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    cudaFuncAttributes attr{};
    err = static_cast<int>(
        vec ? cudaFuncGetAttributes(&attr, repro::ger_kernel<T, true>)
            : cudaFuncGetAttributes(&attr, repro::ger_kernel<T, false>));
    *bytes = static_cast<long long>(attr.sharedSizeBytes);
  };
  REPRO_DISPATCH(dtype, body);
  return err;
}
