// BLAS level-2 gemv (y' = alpha A x + beta y) and gemvt
// (y' = alpha A^T x + beta y) for Hopper (sm_90a), with float32
// accumulation and one rounding to A's dtype at the end.
//
// Replaces src/repro/kernels/gemv.py::gemv (pallas_call at gemv.py:60,
// body gemv_block :27) and ::gemvt (pallas_call at :112, body
// gemvt_block :79).
//
// Bound on an H100 SXM: HBM bytes. A matvec does 2 flops per matrix
// element read (0.5 flop/byte in float32, far below the ridge), so the
// least time is the bytes of A plus the vectors at 3.35 TB/s: 0.32 ms
// for a 16384 x 16384 float32 A.
//
// Design:
// * gemv: one warp per row, lanes walk the row in 16-byte loads
//   (evict-first, A is read once), x through the read-only cache. A
//   short, wide A (GMRES's (31, 2^20) basis) leaves most SMs idle with
//   one warp per row, so the columns are split into `splits` chunks
//   (grid.y); each chunk writes a float32 partial per row and a second
//   launch folds the partials in a fixed order (common.cuh).
// * gemvt: A is row-major but the output runs over its columns, so a
//   thread owns 16 bytes of consecutive columns (neighbouring threads on
//   neighbouring addresses) and walks down the rows, x[r] broadcast to
//   the block. A^T is never formed. The rows are split across grid.y
//   for a square A (16 column tiles would fill 16 SMs), with the same
//   fixed-order combine.
// * The ragged edge is masked, never padded; offsets are 64-bit.
// * Where n is not a multiple of the 16-byte width, or a pointer is not
//   16-byte aligned, the same kernels take a scalar path with
//   coalesced 4-byte (or 2-byte) loads.
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // gemv: one warp per row

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const T* __restrict__ a, const T* __restrict__ x,
            const T* __restrict__ y, T* __restrict__ out,
            float* __restrict__ work, const float* __restrict__ scal,
            int64_t m, int64_t n, int64_t chunk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= m) return;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t c1 = c0 + chunk < n ? c0 + chunk : n;
  const T* arow = a + row * n;
  float acc = 0.f;
  if constexpr (VEC) {
    constexpr int V = vec_width<T>();
#pragma unroll 4
    for (int64_t c = c0 + lane * V; c < c1; c += 32 * V) {
      float av[V], xv[V];
      load_stream(arow + c, av);
      load_cached(x + c, xv);
#pragma unroll
      for (int k = 0; k < V; ++k) acc = fmaf(av[k], xv[k], acc);
    }
  } else {
#pragma unroll 4
    for (int64_t c = c0 + lane; c < c1; c += 32)
      acc = fmaf(to_f(arow[c]), to_f(x[c]), acc);
  }
  acc = warp_sum(acc);
  if (lane != 0) return;
  if (gridDim.y == 1)
    out[row] = from_f<T>(scal[0] * acc + scal[1] * to_f(y[row]));
  else
    work[static_cast<int64_t>(blockIdx.y) * m + row] = acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gemvt_kernel(const T* __restrict__ a, const T* __restrict__ x,
             const T* __restrict__ y, T* __restrict__ out,
             float* __restrict__ work, const float* __restrict__ scal,
             int64_t m, int64_t n, int64_t rows_per_split) {
  constexpr int V = vec_width<T>();  // columns each thread owns
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * (kThreads * V);
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_split;
  const int64_t r1 = r0 + rows_per_split < m ? r0 + rows_per_split : m;
  // VEC: columns col0 .. col0 + V - 1; scalar: col0 + k * kThreads
  const int64_t col0 = VEC ? tile + threadIdx.x * V : tile + threadIdx.x;
  const int64_t step = VEC ? 1 : kThreads;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  if constexpr (VEC) {
    if (col0 < n) {  // n % V == 0: the whole 16 bytes are in range
#pragma unroll 4
      for (int64_t r = r0; r < r1; ++r) {
        float av[V];
        load_stream(a + r * n + col0, av);
        const float xr = to_f(x[r]);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(av[k], xr, acc[k]);
      }
    }
  } else {
#pragma unroll 2
    for (int64_t r = r0; r < r1; ++r) {
      const float xr = to_f(x[r]);
      const T* arow = a + r * n;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t col = col0 + k * step;
        if (col < n) acc[k] = fmaf(to_f(arow[col]), xr, acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t col = col0 + k * step;
    if (col >= n) continue;
    if (gridDim.y == 1)
      out[col] = from_f<T>(scal[0] * acc[k] + scal[1] * to_f(y[col]));
    else
      work[static_cast<int64_t>(blockIdx.y) * n + col] = acc[k];
  }
}

}  // namespace repro

// a (m, n) row-major contiguous; x (n,), y and out (m,); work
// (splits, m) float32 when splits > 1; scal = {alpha, beta} float32 on
// the device; chunk = columns per split.
extern "C" int repro_gemv(int dtype, const void* a, const void* x,
                          const void* y, void* out, float* work,
                          const float* scal, int64_t m, int64_t n,
                          int64_t chunk, int splits, void* stream) {
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int V = repro::vec_width<T>();
    const T* A = static_cast<const T*>(a);
    const T* X = static_cast<const T*>(x);
    const T* Y = static_cast<const T*>(y);
    T* O = static_cast<T*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dim3 grid(static_cast<unsigned>((m + repro::kRowsPerBlock - 1) /
                                    repro::kRowsPerBlock),
              static_cast<unsigned>(splits));
    const bool vec = n % V == 0 && chunk % V == 0 && repro::aligned16(a) &&
                     repro::aligned16(x);
    if (vec)
      repro::gemv_kernel<T, true><<<grid, repro::kThreads, 0, s>>>(
          A, X, Y, O, work, scal, m, n, chunk);
    else
      repro::gemv_kernel<T, false><<<grid, repro::kThreads, 0, s>>>(
          A, X, Y, O, work, scal, m, n, chunk);
    if (splits > 1) repro::launch_combine<T>(work, Y, O, scal, m, splits, s);
  };
  REPRO_DISPATCH(dtype, run);
  return static_cast<int>(cudaGetLastError());
}

// a (m, n) row-major contiguous; x (m,), y and out (n,); work
// (splits, n) float32 when splits > 1; rows_per_split rows of A each.
extern "C" int repro_gemvt(int dtype, const void* a, const void* x,
                           const void* y, void* out, float* work,
                           const float* scal, int64_t m, int64_t n,
                           int64_t rows_per_split, int splits,
                           void* stream) {
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int V = repro::vec_width<T>();
    const T* A = static_cast<const T*>(a);
    const T* X = static_cast<const T*>(x);
    const T* Y = static_cast<const T*>(y);
    T* O = static_cast<T*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t tile = static_cast<int64_t>(repro::kThreads) * V;
    dim3 grid(static_cast<unsigned>((n + tile - 1) / tile),
              static_cast<unsigned>(splits));
    const bool vec = n % V == 0 && repro::aligned16(a);
    if (vec)
      repro::gemvt_kernel<T, true><<<grid, repro::kThreads, 0, s>>>(
          A, X, Y, O, work, scal, m, n, rows_per_split);
    else
      repro::gemvt_kernel<T, false><<<grid, repro::kThreads, 0, s>>>(
          A, X, Y, O, work, scal, m, n, rows_per_split);
    if (splits > 1) repro::launch_combine<T>(work, Y, O, scal, n, splits, s);
  };
  REPRO_DISPATCH(dtype, run);
  return static_cast<int>(cudaGetLastError());
}
