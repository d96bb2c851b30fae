// BLAS level-2 symv (y' = alpha S x + beta y, S symmetric, stored in
// the lower triangle of A) for Hopper (sm_90a), with float32
// accumulation and one rounding to A's dtype at the end. The upper
// triangle of A is never used in arithmetic: it may hold anything,
// NaN included.
//
// Replaces src/repro/kernels/symv.py::symv (pallas_call at symv.py:63,
// body symv_block :23).
//
// Bound on an H100 SXM: HBM bytes of the lower triangle, n(n+1)/2
// elements (0.16 ms for n = 16384 float32 at 3.35 TB/s).
//
// Design: S x = L x + L_s^T x, with L the lower triangle (diagonal
// included) and L_s the strict lower triangle. One launch runs two
// kinds of block, both walking A along its rows so that every load is
// coalesced:
// * "row" blocks, one warp per row i: sum_{j <= i} A[i, j] x[j]
//   (the gemv walk of gemv.cu, cut at the diagonal);
// * "column" blocks, a tile of columns by a range of rows, as in
//   gemvt: sum_{r > c} A[r, c] x[r] for each column c of the tile.
// Each writes float32 partials, and the fixed-order combine of
// common.cuh folds them with alpha and beta. Elements on the wrong side
// of the diagonal that share a 16-byte load are dropped by a per-element
// select, never multiplied by a 0/1 mask (0 * NaN is NaN).
// This reads the lower triangle twice, n^2 elements in all, so it sits
// at about half its bound; reading each lower tile once for both
// products is left for later work.
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
symv_kernel(const T* __restrict__ a, const T* __restrict__ x,
            float* __restrict__ work, int64_t n, int64_t row_blocks,
            int64_t col_tiles, int64_t rows_per_split) {
  constexpr int V = vec_width<T>();
  const int64_t b = blockIdx.x;
  if (b < row_blocks) {
    // L x: row i over columns 0..i, into work[0, i]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t row = b * kRowsPerBlock + warp;
    if (row >= n) return;
    const T* arow = a + row * n;
    float acc = 0.f;
    if constexpr (VEC) {
#pragma unroll 4
      for (int64_t c = lane * V; c <= row; c += 32 * V) {
        float av[V], xv[V];
        load_stream(arow + c, av);
        load_cached(x + c, xv);
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc = c + k <= row ? fmaf(av[k], xv[k], acc) : acc;
      }
    } else {
#pragma unroll 4
      for (int64_t c = lane; c <= row; c += 32)
        acc = fmaf(to_f(arow[c]), to_f(x[c]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) work[row] = acc;
    return;
  }
  // L_s^T x: columns of one tile over one range of rows, into
  // work[1 + split, c]; every column of the tile is written, zero where
  // the range holds no row below it
  const int64_t u = b - row_blocks;
  const int64_t tile = (u % col_tiles) * (kThreads * V);
  const int64_t split = u / col_tiles;
  const int64_t r0 = split * rows_per_split;
  const int64_t r1 = r0 + rows_per_split < n ? r0 + rows_per_split : n;
  const int64_t col0 = VEC ? tile + threadIdx.x * V : tile + threadIdx.x;
  const int64_t step = VEC ? 1 : kThreads;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  if constexpr (VEC) {
    if (col0 < n) {
      const int64_t start = r0 > col0 + 1 ? r0 : col0 + 1;
#pragma unroll 4
      for (int64_t r = start; r < r1; ++r) {
        float av[V];
        load_stream(a + r * n + col0, av);
        const float xr = to_f(x[r]);
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[k] = r > col0 + k ? fmaf(av[k], xr, acc[k]) : acc[k];
      }
    }
  } else {
    const int64_t start = r0 > tile + 1 ? r0 : tile + 1;
#pragma unroll 2
    for (int64_t r = start; r < r1; ++r) {
      const float xr = to_f(x[r]);
      const T* arow = a + r * n;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t col = col0 + k * step;
        if (col < n && r > col) acc[k] = fmaf(to_f(arow[col]), xr, acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t col = col0 + k * step;
    if (col < n) work[(1 + split) * n + col] = acc[k];
  }
}

}  // namespace repro

// a (n, n) row-major contiguous, lower triangle read; x, y and out
// (n,); work (1 + splits, n) float32; scal = {alpha, beta} float32 on
// the device; rows_per_split rows per column block.
extern "C" int repro_symv(int dtype, const void* a, const void* x,
                          const void* y, void* out, float* work,
                          const float* scal, int64_t n,
                          int64_t rows_per_split, int splits,
                          void* stream) {
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int V = repro::vec_width<T>();
    const T* A = static_cast<const T*>(a);
    const T* X = static_cast<const T*>(x);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t row_blocks =
        (n + repro::kRowsPerBlock - 1) / repro::kRowsPerBlock;
    const int64_t tile = static_cast<int64_t>(repro::kThreads) * V;
    const int64_t col_tiles = (n + tile - 1) / tile;
    const unsigned blocks =
        static_cast<unsigned>(row_blocks + col_tiles * splits);
    const bool vec = n % V == 0 && repro::aligned16(a) &&
                     repro::aligned16(x);
    if (vec)
      repro::symv_kernel<T, true><<<blocks, repro::kThreads, 0, s>>>(
          A, X, work, n, row_blocks, col_tiles, rows_per_split);
    else
      repro::symv_kernel<T, false><<<blocks, repro::kThreads, 0, s>>>(
          A, X, work, n, row_blocks, col_tiles, rows_per_split);
    repro::launch_combine<T>(work, static_cast<const T*>(y),
                             static_cast<T*>(out), scal, n, 1 + splits, s);
  };
  REPRO_DISPATCH(dtype, run);
  return static_cast<int>(cudaGetLastError());
}
