// Matrix transpose (out = A^T) for Hopper (sm_90a): a bitwise copy of
// every element to its mirrored position, in A's dtype.
//
// Replaces src/repro/kernels/transpose.py::transpose (pallas_call at
// transpose.py:38, body _transpose_kernel :21).
//
// Bound on an H100 SXM: HBM bytes. Each element is read once and
// written once and nothing is computed, so the least time is 2 * 4 * m
// * n bytes at 3.35 TB/s: 0.641 ms for a 16384 x 16384 float32 A.
//
// Design:
// * A 32 x 32 tile goes through shared memory: the block reads the tile
//   row by row (neighbouring threads on neighbouring columns of A) and
//   writes it column by column (neighbouring threads on neighbouring
//   columns of out), so both sides are coalesced. The tile has a
//   padding column (33 wide), so the transposed read of shared memory
//   walks 32 different banks instead of one.
// * 32 x 8 threads, four rows each.
// * The ragged edge is masked (the reference pads A to whole windows and
//   slices the result). A tile index runs over a grid-stride loop, so
//   any (m, n) takes one launch: GMRES's (20, 21) Hessenberg buffer is
//   one tile, a 16384^2 matrix 262144.
// * The reference casts each window to float32 and back, which leaves
//   every float32, bfloat16 and float16 value as it was; this kernel
//   moves the bits as they are, as 32- or 16-bit words (NaN payloads
//   included), so the result is bitwise A.t().
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kTile = 32;
constexpr int kTileRows = 8;  // threads along y; each moves 4 rows

template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
transpose_kernel(const T* __restrict__ a, T* __restrict__ out, int64_t m,
                 int64_t n, int64_t col_tiles, int64_t tiles) {
  __shared__ T tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t r0 = (t / col_tiles) * kTile;
    const int64_t c0 = (t % col_tiles) * kTile;
#pragma unroll
    for (int k = 0; k < kTile; k += kTileRows) {
      const int64_t r = r0 + ty + k, c = c0 + tx;
      if (r < m && c < n) tile[ty + k][tx] = a[r * n + c];
    }
    __syncthreads();
    // out is (n, m): its row c0 + ty + k holds A's column c0 + ty + k
#pragma unroll
    for (int k = 0; k < kTile; k += kTileRows) {
      const int64_t r = c0 + ty + k, c = r0 + tx;
      if (r < n && c < m) out[r * m + c] = tile[tx][ty + k];
    }
    __syncthreads();  // the tile is refilled by the next iteration
  }
}

}  // namespace repro

// a (m, n) row-major contiguous; out (n, m) row-major contiguous.
extern "C" int repro_transpose(int dtype, const void* a, void* out,
                               int64_t m, int64_t n, void* stream) {
  auto run = [&](auto* tag) {
    // the element's bits, moved as a word of its size
    using T = std::conditional_t<
        sizeof(std::remove_pointer_t<decltype(tag)>) == 4, uint32_t,
        uint16_t>;
    const int64_t col_tiles = (n + repro::kTile - 1) / repro::kTile;
    const int64_t tiles = col_tiles * ((m + repro::kTile - 1) / repro::kTile);
    // enough blocks to fill the card many times over; more tiles than
    // that are walked by the grid-stride loop
    const int64_t cap = 132 * 64;
    const unsigned blocks =
        static_cast<unsigned>(tiles < cap ? tiles : cap);
    repro::transpose_kernel<T>
        <<<blocks, dim3(repro::kTile, repro::kTileRows), 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(a), static_cast<T*>(out), m, n,
            col_tiles, tiles);
  };
  REPRO_DISPATCH(dtype, run);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory one block of the kernel requests (static, from
// cudaFuncGetAttributes; the launch passes no dynamic bytes), for the
// check of kernels/transpose.py's footprint.
extern "C" int repro_transpose_smem(int dtype, long long* bytes) {
  int err = 0;
  auto body = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    cudaFuncAttributes attr{};
    err = static_cast<int>(
        cudaFuncGetAttributes(&attr, repro::transpose_kernel<T>));
    *bytes = static_cast<long long>(attr.sharedSizeBytes);
  };
  REPRO_DISPATCH(dtype, body);
  return err;
}
