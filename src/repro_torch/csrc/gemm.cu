// BLAS level-3 gemm (C' = alpha A B + beta C) for Hopper (sm_90a), with
// a float32 accumulator and one rounding to C's dtype at the end.
//
// Replaces src/repro/kernels/gemm.py::gemm (pallas_call at gemm.py:69,
// body gemm_block :23; matmul :91 calls it with alpha = 1, beta = 0).
// As there, A and B are widened to float32, the product is true float32
// (no TF32), alpha and beta are float32, and beta * C is computed even
// when beta is 0 (block-CG passes P as C with beta = 0).
//
// Bound on an H100 SXM, at block-CG's shape (16384 x 16384) . (16384 x
// 32) float32: HBM bytes 4 (n^2 + 3ns) = 1.08 GB at 3.35 TB/s = 0.322
// ms; float32 FFMA 2 n^2 s = 17.2 GFLOP at 67 TFLOP/s = 0.256 ms. The
// kernel sits near the ridge: it must stream A once at full rate and
// keep the FMA pipes busy at the same time.
//
// Design:
// * One block owns one (kBM, kBN) = (64, 32) output tile and walks its
//   share of K in steps of kBK = 32. A loop over K inside the block
//   takes the place of the TPU's sequential `kk` grid axis. Tiles of A
//   (stored transposed, so a thread reads its 4 rows as one float4) and
//   of B go through shared memory as float32; each of the 128 threads
//   keeps a 4 x 4 register micro-tile and runs float32 FFMA.
// * A tall, skinny product (block-CG's 16384 x 32 output) has 256 such
//   tiles, about two per SM, too few blocks in flight to stream A at
//   full rate. So K is split into `splits` chunks (grid.z); each chunk
//   writes a float32 partial tile and the fixed-order combine of
//   common.cuh folds them with alpha and beta. No float atomics: a
//   result repeats bitwise.
// * The ragged edge is masked, never padded; offsets are 64-bit.
// * Where K or N is not a multiple of the 16-byte width, or a pointer
//   is not 16-byte aligned, the same kernel takes a scalar load path.
// * No wgmma and no TF32: float32 wgmma is TF32, and the reference
//   product is full float32. A bf16 tensor-core path is later work.
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kBM = 64, kBN = 32, kBK = 32;
constexpr int kGemmThreads = 128;       // (kBM / 4) x (kBN / 4)
constexpr int kPadA = 4;                // keeps float4 rows aligned

template <typename T, bool VEC>
__device__ __forceinline__ void load_tiles(
    const T* __restrict__ a, const T* __restrict__ b,
    float (*As)[kBM + kPadA], float (*Bs)[kBN], int64_t row0,
    int64_t col0, int64_t kk, int64_t k1, int64_t m, int64_t n,
    int64_t k) {
  const int t = threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = vec_width<T>();
    // A tile: kBM rows x kBK columns of K, V consecutive K per load
    for (int e = t; e < kBM * kBK / V; e += kGemmThreads) {
      const int r = e / (kBK / V), q = (e % (kBK / V)) * V;
      const int64_t row = row0 + r, kq = kk + q;
      float v[V];
      if (row < m && kq < k1) {
        load_cached(a + row * k + kq, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) As[q + j][r] = v[j];
    }
    // B tile: kBK rows of K x kBN columns, V consecutive columns per load
    for (int e = t; e < kBK * kBN / V; e += kGemmThreads) {
      const int q = e / (kBN / V), c = (e % (kBN / V)) * V;
      const int64_t kq = kk + q, col = col0 + c;
      float v[V];
      if (kq < k1 && col < n) {
        load_cached(b + kq * n + col, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) Bs[q][c + j] = v[j];
    }
  } else {
    for (int e = t; e < kBM * kBK; e += kGemmThreads) {
      const int r = e / kBK, q = e % kBK;
      const int64_t row = row0 + r, kq = kk + q;
      As[q][r] = (row < m && kq < k1) ? to_f(a[row * k + kq]) : 0.f;
    }
    for (int e = t; e < kBK * kBN; e += kGemmThreads) {
      const int q = e / kBN, c = e % kBN;
      const int64_t kq = kk + q, col = col0 + c;
      Bs[q][c] = (kq < k1 && col < n) ? to_f(b[kq * n + col]) : 0.f;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            const T* __restrict__ c, T* __restrict__ out,
            float* __restrict__ work, const float* __restrict__ scal,
            int64_t m, int64_t n, int64_t k, int64_t kchunk) {
  __shared__ __align__(16) float As[kBK][kBM + kPadA];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tx = threadIdx.x % (kBN / 4), ty = threadIdx.x / (kBN / 4);
  // row tiles on grid.x (up to 2^31 - 1), column tiles on grid.y
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kBN;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * kchunk;
  const int64_t k1 = k0 + kchunk < k ? k0 + kchunk : k;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int64_t kk = k0; kk < k1; kk += kBK) {
    load_tiles<T, VEC>(a, b, As, Bs, row0, col0, kk, k1, m, n, k);
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < kBK; ++q) {
      const float4 av = *reinterpret_cast<const float4*>(&As[q][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[q][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  const bool split = gridDim.z > 1;
  float* part = split ? work + static_cast<int64_t>(blockIdx.z) * m * n
                      : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = col0 + tx * 4 + j;
      if (col >= n) continue;
      const int64_t o = row * n + col;
      if (split)
        part[o] = acc[i][j];
      else
        out[o] = from_f<T>(scal[0] * acc[i][j] + scal[1] * to_f(c[o]));
    }
  }
}

}  // namespace repro

// a (m, k), b (k, n), c and out (m, n), all row-major contiguous and of
// one dtype; work (splits, m, n) float32 when splits > 1; scal = {alpha,
// beta} float32 on the device; kchunk = columns of A (rows of B) per
// split, a multiple of 32.
extern "C" int repro_gemm(int dtype, const void* a, const void* b,
                          const void* c, void* out, float* work,
                          const float* scal, int64_t m, int64_t n,
                          int64_t k, int64_t kchunk, int splits,
                          void* stream) {
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int V = repro::vec_width<T>();
    const T* A = static_cast<const T*>(a);
    const T* B = static_cast<const T*>(b);
    const T* C = static_cast<const T*>(c);
    T* O = static_cast<T*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dim3 grid(static_cast<unsigned>((m + repro::kBM - 1) / repro::kBM),
              static_cast<unsigned>((n + repro::kBN - 1) / repro::kBN),
              static_cast<unsigned>(splits));
    const bool vec = k % V == 0 && n % V == 0 && repro::aligned16(a) &&
                     repro::aligned16(b);
    if (vec)
      repro::gemm_kernel<T, true><<<grid, repro::kGemmThreads, 0, s>>>(
          A, B, C, O, work, scal, m, n, k, kchunk);
    else
      repro::gemm_kernel<T, false><<<grid, repro::kGemmThreads, 0, s>>>(
          A, B, C, O, work, scal, m, n, k, kchunk);
    if (splits > 1)
      repro::launch_combine<T>(work, C, O, scal, m * n, splits, s);
  };
  REPRO_DISPATCH(dtype, run);
  return static_cast<int>(cudaGetLastError());
}
