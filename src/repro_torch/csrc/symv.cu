// BLAS level-2 symv (y' = alpha S x + beta y, S symmetric, stored in
// the lower triangle of A) for Hopper (sm_90a), with float32
// accumulation and one rounding to A's dtype at the end. The upper
// triangle of A is never used in arithmetic: it may hold anything,
// NaN included.
//
// Replaces src/repro/kernels/symv.py::symv (pallas_call at symv.py:63,
// body symv_block :23). The TPU kernel streams each (i, j) window with
// its mirror window so that one operand serves both triangles; here each
// lower-triangle tile is read once and serves both of its products.
//
// Bound on an H100 SXM: HBM bytes of the lower triangle, 4 n(n+1)/2 +
// 12 n for float32 (0.1603 ms at n = 16384, 3.35 TB/s).
//
// Design (symv_kernel<T, ROUTE>, then symv_fold_kernel<T>):
// * The lower triangle is cut into 64 x 64 tiles (I, J), I >= J; nt =
//   ceil(n / 64) tile rows. A tile gives S x two terms: the row product
//   A_IJ x_J for rows I and, off the diagonal, the column product
//   A_IJ^T x_I for rows J.
// * A block of 256 threads owns a chunk of one tile column J: up to
//   `len` consecutive tiles I >= J (kernels/symv.py::symv_plan sizes len
//   from n so that the grid holds about 4096 blocks, many waves on 132
//   SMs). Blocks run c-major: chunk c of every column, then chunk c + 1,
//   so the short end chunks of the columns spread over the whole run.
// * Thread (rg, cg) holds rows 4 rg .. 4 rg + 3 and columns 4 cg .. 4 cg
//   + 3 of a tile: 16 elements, each read into registers once and used
//   for both products. Its four column sums accumulate along the walk
//   in registers; its four row sums are summed over the 16 threads of a
//   half warp by five shuffles (a transposing butterfly).
// * Route "tma" (A's base 16-byte aligned and its row 16-byte
//   multiple): one thread keeps a ring of 3 tiles in flight with 2-D
//   cp.async.bulk.tensor copies (L2 evict-first) and mbarriers; the
//   threads read their elements from shared memory. TMA zero-fills past
//   the edge. Route "ldg" (any other A, such as n = 16381 float32 or a
//   view at an odd offset): each thread loads its own 16 elements with
//   masked scalar loads one tile ahead, into the same registers. The
//   wrapper picks and counts the route; the C side refuses a tma map TMA
//   rejects.
// * On a diagonal tile the elements above the diagonal are dropped by a
//   per-element select, never multiplied by a 0/1 mask (0 * NaN is NaN);
//   the diagonal counts once, in the row product.
// * Scratch, float32, (nt + chunks) slots of nt * 64 rows: slot J holds
//   the row products of tiles (I, J) for rows I; slot nt + c the column
//   products of chunk c of each column. Every element is written by one
//   block, once. Written plus read, that is 2 n (nt + 1) / 2 floats
//   beside the triangle's n (n + 1) / 2: 2 / 64 = 3.1% of its bytes in
//   float32 (6.3% in 16 bits).
// * symv_fold_kernel sums each row's slots in one fixed order (eight
//   interleaved partials over slots 0 .. I, then its column's chunks,
//   added in warp order) and applies alpha and beta in float32 with one
//   rounding to T. No float atomics: a result repeats bitwise. The fold
//   is the only place alpha, beta and y enter. repro_symv_acc runs the
//   same mainloop and the same fold with RAW set: it stores the raw
//   float32 S x with no alpha, beta or y, the product of the anchored
//   generator's symv anchor, which a Triton epilogue finishes.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kTile = 64;        // rows and columns of a tile
constexpr int kThreads = 256;    // 16 row groups x 16 column groups
constexpr int kStages = 3;       // tiles in flight per block (tma)
constexpr int kFoldRows = 32;    // rows of a fold block, one a lane
constexpr int kFoldWarps = 8;    // slot classes of a row, one a warp
static_assert(kTile % kFoldRows == 0, "a fold block stays in one tile row");

// routes (kernels/symv.py ROUTES)
enum SymvRoute : int { kTma = 0, kLdg = 1 };

// chunk b of the c-major walk over nt tile columns in chunks of len
// tiles: its column j, its index c in the column, and its tiles [i0, i1)
__device__ __forceinline__ void chunk_of(int64_t b, int64_t nt, int64_t len,
                                         int64_t& j, int64_t& c,
                                         int64_t& i0, int64_t& i1) {
  c = 0;
  while (b >= nt - c * len) {   // nt - c len columns have a chunk c
    b -= nt - c * len;
    ++c;
  }
  j = b;
  i0 = j + c * len;
  i1 = i0 + len < nt ? i0 + len : nt;
}

// the number of blocks of that walk
inline int64_t chunk_count(int64_t nt, int64_t len) {
  int64_t blocks = 0;
  for (int64_t c = 0; c * len < nt; ++c) blocks += nt - c * len;
  return blocks;
}

// this thread's 16 elements of tile (it, jt), zero past the edge
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ a, int64_t n,
                                          int64_t it, int64_t jt, int r0,
                                          int c0, T (&v)[4][4]) {
  const T zero = from_f<T>(0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = it * kTile + r0 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = jt * kTile + c0 + j;
      v[i][j] = row < n && col < n ? a[row * n + col] : zero;
    }
  }
}

template <typename T, int ROUTE>
__global__ void __launch_bounds__(kThreads, 4)
symv_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ a,
            const T* __restrict__ x, float* __restrict__ work, int64_t n,
            int64_t nt, int64_t len) {
  constexpr int kTileBytes = kTile * kTile * static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char ring[];  // [kStages] tiles
  __shared__ uint64_t full[kStages];
  __shared__ __align__(16) float colsum[kTile / 4][kTile];
  const int64_t pitch = nt * kTile;

  int64_t jt, chunk, i0, i1;
  chunk_of(blockIdx.x, nt, len, jt, chunk, i0, i1);
  const int count = static_cast<int>(i1 - i0);
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 4 * (t >> 4), c0 = 4 * (t & 15);   // tile-local

  float xc[4], cacc[4];   // x at this thread's columns; their sums
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t col = jt * kTile + c0 + j;
    xc[j] = col < n ? to_f(x[col]) : 0.f;
    cacc[j] = 0.f;
  }

  uint64_t policy = 0;
  const CUtensorMap* tmap = &map;
  auto issue = [=, &policy](int k) {   // tile i0 + k into stage k % 3
    const int s = k % kStages;
    mbar_expect(full + s, kTileBytes);
    tma_load_2d(ring + s * kTileBytes, tmap, full + s,
                static_cast<int>(jt * kTile),
                static_cast<int>((i0 + k) * kTile), policy);
  };
  T next[4][4];
  if constexpr (ROUTE == kTma) {
    if (t == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                   : "=l"(policy));
      for (int k = 0; k < count && k < kStages; ++k) issue(k);
    }
    __syncthreads();
  } else {
    load_tile(a, n, i0, jt, r0, c0, next);
  }

  for (int k = 0; k < count; ++k) {
    const int64_t it = i0 + k;
    float av[4][4];
    if constexpr (ROUTE == kTma) {
      const int s = k % kStages;
      mbar_wait(full + s, (k / kStages) & 1);
      const T* tile = reinterpret_cast<const T*>(ring + s * kTileBytes);
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(tile + (r0 + i) * kTile + c0, av[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) av[i][j] = to_f(next[i][j]);
      if (k + 1 < count) load_tile(a, n, it + 1, jt, r0, c0, next);
    }
    float xr[4], rs[4];   // x at this thread's rows; the row sums
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = it * kTile + r0 + i;
      xr[i] = row < n ? to_f(x[row]) : 0.f;
      rs[i] = 0.f;
    }
    if (it == jt) {
      // the diagonal tile: row products over c <= r, column products
      // over r > c, each chosen by a select
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + i, c = c0 + j;
          rs[i] = c <= r ? fmaf(av[i][j], xc[j], rs[i]) : rs[i];
          cacc[j] = r > c ? fmaf(av[i][j], xr[i], cacc[j]) : cacc[j];
        }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rs[i] = fmaf(av[i][j], xc[j], rs[i]);
          cacc[j] = fmaf(av[i][j], xr[i], cacc[j]);
        }
    }
    if constexpr (ROUTE == kTma) {
      __syncthreads();   // every thread is done with stage k % kStages
      if (t == 0 && k + kStages < count) issue(k + kStages);
    }
    // the half warp's 16 column groups: lanes with bit 3 keep rows 2, 3
    // and those with bit 2 the odd row of the pair, so that lane 4 q
    // (q = 0..3) of the half ends with the sum of row q
    const bool hi = lane & 8, odd = lane & 4;
    const float k0 = (hi ? rs[2] : rs[0]) +
                     __shfl_xor_sync(0xffffffffu, hi ? rs[0] : rs[2], 8);
    const float k1 = (hi ? rs[3] : rs[1]) +
                     __shfl_xor_sync(0xffffffffu, hi ? rs[1] : rs[3], 8);
    float v = (odd ? k1 : k0) +
              __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    if ((lane & 3) == 0)
      work[jt * pitch + it * kTile + r0 + ((lane >> 2) & 3)] = v;
  }

  // the chunk's column products: the 16 row groups summed in order
  *reinterpret_cast<float4*>(&colsum[t >> 4][c0]) =
      make_float4(cacc[0], cacc[1], cacc[2], cacc[3]);
  __syncthreads();
  if (t < kTile) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kTile / 4; ++g) s += colsum[g][t];
    work[(nt + chunk) * pitch + jt * kTile + t] = s;
  }
}

// out[i] = alpha * (the slots of row i) + beta * y[i], or with RAW the
// float32 sum of the slots alone (no alpha, beta or y). A block folds
// 32 rows, one a lane; warp w sums slots w, w + 8, ... of each row's
// list (row products 0..I, then its column's chunks) in order, and the
// eight partials meet in warp order: a fixed order, with eight loads in
// flight per row where one thread per row would wait on each in turn.
template <typename T, bool RAW>
__global__ void __launch_bounds__(kFoldRows * kFoldWarps)
symv_fold_kernel(const float* __restrict__ work, const T* __restrict__ y,
                 void* __restrict__ out, const float* __restrict__ scal,
                 int64_t n, int64_t nt, int64_t len) {
  __shared__ float part[kFoldWarps][kFoldRows];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kFoldRows;
  const int64_t i = row0 + lane, pitch = nt * kTile;
  const int64_t it = row0 / kTile;   // one tile row for the whole block
  const int64_t count = it + 1 + (nt - it + len - 1) / len;
  float acc = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int64_t q = w; q < count; q += kFoldWarps) {
      const int64_t slot = q <= it ? q : nt + (q - it - 1);
      acc += work[slot * pitch + i];
    }
  }
  part[w][lane] = acc;
  __syncthreads();
  if (w == 0 && i < n) {
    float sum = part[0][lane];
#pragma unroll
    for (int v = 1; v < kFoldWarps; ++v) sum += part[v][lane];
    if constexpr (RAW)
      static_cast<float*>(out)[i] = sum;
    else
      static_cast<T*>(out)[i] =
          from_f<T>(scal[0] * sum + scal[1] * to_f(y[i]));
  }
}

template <typename T, int ROUTE>
int launch_symv(const CUtensorMap& map, const T* a, const T* x, float* work,
                int64_t n, int64_t nt, int64_t len, unsigned blocks,
                cudaStream_t stream) {
  const int smem = ROUTE == kTma ? kStages * kTile * kTile *
                                       static_cast<int>(sizeof(T))
                                 : 0;
  static std::atomic<uint64_t> raised{0};
  const int err = allow_smem(symv_kernel<T, ROUTE>, smem, raised);
  if (err != 0) return err;
  symv_kernel<T, ROUTE><<<blocks, kThreads, smem, stream>>>(map, a, x, work,
                                                           n, nt, len);
  return 0;
}

// both entry points: the mainloop, then the fold (RAW: the raw float32
// S x into out, with no alpha, beta or y)
template <bool RAW>
int run_symv(int dtype, const void* a, const void* x, const void* y,
             void* out, float* work, const float* scal, int64_t n,
             int64_t len, int route, void* stream) {
  if (n < 1 || n > INT_MAX || len < 1 || (route != kTma && route != kLdg))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nt = (n + kTile - 1) / kTile;
  const int64_t blocks = chunk_count(nt, len);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map{};
  if (route == kTma && !matrix_map(&map, dtype, a, n, n, kTile, kTile,
                                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  auto body = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* A = static_cast<const T*>(a);
    const T* X = static_cast<const T*>(x);
    const unsigned grid = static_cast<unsigned>(blocks);
    err = route == kTma
              ? launch_symv<T, kTma>(map, A, X, work, n, nt, len, grid, s)
              : launch_symv<T, kLdg>(map, A, X, work, n, nt, len, grid, s);
    if (err != 0) return;
    symv_fold_kernel<T, RAW>
        <<<static_cast<unsigned>((n + kFoldRows - 1) / kFoldRows),
           kFoldRows * kFoldWarps, 0, s>>>(
            work, static_cast<const T*>(y), out, scal, n, nt, len);
  };
  REPRO_DISPATCH(dtype, body);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// a (n, n) row-major contiguous, its lower triangle read; x, y and out
// (n,) contiguous; scal = {alpha, beta} float32 on the device; len the
// tiles of a chunk (kernels/symv.py::symv_plan); work float32 of
// (nt + ceil(nt / len)) x nt * 64 elements, nt = ceil(n / 64); route 0
// (tma: a's base 16-byte aligned, n times the element size a multiple
// of 16 bytes) or 1 (ldg: any a).
extern "C" int repro_symv(int dtype, const void* a, const void* x,
                          const void* y, void* out, float* work,
                          const float* scal, int64_t n, int64_t len,
                          int route, void* stream) {
  return repro::run_symv<false>(dtype, a, x, y, out, work, scal, n, len,
                                route, stream);
}

// the same product with no alpha, beta or y: acc (n,) float32 = S x
extern "C" int repro_symv_acc(int dtype, const void* a, const void* x,
                              float* acc, float* work, int64_t n,
                              int64_t len, int route, void* stream) {
  return repro::run_symv<true>(dtype, a, x, nullptr, acc, work, nullptr, n,
                               len, route, stream);
}

// The shared memory one block of a kernel requests, static (from
// cudaFuncGetAttributes) plus the dynamic bytes its launch passes, for
// the check of kernels/symv.py's footprint. kernel 0, 1: the mainloop on
// routes tma, ldg; 2, 3: the fold, finished and raw.
extern "C" int repro_symv_smem(int dtype, int kernel, long long* bytes) {
  using repro::kLdg;
  using repro::kTma;
  int err = 0;
  auto body = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    cudaFuncAttributes attr{};
    long long dyn = 0;
    cudaError_t e = cudaErrorInvalidValue;
    switch (kernel) {
      case 0:
        e = cudaFuncGetAttributes(&attr, repro::symv_kernel<T, kTma>);
        dyn = static_cast<long long>(repro::kStages) * repro::kTile *
              repro::kTile * static_cast<long long>(sizeof(T));
        break;
      case 1:
        e = cudaFuncGetAttributes(&attr, repro::symv_kernel<T, kLdg>);
        break;
      case 2:
        e = cudaFuncGetAttributes(&attr,
                                  repro::symv_fold_kernel<T, false>);
        break;
      case 3:
        e = cudaFuncGetAttributes(&attr, repro::symv_fold_kernel<T, true>);
        break;
      default:
        break;
    }
    err = static_cast<int>(e);
    *bytes = static_cast<long long>(attr.sharedSizeBytes) + dyn;
  };
  REPRO_DISPATCH(dtype, body);
  return err;
}
