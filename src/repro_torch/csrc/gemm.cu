// BLAS level-3 gemm (C' = alpha A B + beta C) for Hopper (sm_90a), with
// a float32 accumulator and one rounding to C's dtype at the end; and the
// raw float32 product A B that the tiled generator's epilogue finishes.
//
// Replaces src/repro/kernels/gemm.py::gemm (pallas_call at gemm.py:69,
// body gemm_block :23; matmul :91 calls it with alpha = 1, beta = 0),
// and the contraction of the tiled generator's kernel
// (src/repro/core/codegen.py::make_tiled_callable, pallas_call :934),
// which splices the same block body. As there, A and B are widened to
// float32, every product is a float32 FFMA (no TF32, no tensor cores:
// float32 wgmma is TF32, and the reference product is full float32),
// alpha and beta are float32, and beta * C is computed even when beta
// is 0 (block-CG passes P as C with beta = 0).
//
// Bound on an H100 SXM, at block-CG's shape (16384 x 16384) . (16384 x
// 32) float32: HBM bytes 4 (n^2 + 3ns) = 1.08 GB at 3.35 TB/s = 0.322
// ms; float32 FFMA 2 n^2 s = 17.2 GFLOP at 67 TFLOP/s = 0.256 ms. The
// kernel sits near the ridge: it must stream A once at close to the full
// HBM rate and keep the FFMA pipes busy at the same time.
//
// Design (one kernel family, gemm_kernel<T, BN>):
// * One block of 384 threads owns one (128, BN) output tile, BN = 32, 64
//   or 128 after n, and walks its share of K in stages of 128 bytes of
//   K per row of A (32 float32 or 64 16-bit elements). The loop over K
//   inside the block takes the place of the TPU's sequential `kk` grid
//   axis. At block-CG's shape that is 128 blocks on 132 SMs, one each,
//   with no split of K and no second launch.
// * A ring of up to 8 stages in shared memory, each holding a (128 x 128
//   bytes) tile of A and the (BK x BN) tile of B beside it, keeps
//   120-190 KB of loads in flight per SM (Little's law asks for about
//   25-50 KB at 1/132 of the HBM rate). Each stage has a "full" and an
//   "empty" mbarrier; a phase parity runs over the ring's wrap-around.
// * Warp specialisation: warpgroup 0 produces, warpgroups 1-2 consume.
//   Route "tma" (bases 16-byte aligned, k and n times the element size
//   multiples of 16 bytes): one producer thread issues two
//   cp.async.bulk.tensor 2-D copies per stage, A with a 128-byte swizzle
//   and an L2 evict-first policy (it streams through once), B unswizzled
//   with evict-last (every row tile reads it again). TMA zero-fills rows
//   and columns past the edge. Route "ldg" (any other alignment, such as
//   k = 16379 floats): the 128 producer threads load the same tiles with
//   ordinary masked loads and store them in the same swizzled layout, so
//   the consumers run the same code. The wrapper picks the route from
//   shape, dtype and alignment (kernels/gemm.py::gemm_route), and counts
//   it; the C side never switches.
// * Consumers: each thread owns 8 rows x 8 columns of the tile (rows ty +
//   16 i, columns 4 tx + q and BN / 2 + 4 tx + q), and the 256 threads
//   split each stage's K into KS = 4, 2 or 1 slices (BN 32, 64, 128), so
//   that every thread holds 64 accumulators at any BN. Per 16-byte chunk
//   of K it reads eight rows of A with one LDS.128 each and, per K, its
//   eight B columns with two loads: 16 shared loads per 256 FFMA in
//   float32. The swizzle puts a warp's eight rows of one chunk on eight
//   different bank groups (chunk ^ (row & 7)), so those reads do not
//   collide; no transposing stores.
// * Epilogue: the KS slices' tiles meet in shared memory and are summed
//   in slice order, then C' = alpha acc + beta C is rounded once to T
//   (or the float32 sum is written raw). Where the output tiles leave
//   most SMs idle (a short, wide product with a long K), the wrapper
//   splits K over grid.z, each split writes float32 partials and the
//   fixed-order combine of common.cuh folds them. No float atomics: a
//   result repeats bitwise.
// * Offsets are 64-bit; the kernel allocates nothing, the wrapper passes
//   any scratch.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kGemmBM = 128;               // output rows per block
constexpr int kRowBytes = 128;             // K bytes of one A row per stage
constexpr int kChunks = kRowBytes / 16;    // 16-byte chunks of that row
constexpr int kProducers = 128;            // warpgroup 0
constexpr int kConsumers = 256;            // warpgroups 1 and 2
constexpr int kGemmThreads = kProducers + kConsumers;
constexpr int kRingBytes = 200 * 1024;
constexpr int kMaxStages = 8;

// routes (kernels/gemm.py ROUTES) and what the epilogue writes
enum GemmRoute : int { kTma = 0, kLdg = 1 };
enum GemmOut : int { kFinish = 0, kRaw = 1 };

template <typename T, int BN>
struct GemmTile {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int BK = kRowBytes / kSize;       // K per stage
  static constexpr int EPC = 16 / kSize;             // K per chunk
  static constexpr int TX = BN / 8;                  // column groups
  static constexpr int SLICE = (kGemmBM / 8) * TX;   // threads per slice
  static constexpr int KS = kConsumers / SLICE;      // K slices
  static constexpr int CPS = kChunks / KS;           // chunks per slice
  static constexpr int kABytes = kGemmBM * kRowBytes;
  static constexpr int kBBytes = BK * BN * kSize;
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int ST = kRingBytes / kStage < kMaxStages
                                ? kRingBytes / kStage
                                : kMaxStages;
  static constexpr int kPitch = BN + 4;              // staged output row
  static constexpr int kSmem = 1024 + ST * kStage + 2 * ST * 8;
  static_assert(KS * SLICE == kConsumers && KS * CPS == kChunks,
                "the slices must cover the consumers and the chunks");
  static_assert(KS * kGemmBM * kPitch * 4 <= ST * kStage,
                "the staged output must fit in the ring");
  static_assert(kSmem <= 232448, "shared memory per block");
};

template <typename T, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb,
            const T* __restrict__ a, const T* __restrict__ b,
            const T* __restrict__ c, T* __restrict__ out,
            float* __restrict__ work, const float* __restrict__ scal,
            int64_t m, int64_t n, int64_t k, int64_t kchunk, int route,
            int mode) {
  using Tile = GemmTile<T, BN>;
  constexpr int BK = Tile::BK, EPC = Tile::EPC, ST = Tile::ST;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled A tiles start on 1024-byte boundaries
  unsigned char* ring =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* a_ring = ring;                          // [ST][128][128 B]
  unsigned char* b_ring = ring + ST * Tile::kABytes;     // [ST][BK][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * Tile::kStage);
  uint64_t* empty = full + ST;

  // row tiles on grid.x (up to 2^31 - 1), column tiles on grid.y, K
  // splits on grid.z
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kGemmBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * kchunk;
  const int64_t k1 = k0 + kchunk < k ? k0 + kchunk : k;
  const int nk = static_cast<int>((k1 - k0 + BK - 1) / BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, route == kTma ? 1 : kProducers);
      mbar_init(empty + s, kConsumers / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kProducers) {
    // ---- producer warpgroup: fill stage kt % ST with K tile kt ----
    if (route == kTma) {
      if (threadIdx.x != 0) return;
      uint64_t stream, keep;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                   : "=l"(stream));
      asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                   : "=l"(keep));
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        mbar_wait(empty + s, ((kt / ST) & 1) ^ 1);   // round 0 passes
        mbar_expect(full + s, Tile::kStage);
        const int kb = static_cast<int>(k0) + kt * BK;
        tma_load_2d(a_ring + s * Tile::kABytes, &ta, full + s, kb,
                    static_cast<int>(row0), stream);
        tma_load_2d(b_ring + s * Tile::kBBytes, &tb, full + s,
                    static_cast<int>(col0), kb, keep);
      }
      return;
    }
    const int pt = threadIdx.x;
    const T zero = from_f<T>(0.f);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST;
      mbar_wait(empty + s, ((kt / ST) & 1) ^ 1);
      const int64_t kb = k0 + static_cast<int64_t>(kt) * BK;
      unsigned char* at = a_ring + s * Tile::kABytes;
      T* bt = reinterpret_cast<T*>(b_ring + s * Tile::kBBytes);
      // A: consecutive threads on consecutive K of one row; stored as
      // TMA's 128-byte swizzle would store it
#pragma unroll 8
      for (int e = pt; e < kGemmBM * BK; e += kProducers) {
        const int r = e / BK, q = e % BK;
        const int64_t row = row0 + r, kq = kb + q;
        const T v = row < m && kq < k1 ? a[row * k + kq] : zero;
        *reinterpret_cast<T*>(at + r * kRowBytes +
                              ((q / EPC) ^ (r & 7)) * 16 +
                              (q % EPC) * Tile::kSize) = v;
      }
#pragma unroll 8
      for (int e = pt; e < BK * BN; e += kProducers) {
        const int q = e / BN, cc = e % BN;
        const int64_t kq = kb + q, col = col0 + cc;
        bt[e] = kq < k1 && col < n ? b[kq * n + col] : zero;
      }
      mbar_arrive(full + s);   // release: the stores above come first
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int ct = threadIdx.x - kProducers;
  const int slice = ct / Tile::SLICE, st = ct % Tile::SLICE;
  const int tx = st % Tile::TX, ty = st / Tile::TX;   // ty in 0..15
  const int lane = ct % 32;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    mbar_wait(full + s, (kt / ST) & 1);
    const unsigned char* at = a_ring + s * Tile::kABytes;
    const T* bt = reinterpret_cast<const T*>(b_ring + s * Tile::kBBytes);
#pragma unroll
    for (int ch = 0; ch < Tile::CPS; ++ch) {
      const int chunk = slice * Tile::CPS + ch;
      // rows ty + 16 i all sit at row & 7 == ty & 7 of the swizzle
      const unsigned char* arow = at + ty * kRowBytes +
                                  ((chunk ^ (ty & 7)) * 16);
      uint4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const uint4*>(arow + 16 * i * kRowBytes);
      const T* brow = bt + chunk * EPC * BN + 4 * tx;
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        float bv[8];
        load4(brow + e * BN, bv);
        load4(brow + e * BN + BN / 2, bv + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av_ie = to_f(reinterpret_cast<const T*>(&av[i])[e]);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av_ie, bv[j], acc[i][j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

  // ---- epilogue: the slices meet in the (now idle) ring ----
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  float* staged = reinterpret_cast<float*>(ring);   // [KS][128][kPitch]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(
          staged + (slice * kGemmBM + ty + 16 * i) * Tile::kPitch + 4 * tx +
          h * (BN / 2)) = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                      acc[i][4 * h + 2], acc[i][4 * h + 3]);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  const float alpha = mode == kFinish ? scal[0] : 0.f;
  const float beta = mode == kFinish ? scal[1] : 0.f;
  for (int e = ct; e < kGemmBM * BN; e += kConsumers) {
    const int r = e / BN, cc = e % BN;
    const int64_t row = row0 + r, col = col0 + cc;
    if (row >= m || col >= n) continue;
    float v = staged[r * Tile::kPitch + cc];
#pragma unroll
    for (int q = 1; q < Tile::KS; ++q)
      v += staged[(q * kGemmBM + r) * Tile::kPitch + cc];
    const int64_t o = row * n + col;
    if (mode == kRaw)
      work[static_cast<int64_t>(blockIdx.z) * m * n + o] = v;
    else
      out[o] = from_f<T>(alpha * v + beta * to_f(c[o]));
  }
}

template <typename T, int BN>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const T* a,
                const T* b, const T* c, T* out, float* work,
                const float* scal, int64_t m, int64_t n, int64_t k,
                int64_t kchunk, int splits, int route, int mode,
                cudaStream_t stream) {
  using Tile = GemmTile<T, BN>;
  static std::atomic<uint64_t> raised{0};
  const int err = allow_smem(gemm_kernel<T, BN>, Tile::kSmem, raised);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((m + kGemmBM - 1) / kGemmBM),
                  static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>(splits));
  gemm_kernel<T, BN><<<grid, kGemmThreads, Tile::kSmem, stream>>>(
      ta, tb, a, b, c, out, work, scal, m, n, k, kchunk, route, mode);
  return 0;
}

// the tensor maps of the tma route: A (m, k) in boxes of 128 bytes of K
// by 128 rows, 128-byte swizzle; B (k, n) in boxes of BN columns by BK
// rows, unswizzled. False where TMA refuses the operands.
inline bool gemm_maps(CUtensorMap* ta, CUtensorMap* tb, int dtype,
                      const void* a, const void* b, int64_t m, int64_t n,
                      int64_t k, int bn) {
  const int size = dtype == kF32 ? 4 : 2;
  return matrix_map(ta, dtype, a, m, k, kRowBytes / size, kGemmBM,
                    CU_TENSOR_MAP_SWIZZLE_128B) &&
         matrix_map(tb, dtype, b, k, n, bn, kRowBytes / size,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// one launch of the family for dtype code `dtype` and tile width bn
inline int run_gemm(int dtype, const void* a, const void* b, const void* c,
                    void* out, float* work, const float* scal, int64_t m,
                    int64_t n, int64_t k, int64_t bn, int64_t kchunk,
                    int splits, int route, int mode, cudaStream_t stream) {
  if ((bn != 32 && bn != 64 && bn != 128) || (route != kTma &&
      route != kLdg) || splits < 1 || kchunk < 1 || m < 1 || n < 1 ||
      k < 1 || (n + bn - 1) / bn > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta{}, tb{};
  if (route == kTma &&
      (m > INT_MAX || n > INT_MAX || k > INT_MAX ||
       !gemm_maps(&ta, &tb, dtype, a, b, m, n, k, static_cast<int>(bn))))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* A = static_cast<const T*>(a);
    const T* B = static_cast<const T*>(b);
    const T* C = static_cast<const T*>(c);
    T* O = static_cast<T*>(out);
    auto go = [&](auto w) {   // w: std::integral_constant, the tile width
      err = launch_gemm<T, decltype(w)::value>(ta, tb, A, B, C, O, work,
                                               scal, m, n, k, kchunk,
                                               splits, route, mode, stream);
    };
    if (bn == 32)
      go(std::integral_constant<int, 32>{});
    else if (bn == 64)
      go(std::integral_constant<int, 64>{});
    else
      go(std::integral_constant<int, 128>{});
  };
  REPRO_DISPATCH(dtype, run);
  return err;
}

}  // namespace repro

// C' = alpha A B + beta C: a (m, k), b (k, n), c and out (m, n), all
// row-major contiguous and of one dtype; scal = {alpha, beta} float32
// on the device; bn the tile width (32, 64 or 128); kchunk the K of one
// split, a multiple of the stage's K (128 bytes of elements); work
// (splits, m, n) float32 when splits > 1, folded by the combine; route
// 0 (tma: bases 16-byte aligned, k and n times the element size
// multiples of 16 bytes, sizes within int32) or 1 (ldg: any operands).
extern "C" int repro_gemm(int dtype, const void* a, const void* b,
                          const void* c, void* out, float* work,
                          const float* scal, int64_t m, int64_t n,
                          int64_t k, int64_t bn, int64_t kchunk, int splits,
                          int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = splits > 1 ? repro::kRaw : repro::kFinish;
  int err = repro::run_gemm(dtype, a, b, c, out, work, scal, m, n, k, bn,
                            kchunk, splits, route, mode, s);
  if (err != 0) return err;
  if (splits > 1) {
    auto fold = [&](auto* tag) {
      using T = std::remove_pointer_t<decltype(tag)>;
      repro::launch_combine<T>(work, static_cast<const T*>(c),
                               static_cast<T*>(out), scal, m * n, splits,
                               s);
    };
    REPRO_DISPATCH(dtype, fold);
  }
  return static_cast<int>(cudaGetLastError());
}

// The raw float32 product A B, one (m, n) partial per split of K, into
// acc (splits, m, n); the same operands, tile width, split and routes as
// repro_gemm. The caller sums the partials in split order.
extern "C" int repro_gemm_acc(int dtype, const void* a, const void* b,
                              float* acc, int64_t m, int64_t n, int64_t k,
                              int64_t bn, int64_t kchunk, int splits,
                              int route, void* stream) {
  int err = repro::run_gemm(dtype, a, b, nullptr, nullptr, acc, nullptr, m,
                            n, k, bn, kchunk, splits, route, repro::kRaw,
                            static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The shared memory one block of a kernel requests, static (from
// cudaFuncGetAttributes) plus the dynamic bytes its launch passes, for
// the check of kernels/gemm.py's footprint: `width` 32, 64 or 128 for
// the mainloop at that tile width, 0 for the split combine.
extern "C" int repro_gemm_smem(int dtype, int width, long long* bytes) {
  int err = 0;
  auto body = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    cudaFuncAttributes attr{};
    long long dyn = 0;
    cudaError_t e = cudaErrorInvalidValue;
    if (width == 32) {
      e = cudaFuncGetAttributes(&attr, repro::gemm_kernel<T, 32>);
      dyn = repro::GemmTile<T, 32>::kSmem;
    } else if (width == 64) {
      e = cudaFuncGetAttributes(&attr, repro::gemm_kernel<T, 64>);
      dyn = repro::GemmTile<T, 64>::kSmem;
    } else if (width == 128) {
      e = cudaFuncGetAttributes(&attr, repro::gemm_kernel<T, 128>);
      dyn = repro::GemmTile<T, 128>::kSmem;
    } else if (width == 0) {
      e = cudaFuncGetAttributes(&attr, repro::combine_kernel<T>);
    }
    err = static_cast<int>(e);
    *bytes = static_cast<long long>(attr.sharedSizeBytes) + dyn;
  };
  REPRO_DISPATCH(dtype, body);
  return err;
}
