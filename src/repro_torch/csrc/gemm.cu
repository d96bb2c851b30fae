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
//
// The wgmma route (gemm_wgmma_kernel<T, BM, BN>, entries repro_gemm_wgmma
// and repro_gemm_wgmma_acc): bfloat16 and float16 operands that meet the
// tma route's conditions. The same function as above: the product of two
// 16-bit values is exact in float32 and the tensor cores sum in float32,
// so only the order of the float32 sums differs from the FFMA mainloop
// (the result is not bitwise that route's). float32 never takes it: its
// wgmma is TF32.
//
// Bound on an H100 SXM: at 4096^3 bfloat16, 2 n^3 = 137 GFLOP at 989
// TFLOP/s = 0.139 ms (operations; the bytes, 4 n^2 x 2 = 134 MB, take
// 0.040 ms). At llama3-8b's decode shapes (M = 8) the weight's bytes
// bound it: (4096 x 14336) x 2 = 117 MB at 3.35 TB/s = 0.035 ms.
//
// Design (one consumer warpgroup, no persistence, no cluster):
// * One block of 160 threads owns one (BM, BN) output tile: warps 0-3
//   are the consumer warpgroup, warp 4 the producer. BM = 128 (two m64
//   wgmmas a k-step) or 64 where m <= 64; BN = 128, or 64 where n <= 64.
//   Blocks walk the tiles in groups of kWgGroup row tiles, each group's
//   column tiles in turn, so that the blocks in flight share their A
//   rows and B columns in L2.
// * One thread of the producer warp issues the TMA loads of each stage:
//   A's (BM x 64) box and B's (64 x 64) boxes, all with the 128-byte
//   swizzle, into a ring of 96 KB (BM 64: two blocks an SM) or 192 KB
//   (BM 128), with a full and an empty mbarrier per stage. TMA zero-
//   fills rows past m, columns past n and K past k.
// * A is K-major (row-major (m, k)); B is row-major (k, n), so for wgmma
//   it is MN-major: its descriptor says "transposed" and its leading
//   offset steps from one 64-column box to the next, which is what the
//   TMA map's 64-column boxes and their swizzle lay down.
// * The consumer warpgroup runs wgmma.mma_async m64nBNk16 (both operands
//   in shared memory) into float32 accumulators in registers, four
//   k-steps a stage, and keeps one stage's products in flight: it frees
//   a stage once the next stage's products are issued and the stage's
//   own have completed (wait_group 1).
// * Skinny products (llama3-8b's decode, M = 8) take BM = 64 and TMA's
//   zero fill of the rows past m: the wasted MMA work is hidden under
//   the weight's bytes, which bound them. The wrapper splits K where the
//   tiles leave SMs idle, so that the grid spreads n x k over every SM;
//   the float32 partials fold in the fixed-order combine (no atomics).
// * Epilogue from registers: alpha acc + beta C in float32 (beta C even
//   at beta 0), rounded once to T; or the raw float32 sum (a split's
//   partial, or the tiled generator's product).
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

// ---------------------------------------------------------------------------
// wgmma route: bfloat16 and float16 on the tensor cores, fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWgBK = 64;           // K per stage: one 128-byte swizzled row
constexpr int kWgBox = 64;          // columns of one swizzled B box
constexpr int kWgRow = 128;         // bytes of a swizzled row
constexpr int kWgConsumers = 128;   // the consumer warpgroup, warps 0-3
constexpr int kWgThreads = kWgConsumers + 32;   // and the producer warp
constexpr int kWgGroup = 16;        // row tiles a column sweep walks at once

template <int BM, int BN>
struct WgGemmTile {
  static constexpr int MT = BM / 64;                      // m64 wgmmas
  static constexpr int NB = BN / kWgBox;                  // B boxes
  static constexpr uint32_t kABytes = BM * kWgRow;        // (BM x 64) of A
  static constexpr uint32_t kBBytes = kWgBK * BN * 2;     // (64 x BN) of B
  static constexpr uint32_t kStage = kABytes + kBBytes;
  // BM 64: two blocks an SM (the skinny, byte-bound products)
  static constexpr int kRing = BM == 64 ? 96 * 1024 : 192 * 1024;
  static constexpr int ST = kRing / kStage < kMaxStages
                                ? static_cast<int>(kRing / kStage)
                                : kMaxStages;
  static constexpr int kSmem = 1024 + ST * kStage + 2 * ST * 8;
  static_assert((BM == 64 || BM == 128) && (BN == 64 || BN == 128),
                "wgmma tiles: BM and BN of 64 or 128");
  static_assert(kSmem <= 232448, "shared memory per block");
};

// d += A B for one m64nNk16 k-step: A (64 x 16) K-major and B (16 x N)
// MN-major ("transposed"), both in 128-byte swizzled shared memory;
// float32 accumulators d as in attention.cu's Wgmma (N / 2 a thread)
template <typename T, int N>
struct GemmMma;

#define REPRO_GEMM_MMA(CT, TY)                                            \
  template <>                                                             \
  struct GemmMma<CT, 64> {                                                \
    static __device__ __forceinline__ void ss(float* d, uint64_t a,       \
                                              uint64_t b) {               \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                    \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "     \
          "{" REPRO_R32 "}, "                                             \
          "%32, %33, p, 1, 1, 0, 1;\n}\n"                                 \
          : REPRO_D32                                                     \
          : "l"(a), "l"(b), "r"(1));                                      \
    }                                                                     \
  };                                                                      \
  template <>                                                             \
  struct GemmMma<CT, 128> {                                               \
    static __device__ __forceinline__ void ss(float* d, uint64_t a,       \
                                              uint64_t b) {               \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                    \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "    \
          "{" REPRO_R64 "}, "                                             \
          "%64, %65, p, 1, 1, 0, 1;\n}\n"                                 \
          : REPRO_D64                                                     \
          : "l"(a), "l"(b), "r"(1));                                      \
    }                                                                     \
  };

REPRO_GEMM_MMA(__nv_bfloat16, "bf16")
REPRO_GEMM_MMA(__half, "f16")
#undef REPRO_GEMM_MMA

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const T* __restrict__ c, T* __restrict__ out,
                  float* __restrict__ work, const float* __restrict__ scal,
                  int m, int n, int k, int kchunk, int mode) {
  using Tile = WgGemmTile<BM, BN>;
  constexpr int ST = Tile::ST, MT = Tile::MT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled boxes start on 1024-byte boundaries
  unsigned char* ring =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* a_ring = ring;                        // [ST][BM][128 B]
  unsigned char* b_ring = ring + ST * Tile::kABytes;   // [ST][NB][64][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_ring + ST * Tile::kBBytes);
  uint64_t* empty = full + ST;

  // tile t of grid.x: groups of kWgGroup row tiles, each group's column
  // tiles in turn, the group's rows fastest; K splits on grid.z
  const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int per_group = kWgGroup * tiles_n;
  const int t = static_cast<int>(blockIdx.x);
  const int first = t / per_group * kWgGroup;
  const int rows = min(tiles_m - first, kWgGroup);
  const int row0 = (first + (t % per_group) % rows) * BM;
  const int col0 = (t % per_group) / rows * BN;
  const int k0 = static_cast<int>(blockIdx.z) * kchunk;
  const int k1 = min(k0 + kchunk, k);
  const int nk = (k1 - k0 + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWgConsumers / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kWgConsumers / 32) {
    // ---- producer warp: one thread fills stage kt % ST with K tile kt;
    // a chunk is whole stages, so no box reaches into the next split ----
    if (lane != 0) return;
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                 : "=l"(policy));
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST, kb = k0 + kt * kWgBK;
      mbar_wait(empty + s, ((kt / ST) & 1) ^ 1);   // round 0 passes
      mbar_expect(full + s, Tile::kStage);
      tma_load_2d(a_ring + s * Tile::kABytes, &ta, full + s, kb, row0,
                  policy);
#pragma unroll
      for (int j = 0; j < Tile::NB; ++j)
        tma_load_2d(b_ring + s * Tile::kBBytes + j * kWgBK * kWgRow, &tb,
                    full + s, col0 + j * kWgBox, kb, policy);
    }
    return;
  }

  // ---- the consumer warpgroup ----
  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
  const uint32_t a_base = smem_addr(a_ring), b_base = smem_addr(b_ring);

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    mbar_wait(full + s, (kt / ST) & 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) pin<BN / 2>(acc[mt]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // B: 16 rows of K from row 16 kk of every box; the boxes lie
      // kWgBK rows apart (the leading offset), 8-row groups 1024 bytes
      const uint64_t bd = sw128_desc(
          b_base + s * Tile::kBBytes + kk * 16 * kWgRow, kWgBK * kWgRow,
          8 * kWgRow);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        GemmMma<T, BN>::ss(
            acc[mt],
            sw128_desc(a_base + s * Tile::kABytes + mt * 64 * kWgRow +
                           kk * 32, 16, 8 * kWgRow),
            bd);
    }
    wg_commit();
    if (kt > 0) {   // the previous stage's products are done: free it
      wg_wait<1>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pin<BN / 2>(acc[mt]);
      if (lane == 0) mbar_arrive(empty + (kt - 1) % ST);
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) pin<BN / 2>(acc[mt]);

  // ---- epilogue from registers: of n-tile j, acc[4j], acc[4j + 1] are
  // row g and acc[4j + 2], acc[4j + 3] row g + 8 of the warp's 16,
  // columns 8j + 2 (lane % 4) + {0, 1}; n is a multiple of 8, so a pair
  // lies wholly inside or outside it ----
  const float alpha = mode == kFinish ? scal[0] : 0.f;
  const float beta = mode == kFinish ? scal[1] : 0.f;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t zoff = static_cast<int64_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + mt * 64 + warp * 16 + g + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j + 2 * t4;
        if (col >= n) continue;
        const float v0 = acc[mt][4 * j + 2 * h];
        const float v1 = acc[mt][4 * j + 2 * h + 1];
        const int64_t o = static_cast<int64_t>(row) * n + col;
        if (mode == kRaw) {
          *reinterpret_cast<float2*>(work + zoff + o) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(out + o) =
              Pair<T>::pack(alpha * v0 + beta * to_f(c[o]),
                            alpha * v1 + beta * to_f(c[o + 1]));
        }
      }
    }
}

template <typename T, int BM, int BN>
int launch_gemm_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                      const T* c, T* out, float* work, const float* scal,
                      int64_t m, int64_t n, int64_t k, int64_t kchunk,
                      int splits, int mode, cudaStream_t stream) {
  using Tile = WgGemmTile<BM, BN>;
  static std::atomic<uint64_t> raised{0};
  const int err =
      allow_smem(gemm_wgmma_kernel<T, BM, BN>, Tile::kSmem, raised);
  if (err != 0) return err;
  const int64_t tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const dim3 grid(static_cast<unsigned>(tiles), 1,
                  static_cast<unsigned>(splits));
  gemm_wgmma_kernel<T, BM, BN><<<grid, kWgThreads, Tile::kSmem, stream>>>(
      ta, tb, c, out, work, scal, static_cast<int>(m), static_cast<int>(n),
      static_cast<int>(k), static_cast<int>(kchunk), mode);
  return 0;
}

// instantiate `body` (a lambda over a typed null pointer) for a 16-bit
// dtype code; cudaErrorInvalidValue for any other
#define REPRO_DISPATCH16(dtype, body)                            \
  switch (dtype) {                                               \
    case repro::kBF16:                                           \
      body(static_cast<__nv_bfloat16*>(nullptr));                \
      break;                                                     \
    case repro::kF16: body(static_cast<__half*>(nullptr)); break; \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }

// one launch of the wgmma family: tile (bm, bn), the K of a split
// `kchunk` (whole stages), `splits` of them on grid.z
inline int run_gemm_wgmma(int dtype, const void* a, const void* b,
                          const void* c, void* out, float* work,
                          const float* scal, int64_t m, int64_t n,
                          int64_t k, int64_t bm, int64_t bn, int64_t kchunk,
                          int splits, int mode, cudaStream_t stream) {
  if ((bm != 64 && bm != 128) || (bn != 64 && bn != 128) || splits < 1 ||
      splits > 65535 || kchunk < 1 || kchunk % kWgBK != 0 || m < 1 ||
      n < 1 || k < 1 || m > INT_MAX || n > INT_MAX || k > INT_MAX ||
      n % 8 != 0 || k % 8 != 0 ||
      ((m + bm - 1) / bm) * ((n + bn - 1) / bn) > INT_MAX ||
      (splits - 1) * kchunk >= k)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta{}, tb{};
  if (!matrix_map(&ta, dtype, a, m, k, kWgBox, static_cast<int>(bm),
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !matrix_map(&tb, dtype, b, k, n, kWgBox, kWgBK,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* C = static_cast<const T*>(c);
    T* O = static_cast<T*>(out);
    if (bm == 64 && bn == 64)
      err = launch_gemm_wgmma<T, 64, 64>(ta, tb, C, O, work, scal, m, n, k,
                                         kchunk, splits, mode, stream);
    else if (bm == 64)
      err = launch_gemm_wgmma<T, 64, 128>(ta, tb, C, O, work, scal, m, n, k,
                                          kchunk, splits, mode, stream);
    else if (bn == 64)
      err = launch_gemm_wgmma<T, 128, 64>(ta, tb, C, O, work, scal, m, n,
                                          k, kchunk, splits, mode, stream);
    else
      err = launch_gemm_wgmma<T, 128, 128>(ta, tb, C, O, work, scal, m, n,
                                           k, kchunk, splits, mode, stream);
  };
  REPRO_DISPATCH16(dtype, run);
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

// C' = alpha A B + beta C on the wgmma route: dtype bfloat16 or float16;
// the operands as for repro_gemm on its tma route (bases 16-byte aligned,
// k and n multiples of 8, sizes within int32); bm 64 or 128 and bn 64 or
// 128 the tile; kchunk the K of one split, a multiple of 64; work
// (splits, m, n) float32 when splits > 1, folded by the combine.
extern "C" int repro_gemm_wgmma(int dtype, const void* a, const void* b,
                                const void* c, void* out, float* work,
                                const float* scal, int64_t m, int64_t n,
                                int64_t k, int64_t bm, int64_t bn,
                                int64_t kchunk, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = splits > 1 ? repro::kRaw : repro::kFinish;
  int err = repro::run_gemm_wgmma(dtype, a, b, c, out, work, scal, m, n, k,
                                  bm, bn, kchunk, splits, mode, s);
  if (err != 0) return err;
  if (splits > 1) {
    auto fold = [&](auto* tag) {
      using T = std::remove_pointer_t<decltype(tag)>;
      repro::launch_combine<T>(work, static_cast<const T*>(c),
                               static_cast<T*>(out), scal, m * n, splits,
                               s);
    };
    REPRO_DISPATCH16(dtype, fold);
  }
  return static_cast<int>(cudaGetLastError());
}

// The raw float32 product A B on the wgmma route, one (m, n) partial per
// split of K, into acc (splits, m, n); the operands, tile and split as
// for repro_gemm_wgmma. The caller sums the partials in split order.
extern "C" int repro_gemm_wgmma_acc(int dtype, const void* a, const void* b,
                                    float* acc, int64_t m, int64_t n,
                                    int64_t k, int64_t bm, int64_t bn,
                                    int64_t kchunk, int splits,
                                    void* stream) {
  int err = repro::run_gemm_wgmma(dtype, a, b, nullptr, nullptr, acc,
                                  nullptr, m, n, k, bm, bn, kchunk, splits,
                                  repro::kRaw,
                                  static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The shared memory one block of the wgmma kernel at tile (bm, bn)
// requests, static plus dynamic, as repro_gemm_smem reports the FFMA
// mainloop's.
extern "C" int repro_gemm_wgmma_smem(int dtype, int bm, int bn,
                                     long long* bytes) {
  int err = 0;
  auto body = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    cudaFuncAttributes attr{};
    long long dyn = 0;
    cudaError_t e = cudaErrorInvalidValue;
    if (bm == 64 && bn == 64) {
      e = cudaFuncGetAttributes(&attr, repro::gemm_wgmma_kernel<T, 64, 64>);
      dyn = repro::WgGemmTile<64, 64>::kSmem;
    } else if (bm == 64 && bn == 128) {
      e = cudaFuncGetAttributes(&attr, repro::gemm_wgmma_kernel<T, 64, 128>);
      dyn = repro::WgGemmTile<64, 128>::kSmem;
    } else if (bm == 128 && bn == 64) {
      e = cudaFuncGetAttributes(&attr, repro::gemm_wgmma_kernel<T, 128, 64>);
      dyn = repro::WgGemmTile<128, 64>::kSmem;
    } else if (bm == 128 && bn == 128) {
      e = cudaFuncGetAttributes(&attr,
                                repro::gemm_wgmma_kernel<T, 128, 128>);
      dyn = repro::WgGemmTile<128, 128>::kSmem;
    }
    err = static_cast<int>(e);
    *bytes = static_cast<long long>(attr.sharedSizeBytes) + dyn;
  };
  REPRO_DISPATCH16(dtype, body);
  return err;
}
