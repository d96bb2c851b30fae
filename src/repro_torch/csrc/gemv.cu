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
// gemv, one launch per call at every shape, alpha and beta by value
// (or, for a tensor operand, read on the card from a float32 block):
// * Where the rows alone fill the card (kernels/gemv.py::gemv_plan: 8
//   blocks of 8 rows per SM, m > 8440 on 132 SMs), route "rows"
//   (gemv_rows_kernel): one warp per row, lanes walk the row in 16-byte
//   loads (evict-first, A is read once), x through the read-only cache;
//   a scalar path with coalesced loads where n is not a multiple of the
//   16-byte width or a base is not 16-byte aligned. No fold. At 16384^2
//   it beat the band kernel with one chunk (tools/sweep_gemv.py).
// * Otherwise (a short, wide A: GMRES's (21, n) basis, (31, 2^20)) the
//   band kernel (gemv_band_kernel<T, ROUTE>): a block owns a band of up
//   to 32 rows and a chunk of whole 512-byte column tiles (32 lanes x
//   16 bytes); chunk c of C walks tiles c, c + C, c + 2C, ..., so that
//   a band's chunks read neighbouring tiles at once. A stage is the
//   band's rows of one tile plus that tile of x, so x is read once per
//   band and reused for every row of it. Route "tma" (A's and x's bases
//   16-byte aligned, a row a 16-byte multiple): one thread keeps a ring
//   of `stages` stages in flight with 2-D cp.async.bulk.tensor copies
//   (A L2 evict-first, x evict-last) and mbarriers; TMA zero-fills past
//   the edges. Route "ldg" (any other A or x): masked loads into the
//   same registers. Warp w takes rows w, w + 8, ... of the band, a lane
//   its 16 bytes of columns, one float32 accumulator per row; a warp
//   butterfly ends each row.
// * The fold across a band's column chunks is in the same launch, in one
//   fixed order and with no float atomics, so a result repeats bitwise
//   (design (a), a last-block ticket): each block writes its rows'
//   partials into the call's float32 scratch (chunks, m), then one
//   thread takes the band's ticket with an acq_rel atomic (after
//   __syncthreads, so it releases the block's writes); the block that
//   takes the last ticket folds chunks 0..C-1 in order (lane l adds
//   chunks l, l + 32, ... in order, its loads issued before the adds,
//   then a butterfly), applies alpha and beta, stores, and resets the
//   ticket to 0 for the next call. The tickets live in a buffer kept
//   per device and stream for eager launches, and per capture and
//   stream under CUDA-graph capture (kernels/gemv.py::tickets), zeroed
//   once when it is allocated (in a capture, by a memset the graph
//   replays), so no call needs a memset of its own. A cooperative
//   launch (a grid barrier, then each block folds its rows) would hold
//   every block until the slowest arrives; with a ticket the early
//   blocks exit and only the last one waits.
// * Grid (kernels/gemv.py::gemv_plan): bands of at most 32 rows, as
//   even as they go; C the smaller of half a band's tiles (a chunk
//   holds at least 2) and one block per SM over the bands; a ring of 4
//   stages. (31, 2^20) float32: 132 chunks of 62-63 tiles; GMRES's
//   (21, 16384): 64 chunks of 2. tools/sweep_gemv.py chose them on an
//   H100 (PERF.md): 2 or more blocks per SM, rings of 2, 3, 6 or 8
//   stages, and chunks of 1 or 4 tiles at (21, 16384) all lost. The
//   time at (31, n) is about 4.8 us (launch, the first stage, the fold)
//   plus the bytes at 3.245 TB/s.
//
// gemvt (gemvt_kernel<T, ROUTE, RAW>), one launch and no float32
// scratch:
// * A is row-major but the output runs over its columns. A block owns a
//   column tile of 512 bytes (128 float32 or 256 16-bit columns: 32
//   lanes x 16 bytes) and walks rows; warp w takes rows w, w + 8, ...
//   of each 32-row stage, a lane its 16 bytes of columns, x[r]
//   broadcast to the warp. A^T is never formed.
// * Route "tma" (A's base 16-byte aligned, a row a 16-byte multiple):
//   one thread keeps a ring of 4 stages (32 rows x 512 bytes, 16 KB;
//   64 KB a block, above the 48 KB that needs no opt-in) in flight
//   with 2-D cp.async.bulk.tensor copies (L2 evict-first) and
//   mbarriers; the lanes read
//   their 16 bytes from shared memory (a warp reads 512 contiguous
//   bytes: no bank conflict, so no swizzle). TMA zero-fills past the
//   edge. Route "ldg" (any other A: 16379 float32 columns, a view at
//   an odd offset) fills the same registers with masked loads. The
//   wrapper picks and counts the route; the C side refuses a map TMA
//   rejects.
// * Grid (kernels/gemv.py::gemvt_plan): one cluster of C blocks per
//   column tile, each block a split of its rows (a whole number of
//   stages). C is the largest power of two up to 8 with C x tiles <= 2
//   x SMs (264 on 132 SMs) and at least 64 rows a split: no split above
//   132 tiles (16896 float32 columns; (31, 2^20): 8192 blocks of one
//   tile, 3 resident per SM), C = 2 at 16384^2 float32 (128 tiles, 256
//   blocks, 128 KB in flight per SM). Measurements on H100s chose the ring
//   and the grid: the time is set by the bytes in flight (one block
//   per SM, or 4 stages of 8 KB, ran far slower on a card whose memory
//   answers late) and by how many row regions of A are walked at once
//   (clusters of 4 and 8 lost to 2); 16 KB stages beat 8 KB stages at
//   equal ring bytes, and a block that walks several tiles in turn lost
//   to one tile a block. 8 is the portable cluster size; 16 needs the
//   non-portable attribute and would only pay below 264 / 16 = 17
//   tiles, so it is not used. A matrix of fewer than 264 / 8 = 33
//   tiles (n < 4224 float32, 8448 16-bit) runs fewer than 2 blocks per
//   SM.
// * The fold has one fixed order, so a result repeats bitwise: a
//   lane's rows in order, the 8 warps' partials in warp order through
//   shared memory, then the cluster's blocks in rank order: after a
//   cluster barrier the rank-0 block reads its peers' partials through
//   distributed shared memory (mapa / ld.shared::cluster), applies
//   alpha and beta and stores; a second cluster barrier keeps the peers
//   (and their shared memory) alive until it has read them.
// * repro_gemvt_acc runs the same mainloop and stores the raw float32
//   A^T x with no alpha, beta or y: the product of the anchored
//   generator's gemvt anchor, which a Triton epilogue finishes.
// * The ragged edge is masked, never padded; offsets are 64-bit.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = kWarps;   // gemv route rows: one warp a row

// routes (kernels/gemv.py ROUTES and GEMV_ROUTES): gemvt and the gemv
// band kernel load their stages by TMA or with masked loads; gemv's
// route rows is one warp per row
enum Route : int { kTma = 0, kLdg = 1, kRows = 2 };

// columns of a 512-byte tile (gemvt's column tile, a gemv stage's
// width): 32 lanes x 16 bytes
template <typename T>
__host__ __device__ constexpr int tile_cols() {
  return 32 * vec_width<T>();
}

// y' = alpha A x + beta y, one warp per row (route rows)
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gemv_rows_kernel(const T* __restrict__ a, const T* __restrict__ x,
                 const T* __restrict__ y, T* __restrict__ out,
                 const float* __restrict__ scal, float alpha, float beta,
                 int64_t m, int64_t n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= m) return;
  const T* arow = a + row * n;
  float acc = 0.f;
  if constexpr (VEC) {
    constexpr int V = vec_width<T>();
#pragma unroll 4
    for (int64_t c = lane * V; c < n; c += 32 * V) {
      float av[V], xv[V];
      load_stream(arow + c, av);
      load_cached(x + c, xv);
#pragma unroll
      for (int k = 0; k < V; ++k) acc = fmaf(av[k], xv[k], acc);
    }
  } else {
#pragma unroll 4
    for (int64_t c = lane; c < n; c += 32)
      acc = fmaf(to_f(arow[c]), to_f(x[c]), acc);
  }
  acc = warp_sum(acc);
  if (lane != 0) return;
  const float al = scal != nullptr ? scal[0] : alpha;
  const float be = scal != nullptr ? scal[1] : beta;
  out[row] = from_f<T>(al * acc + be * to_f(y[row]));
}

// gemv band kernel: rows of a band, stages in flight, at most
constexpr int kMaxBand = 32;
constexpr int kMaxStagesV = 8;
constexpr int kBandPerWarp = kMaxBand / kWarps;   // a warp's rows
constexpr int kFoldBatch = 8;   // a lane's chunks loaded at once in a fold
static_assert(kMaxBand % kWarps == 0, "a warp takes whole rows of a band");

// a stage of the band kernel: `rows` rows of a 512-byte tile of A, then
// that tile of x
__host__ __device__ constexpr int band_stage_bytes(int rows) {
  return (rows + 1) * 512;
}

// the last of `count` blocks to take `ticket` gets true; __syncthreads
// first, so the acq_rel atomic releases the whole block's writes and
// the last block acquires every other block's
__device__ __forceinline__ bool last_ticket(unsigned* ticket, int count) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(ticket)
                 : "memory");
    last = old == static_cast<unsigned>(count - 1);
  }
  __syncthreads();
  return last;
}

// Block b walks band b / C (rows [band R, band R + R) of A, R =
// band_rows) over chunk c = b % C of its 512-byte column tiles: tiles
// c, c + C, c + 2C, ...
template <typename T, int ROUTE>
__global__ void __launch_bounds__(kThreads)
gemv_band_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap xmap,
                 const T* __restrict__ a, const T* __restrict__ x,
                 const T* __restrict__ y, T* __restrict__ out,
                 float* __restrict__ part, unsigned* __restrict__ tickets,
                 const float* __restrict__ scal, float alpha, float beta,
                 int64_t m, int64_t n, int band_rows, int chunks,
                 int stages) {
  constexpr int V = vec_width<T>();
  constexpr int TC = tile_cols<T>();
  extern __shared__ __align__(128) unsigned char ring[];  // [stages]
  __shared__ uint64_t full[kMaxStagesV];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t band = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const int64_t r0 = band * band_rows;
  const int rows = static_cast<int>(m - r0 < band_rows ? m - r0 : band_rows);
  // this chunk's tiles, in order: chunk, chunk + C, chunk + 2C, ... (so
  // that a band's chunks walk neighbouring tiles at once)
  const int64_t tiles = (n + TC - 1) / TC;
  const int steps = static_cast<int>((tiles - chunk + chunks - 1) / chunks);
  const int stage_bytes = band_stage_bytes(band_rows);

  float acc[kBandPerWarp];
#pragma unroll
  for (int j = 0; j < kBandPerWarp; ++j) acc[j] = 0.f;

  if constexpr (ROUTE == kTma) {
    uint64_t once = 0, keep = 0;
    const CUtensorMap* am = &amap;
    const CUtensorMap* xm = &xmap;
    auto issue = [&](int k) {   // stage k into slot k % stages
      const int s = k % stages;
      unsigned char* dst = ring + s * stage_bytes;
      const int col = static_cast<int>((chunk + int64_t{k} * chunks) * TC);
      mbar_expect(full + s, stage_bytes);
      tma_load_2d(dst, am, full + s, col, static_cast<int>(r0), once);
      tma_load_2d(dst + band_rows * 512, xm, full + s, col, 0, keep);
    };
    if (t == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                   : "=l"(once));
      asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                   : "=l"(keep));
      for (int k = 0; k < steps && k < stages; ++k) issue(k);
    }
    __syncthreads();
    for (int k = 0; k < steps; ++k) {
      const int s = k % stages;
      mbar_wait(full + s, (k / stages) & 1);
      const T* stage = reinterpret_cast<const T*>(ring + s * stage_bytes);
      float xv[V];
#pragma unroll
      for (int v = 0; v < V; v += 4)
        load4(stage + band_rows * TC + lane * V + v, xv + v);
#pragma unroll
      for (int j = 0; j < kBandPerWarp; ++j) {
        const int i = warp + j * kWarps;   // this warp's rows, in order
        if (i < rows) {
          float av[V];
#pragma unroll
          for (int v = 0; v < V; v += 4)
            load4(stage + i * TC + lane * V + v, av + v);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[j] = fmaf(av[v], xv[v], acc[j]);
        }
      }
      __syncthreads();   // every warp is done with slot s
      if (t == 0 && k + stages < steps) issue(k + stages);
    }
  } else {
    for (int k = 0; k < steps; ++k) {
      // this lane's columns
      const int64_t c0 = (chunk + int64_t{k} * chunks) * TC + lane * V;
      float xv[V];
#pragma unroll
      for (int v = 0; v < V; ++v) xv[v] = c0 + v < n ? to_f(x[c0 + v]) : 0.f;
#pragma unroll
      for (int j = 0; j < kBandPerWarp; ++j) {
        const int i = warp + j * kWarps;
        if (i < rows) {
          const T* arow = a + (r0 + i) * n;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float av = c0 + v < n ? to_f(arow[c0 + v]) : 0.f;
            acc[j] = fmaf(av, xv[v], acc[j]);
          }
        }
      }
    }
  }

  const float al = scal != nullptr ? scal[0] : alpha;
  const float be = scal != nullptr ? scal[1] : beta;
#pragma unroll
  for (int j = 0; j < kBandPerWarp; ++j) {
    const int i = warp + j * kWarps;
    if (i >= rows) continue;   // the same for the whole warp
    const float sum = warp_sum(acc[j]);
    if (lane != 0) continue;
    if (chunks == 1)
      out[r0 + i] = from_f<T>(al * sum + be * to_f(y[r0 + i]));
    else
      part[static_cast<int64_t>(chunk) * m + r0 + i] = sum;
  }
  if (chunks == 1 || !last_ticket(tickets + band, chunks)) return;
  // the last block of the band: lane l adds chunks l, l + 32, ... in
  // order, every row's kFoldBatch loads issued before the adds
  float fold[kBandPerWarp];
#pragma unroll
  for (int j = 0; j < kBandPerWarp; ++j) fold[j] = 0.f;
  for (int c0 = lane; c0 < chunks; c0 += 32 * kFoldBatch) {
    float v[kBandPerWarp][kFoldBatch];
#pragma unroll
    for (int j = 0; j < kBandPerWarp; ++j) {
      const int i = warp + j * kWarps;
#pragma unroll
      for (int q = 0; q < kFoldBatch; ++q) {
        const int c = c0 + 32 * q;
        v[j][q] = i < rows && c < chunks
                      ? __ldcg(part + static_cast<int64_t>(c) * m + r0 + i)
                      : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kBandPerWarp; ++j)
#pragma unroll
      for (int q = 0; q < kFoldBatch; ++q) fold[j] += v[j][q];
  }
#pragma unroll
  for (int j = 0; j < kBandPerWarp; ++j) {
    const int i = warp + j * kWarps;
    if (i >= rows) continue;
    const float sum = warp_sum(fold[j]);
    if (lane == 0) out[r0 + i] = from_f<T>(al * sum + be * to_f(y[r0 + i]));
  }
  if (t == 0) tickets[band] = 0;   // ready for the next call
}

// gemvt: rows of a stage, stages in flight, blocks resident per SM
constexpr int kRowsT = 32;
constexpr int kStagesT = 4;
constexpr int kBlocksPerSmT = 4;
static_assert(kRowsT % kWarps == 0, "a warp takes whole rows of a stage");

// every thread of every block of the cluster; release/acquire orders
// the shared-memory writes before it with the peers' reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float at `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float ld_peer(const float* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr) : "r"(smem_addr(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Block (cluster c, rank r) walks column tile c over rows [r R, r R + R)
// of A (R = rows_per_split).
template <typename T, int ROUTE, bool RAW>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmT)
gemvt_kernel(const __grid_constant__ CUtensorMap map,
             const T* __restrict__ a, const T* __restrict__ x,
             const T* __restrict__ y, void* __restrict__ out,
             const float* __restrict__ scal, float alpha, float beta,
             int64_t m, int64_t n, int64_t rows_per_split, int cluster) {
  constexpr int V = vec_width<T>();
  constexpr int TC = tile_cols<T>();
  constexpr int kStageBytes = kRowsT * TC * static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char ring[];  // [kStagesT]
  __shared__ uint64_t full[kStagesT];
  __shared__ __align__(16) float part[kWarps][TC];
  __shared__ float red[TC];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // a 1-D grid of 1-D clusters: blocks c C .. c C + C - 1 form cluster
  // c, and a block's rank in it is blockIdx.x % C (%cluster_ctarank)
  const uint32_t rank = blockIdx.x % static_cast<uint32_t>(cluster);
  const int64_t tile = blockIdx.x / cluster;
  const int64_t r0 = static_cast<int64_t>(rank) * rows_per_split;
  const int64_t r1 = r0 + rows_per_split < m ? r0 + rows_per_split : m;
  const int steps = static_cast<int>((r1 - r0 + kRowsT - 1) / kRowsT);

  uint64_t policy = 0;
  const CUtensorMap* tmap = &map;
  auto issue = [=, &policy](int k) {   // stage k into slot k % kStagesT
    const int s = k % kStagesT;
    const int64_t row = r0 + static_cast<int64_t>(k) * kRowsT;
    mbar_expect(full + s, kStageBytes);
    tma_load_2d(ring + s * kStageBytes, tmap, full + s,
                static_cast<int>(tile * TC), static_cast<int>(row), policy);
  };
  if constexpr (ROUTE == kTma) {
    if (t == 0) {
      for (int s = 0; s < kStagesT; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                   : "=l"(policy));
      for (int k = 0; k < steps && k < kStagesT; ++k) issue(k);
    }
    __syncthreads();
  }

  const int64_t col0 = tile * TC + lane * V;   // this lane's columns
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  if constexpr (ROUTE == kTma) {
    for (int k = 0; k < steps; ++k) {
      const int s = k % kStagesT;
      const int64_t row0 = r0 + static_cast<int64_t>(k) * kRowsT;
      const int rows = r1 - row0 < kRowsT ? static_cast<int>(r1 - row0)
                                          : kRowsT;
      mbar_wait(full + s, (k / kStagesT) & 1);
      const T* stage = reinterpret_cast<const T*>(ring + s * kStageBytes);
#pragma unroll
      for (int j = 0; j < kRowsT / kWarps; ++j) {
        const int i = warp + j * kWarps;   // this warp's rows, in order
        if (i < rows) {
          float av[V];
#pragma unroll
          for (int v = 0; v < V; v += 4)
            load4(stage + i * TC + lane * V + v, av + v);
          const float xr = to_f(x[row0 + i]);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(av[v], xr, acc[v]);
        }
      }
      __syncthreads();   // every warp is done with slot s
      if (t == 0 && k + kStagesT < steps) issue(k + kStagesT);
    }
  } else {
#pragma unroll 4
    for (int64_t row = r0 + warp; row < r1; row += kWarps) {
      const T* arow = a + row * n;
      const float xr = to_f(x[row]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int64_t col = col0 + v;
        const float av = col < n ? to_f(arow[col]) : 0.f;
        acc[v] = fmaf(av, xr, acc[v]);
      }
    }
  }

  // the 8 warps in order, then the cluster's blocks in rank order
#pragma unroll
  for (int v = 0; v < V; v += 4)
    *reinterpret_cast<float4*>(&part[warp][lane * V + v]) =
        make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
  __syncthreads();
  float sum = 0.f;
  if (t < TC) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][t];
    red[t] = sum;
  }
  if (cluster > 1) {
    cluster_sync();   // every rank's red[] is written
    if (rank == 0 && t < TC)
      for (int p = 1; p < cluster; ++p) sum += ld_peer(red + t, p);
  }
  const int64_t col = tile * TC + t;
  if (rank == 0 && t < TC && col < n) {
    if constexpr (RAW) {
      static_cast<float*>(out)[col] = sum;
    } else {
      const float al = scal != nullptr ? scal[0] : alpha;
      const float be = scal != nullptr ? scal[1] : beta;
      static_cast<T*>(out)[col] = from_f<T>(al * sum + be * to_f(y[col]));
    }
  }
  // the peers keep red[] (and exit) only after rank 0 has read it
  if (cluster > 1) cluster_sync();
}

template <typename T, int ROUTE, bool RAW>
int launch_gemvt(const CUtensorMap& map, const T* a, const T* x,
                 const T* y, void* out, const float* scal, float alpha,
                 float beta, int64_t m, int64_t n, int64_t rows_per_split,
                 int cluster, unsigned blocks, cudaStream_t stream) {
  const int smem = ROUTE == kTma ? kStagesT * kRowsT * tile_cols<T>() *
                                       static_cast<int>(sizeof(T))
                                 : 0;
  static std::atomic<uint64_t> raised{0};
  const int err = allow_smem(gemvt_kernel<T, ROUTE, RAW>, smem, raised);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, gemvt_kernel<T, ROUTE, RAW>, map, a, x, y, out, scal, alpha,
      beta, m, n, rows_per_split, cluster));
}

// the gemvt launch of both entry points: checks the plan, builds the
// map of the tma route, dispatches on dtype and route
template <bool RAW>
int run_gemvt(int dtype, const void* a, const void* x, const void* y,
              void* out, const float* scal, float alpha, float beta,
              int64_t m, int64_t n,
              int64_t rows_per_split, int cluster, int route,
              void* stream) {
  if (m < 1 || n < 1 || m > INT_MAX || n > INT_MAX || rows_per_split < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (cluster > 1 && rows_per_split % kRowsT != 0) ||
      (cluster - 1) * rows_per_split >= m ||
      static_cast<int64_t>(cluster) * rows_per_split < m ||
      (route != kTma && route != kLdg))
    return static_cast<int>(cudaErrorInvalidValue);
  const int itemsize = dtype == kF32 ? 4 : 2;
  const int64_t tc = 512 / itemsize;
  const int64_t clusters = (n + tc - 1) / tc;   // one per column tile
  if (clusters * cluster > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map{};
  if (route == kTma &&
      !matrix_map(&map, dtype, a, m, n, static_cast<int>(tc), kRowsT,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(clusters * cluster);
  int err = 0;
  auto body = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* A = static_cast<const T*>(a);
    const T* X = static_cast<const T*>(x);
    const T* Y = static_cast<const T*>(y);
    err = route == kTma
              ? launch_gemvt<T, kTma, RAW>(map, A, X, Y, out, scal, alpha,
                                           beta, m, n, rows_per_split,
                                           cluster, blocks, s)
              : launch_gemvt<T, kLdg, RAW>(map, A, X, Y, out, scal, alpha,
                                           beta, m, n,
                                           rows_per_split, cluster, blocks,
                                           s);
  };
  REPRO_DISPATCH(dtype, body);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// the gemv launch: checks the plan, builds the maps of the tma route,
// dispatches on dtype and route
inline int run_gemv(int dtype, const void* a, const void* x, const void* y,
                    void* out, float* part, unsigned* tickets,
                    int64_t tickets_len, const float* scal, float alpha,
                    float beta, int64_t m, int64_t n, int band_rows,
                    int chunks, int stages, int route, void* stream) {
  if (m < 1 || n < 1 || m > INT_MAX || n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int itemsize = dtype == kF32 ? 4 : 2;
  const int64_t tc = 512 / itemsize;
  int err = 0;
  if (route == kRows) {
    if (band_rows != kRowsPerBlock || chunks != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks =
        static_cast<unsigned>((m + kRowsPerBlock - 1) / kRowsPerBlock);
    auto body = [&](auto* tag) {
      using T = std::remove_pointer_t<decltype(tag)>;
      const T* A = static_cast<const T*>(a);
      const T* X = static_cast<const T*>(x);
      const T* Y = static_cast<const T*>(y);
      T* O = static_cast<T*>(out);
      if (n % vec_width<T>() == 0 && aligned16(a) && aligned16(x))
        gemv_rows_kernel<T, true><<<blocks, kThreads, 0, s>>>(
            A, X, Y, O, scal, alpha, beta, m, n);
      else
        gemv_rows_kernel<T, false><<<blocks, kThreads, 0, s>>>(
            A, X, Y, O, scal, alpha, beta, m, n);
    };
    REPRO_DISPATCH(dtype, body);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t bands = band_rows >= 1 ? (m + band_rows - 1) / band_rows : 0;
  if ((route != kTma && route != kLdg) || band_rows < 1 ||
      band_rows > kMaxBand || chunks < 1 || chunks > (n + tc - 1) / tc ||
      stages < 1 || stages > kMaxStagesV ||
      bands * chunks > INT_MAX ||
      (chunks > 1 && (part == nullptr || tickets == nullptr ||
                      bands > tickets_len)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap{}, xmap{};
  if (route == kTma &&
      (!matrix_map(&amap, dtype, a, m, n, static_cast<int>(tc), band_rows,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
       !matrix_map(&xmap, dtype, x, 1, n, static_cast<int>(tc), 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(bands * chunks);
  const int smem = route == kTma ? stages * band_stage_bytes(band_rows) : 0;
  auto body = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* A = static_cast<const T*>(a);
    const T* X = static_cast<const T*>(x);
    const T* Y = static_cast<const T*>(y);
    T* O = static_cast<T*>(out);
    if (route == kTma) {
      // the largest ring any band takes, once per device
      static std::atomic<uint64_t> raised{0};
      err = allow_smem(gemv_band_kernel<T, kTma>,
                       kMaxStagesV * band_stage_bytes(kMaxBand), raised);
      if (err != 0) return;
      gemv_band_kernel<T, kTma><<<blocks, kThreads, smem, s>>>(
          amap, xmap, A, X, Y, O, part, tickets, scal, alpha, beta, m, n,
          band_rows, chunks, stages);
    } else {
      gemv_band_kernel<T, kLdg><<<blocks, kThreads, 0, s>>>(
          amap, xmap, A, X, Y, O, part, tickets, scal, alpha, beta, m, n,
          band_rows, chunks, stages);
    }
  };
  REPRO_DISPATCH(dtype, body);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// a (m, n) row-major contiguous; x (n,), y and out (m,); alpha and beta
// by value, or, where scal is not null, scal = {alpha, beta} float32 on
// the device (a tensor operand); the plan of kernels/gemv.py::gemv_plan:
// route 2 (rows: one warp per row, band_rows = 8, chunks = 1) or the
// band kernel on route 0 (tma: a's and x's bases 16-byte aligned, n
// times the element size a multiple of 16 bytes) or 1 (ldg: any a and
// x), band_rows <= 32 rows a band, `chunks` column chunks a band (at
// most its 512-byte tiles) and a ring of `stages` <= 8 stages (the
// rows route ignores it); where chunks > 1, part (chunks, m)
// float32 scratch and tickets, tickets_len (at least the bands)
// counters that are 0 between calls (the kernel leaves them so).
extern "C" int repro_gemv(int dtype, const void* a, const void* x,
                          const void* y, void* out, float* part,
                          unsigned* tickets, int64_t tickets_len,
                          const float* scal, float alpha, float beta,
                          int64_t m, int64_t n, int band_rows, int chunks,
                          int stages, int route, void* stream) {
  return repro::run_gemv(dtype, a, x, y, out, part, tickets, tickets_len,
                         scal, alpha, beta, m, n, band_rows, chunks, stages,
                         route, stream);
}

// a (m, n) row-major contiguous; x (m,), y and out (n,); alpha and beta
// by value, or, where scal is not null, scal = {alpha, beta} float32 on
// the device (a tensor operand); the plan of
// kernels/gemv.py::gemvt_plan: one cluster of `cluster` blocks per
// 512-byte column tile, rows_per_split rows for each of its blocks (a
// whole number of 32-row stages where cluster > 1); route 0 (tma: a's
// base 16-byte aligned, n times the element size a multiple of 16
// bytes) or 1 (ldg: any a).
extern "C" int repro_gemvt(int dtype, const void* a, const void* x,
                           const void* y, void* out, const float* scal,
                           float alpha, float beta, int64_t m, int64_t n,
                           int64_t rows_per_split, int cluster, int route,
                           void* stream) {
  return repro::run_gemvt<false>(dtype, a, x, y, out, scal, alpha, beta, m,
                                 n, rows_per_split, cluster, route, stream);
}

// the same product with no alpha, beta or y: acc (n,) float32 = A^T x
extern "C" int repro_gemvt_acc(int dtype, const void* a, const void* x,
                               float* acc, int64_t m, int64_t n,
                               int64_t rows_per_split, int cluster,
                               int route, void* stream) {
  return repro::run_gemvt<true>(dtype, a, x, nullptr, acc, nullptr, 0.f,
                                0.f, m, n, rows_per_split, cluster, route,
                                stream);
}

// the capture state of `stream` (cudaStreamCaptureStatus: 0 none, 1
// active, 2 invalidated), and in *id the capture's id where one is
// active; a CUDA error as its negative
extern "C" int repro_capture_state(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  *id = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, id);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return static_cast<int>(status);
}

// The shared memory one block of a kernel requests, static (from
// cudaFuncGetAttributes) plus the dynamic bytes its launch passes, for
// the check of kernels/gemv.py's footprints. kernel 0: the band kernel
// on route tma, `band_rows` rows and `stages` stages a block; 1: on
// route ldg; 2: the rows kernel's 16-byte path; 3: its one-column path;
// 4, 5: gemvt (finished) on routes tma, ldg; 6, 7: its raw product
// (the gemvt anchor's) on routes tma, ldg.
extern "C" int repro_gemv_smem(int dtype, int kernel, int band_rows,
                               int stages, long long* bytes) {
  using repro::kLdg;
  using repro::kTma;
  int err = 0;
  auto body = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    cudaFuncAttributes attr{};
    long long dyn = 0;
    cudaError_t e = cudaErrorInvalidValue;
    const long long ring = static_cast<long long>(repro::kStagesT) *
                           repro::kRowsT * repro::tile_cols<T>() *
                           static_cast<long long>(sizeof(T));
    switch (kernel) {
      case 0:
        e = cudaFuncGetAttributes(&attr, repro::gemv_band_kernel<T, kTma>);
        dyn = static_cast<long long>(stages) *
              repro::band_stage_bytes(band_rows);
        break;
      case 1:
        e = cudaFuncGetAttributes(&attr, repro::gemv_band_kernel<T, kLdg>);
        break;
      case 2:
        e = cudaFuncGetAttributes(&attr, repro::gemv_rows_kernel<T, true>);
        break;
      case 3:
        e = cudaFuncGetAttributes(&attr, repro::gemv_rows_kernel<T, false>);
        break;
      case 4:
        e = cudaFuncGetAttributes(&attr,
                                  repro::gemvt_kernel<T, kTma, false>);
        dyn = ring;
        break;
      case 5:
        e = cudaFuncGetAttributes(&attr,
                                  repro::gemvt_kernel<T, kLdg, false>);
        break;
      case 6:
        e = cudaFuncGetAttributes(&attr, repro::gemvt_kernel<T, kTma, true>);
        dyn = ring;
        break;
      case 7:
        e = cudaFuncGetAttributes(&attr, repro::gemvt_kernel<T, kLdg, true>);
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

// The shared memory one block of `device` may opt into
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), into *bytes.
extern "C" int repro_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}
