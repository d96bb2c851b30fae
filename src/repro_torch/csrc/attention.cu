// Flash-attention forward (mha) for Hopper (sm_90a): softmax(q kᵀ · scale)
// v with causal, sliding-window and GQA masking, the running max, sum and
// output accumulator kept in float32 on chip, one rounding to q's dtype.
//
// Replaces src/repro/kernels/attention.py::mha (pallas_call at
// attention.py:92, body _flash_kernel :26). Same function, with v's width
// dv free of q and k's width d, as the reference's chunked_attention
// takes it for MLA (repro/models/attention.py:28): scores in float32
// from the 16-bit or float32 q and k, times scale = d^-0.5; keys
// masked on global ids (kpos < skv; causal qpos >= kpos with queries
// aligned at the end, qpos = i + skv - sq; window qpos - kpos < window);
// the online softmax of the Pallas body, whose fully masked rows keep a
// finite base so that exp() gives 0, not NaN; a row with no visible key
// writes 0.
//
// Bound on an H100 SXM at Llama-3-8B's prefill (B 8, 32 query heads on 8
// KV heads, S 1781, D 128, bfloat16, causal): the operations, 4 D per
// visible (query, key) pair, 2.1e11 per layer, 0.21 ms at the tensor
// cores' 989 TFLOP/s (bf16 in, f32 accumulate); the bytes (q, k, v read
// once, the output written once) are 0.09 ms. The score matrix never
// reaches HBM.
//
// Two kernels, one C entry point each; the wrapper
// (kernels/attention.py::mha_route) picks one, the C side never does.
//
// mha_wgmma_kernel<T, HD, HDV, PART> (repro_mha_wgmma): bfloat16 and
// float16 with d and dv up to 128, dv even, every base and stride over
// (b, head, row) a multiple of 16 bytes (TMA's conditions). HD is d
// padded to 64 or 128, HDV dv likewise, HDV <= HD: (64, 64), (128, 128)
// and (128, 64); PART when dv < HDV (the epilogue's column mask).
// Llama's prefill (128, 128), MiniCPM3's MLA prefill (96 -> 128, 64),
// H2O-Danube3's (120 -> 128, 120 -> 128).
// * Persistent: one block per SM walks work items, each one (b, query
//   head, 128-row query tile), item i, i + grid, ..., the longest causal
//   walks first. An item walks the key tiles of BK = 128 keys in a loop,
//   which takes the place of the Pallas kernel's sequential `ki` grid
//   axis; only the tiles that the causal mask or the window leave visible
//   are walked. Q has two buffers, so the next item's Q and first key
//   tiles load while the last item computes and writes its output. One
//   query head per item: the 4 heads that share a KV head are
//   neighbouring items, so their K/V re-reads hit the 50 MB L2, and an
//   item keeps one simple schedule.
// * Warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//   40 registers); one of its threads issues every load. Warpgroups 1
//   and 2 are consumers of 64 query rows each (setmaxnreg up to 232).
//   The consumers take turns at issuing their products (two named
//   barriers), so that one's softmax runs while the other's wgmmas do.
// * Loads: TMA (cp.async.bulk.tensor) over 4-D tensor maps (d, row, head,
//   b) of the strided (B, H, S, D) views, boxes of 64 columns (one
//   128-byte swizzled row) by 128 rows. Q once per item; K and V into a
//   2-stage ring, each stage with an mbarrier for "full" (TMA's byte count) and
//   one for "empty" (one arrival per consumer warpgroup), K and V apart,
//   so a K stage is refilled as soon as both S products have read it.
//   TMA zero-fills rows past S, and columns past d (or dv): the maps hold
//   the operands' true widths, so a head of 96 or 120 columns is padded
//   to 128 in shared memory at no cost in device memory. The maps come
//   from cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
//   (no -lcuda).
// * S = Q Kᵀ: wgmma m64n128k16, both operands K-major in swizzled shared
//   memory, float32 accumulators in registers, over all HD columns (the
//   zero fill past d adds nothing).
// * The mask is applied only on tiles that straddle the diagonal, the
//   window's edge or the ragged end; wholly visible tiles skip it, and a
//   tile that a consumer's rows cannot see is skipped by that consumer.
// * Softmax in base 2 with scale · log2 e folded into one FFMA; the row
//   sum is kept per thread and reduced over the row's 4 lanes once, at
//   the end.
// * O += P V: wgmma RS, P from the S accumulator's registers (the
//   accumulator layout of two 8-column n-tiles is the A fragment of one
//   16-key k-step), V read transposed (MN-major) from the same ring, at
//   N = HDV (64 columns of P V at MiniCPM3's dv 64, not 128). The
//   Pallas kernel multiplies P in float32; here P = hi + lo, two 16-bit
//   parts (lo = p - hi), both multiplied into the one accumulator, which
//   keeps P to about 16 significant bits next to the float32 sums. O is
//   rescaled only after the previous P V wgmma has been waited on.
// * Epilogue: O / l (l = 0 -> 1), rounded once, written contiguous
//   (B, Hq, Sq, dv) from registers, the column pairs past dv left out.
//
// mha_kernel (repro_mha_ffma): everything else (float32, d or dv over
// 128, d <= 64 with dv over 64, odd dv, unaligned views), on float32 FFMA:
// * One block of 128 threads owns one (b, query head, 64-row tile) and
//   walks the visible key tiles of BK = 64 keys as above; inside them
//   every element is masked on its global ids. q, k and v come in with
//   any strides over (b, head, row); the head dimension has unit stride.
// * The thread grid is 16 row groups x 8 column lanes. A thread owns ROWS
//   query rows (4; 2 at D 256) and, of each key tile, the 8 keys
//   lane + 8 j; of the output, the D / 8 columns lane + 8 j. The row max
//   and row sum reduce over the 8 lanes of a row group with shuffles, so
//   m, l and the accumulator stay in registers.
// * Q is staged once in shared memory as float32; K and V take turns in
//   one shared buffer per key tile (K, scores, then V), and the scores'
//   probabilities go through a small shared tile for the P V product.
//   Rows are padded by one float, so the column reads are conflict free.
// * max(d, dv) in buckets of 32, 64, 128 and 256 (the unused columns are
//   zeros): Q and K are staged at width d, V at width dv.
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kAttnThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kAttnBK = 64;        // keys per tile: 8 per column lane

template <int HD>
struct AttnTile {
  static constexpr int ROWS = HD >= 256 ? 2 : 4;  // query rows per thread
  static constexpr int BQ = 16 * ROWS;            // query rows a block owns
  static constexpr int CPT = HD / 8;              // output columns per thread
  static constexpr int LD = HD + 1;               // padded row of Q and K/V
  static constexpr int LDP = kAttnBK + 1;         // padded row of P
  static constexpr size_t kSmem =
      sizeof(float) * (BQ * LD + kAttnBK * LD + BQ * LDP);
};

// rows [row0, row0 + n) of one (b, head) slice, widened to float32, into
// a shared tile of `nrows` rows of LD floats; rows past `limit` and
// columns past d are zeros
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int64_t row_stride, int64_t row0,
                                           int64_t limit, int d, int nrows,
                                           float* __restrict__ dst) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < nrows * HD; e += kAttnThreads) {
    const int r = e / HD, c = e % HD;
    const int64_t row = row0 + r;
    dst[r * LD + c] =
        (row < limit && c < d) ? to_f(src[row * row_stride + c]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kAttnThreads)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int64_t sq,
           int64_t skv, int d, int dv, int hq, int group, int64_t qsb,
           int64_t qsh,
           int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
           int64_t vsh, int64_t vss, int causal, int64_t window,
           float scale) {
  using Tile = AttnTile<HD>;
  constexpr int ROWS = Tile::ROWS, BQ = Tile::BQ, CPT = Tile::CPT;
  constexpr int LD = Tile::LD, LDP = Tile::LDP, BK = kAttnBK;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* KV = Qs + BQ * LD;      // [BK][LD]: K, then V, of one key tile
  float* Ps = KV + BK * LD;      // [BQ][LDP]

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int64_t qt = static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t q0 = qt * BQ;
  const int64_t off = skv - sq;  // queries aligned at the end
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + static_cast<int64_t>(h / group) * ksh;
  const T* vb = v + b * vsb + static_cast<int64_t>(h / group) * vsh;

  stage_rows<T, HD>(qb, qss, q0, sq, d, BQ, Qs);

  // keys that some row of this tile may see: [klo, khi)
  const int64_t qlast = (q0 + BQ < sq ? q0 + BQ : sq) - 1;
  int64_t khi = skv;
  if (causal && qlast + off + 1 < khi) khi = qlast + off + 1;
  int64_t klo = 0;
  if (window > 0 && q0 + off - window + 1 > 0) klo = q0 + off - window + 1;

  float m[ROWS], l[ROWS], acc[ROWS][CPT];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  for (int64_t k0 = klo; k0 < khi; k0 += BK) {
    __syncthreads();  // Q staged; the last tile's V reads are done
    stage_rows<T, HD>(kb, kss, k0, skv, d, BK, KV);
    __syncthreads();

    float s[ROWS][8];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; ++c) {
      float a[ROWS], kk[8];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) a[i] = Qs[(ty * ROWS + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = KV[(tx + 8 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int64_t qpos = q0 + ty * ROWS + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t kpos = k0 + tx + 8 * j;
        bool ok = kpos < skv;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 column lanes of a row group are neighbours in one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // a row masked so far keeps a finite base: exp() gives 0, not NaN
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_safe);
        Ps[(ty * ROWS + i) * LDP + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = expf(m[i] - m_safe);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every K read done, P written
    stage_rows<T, HD>(vb, vss, k0, skv, dv, BK, KV);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) p[i] = Ps[(ty * ROWS + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = KV[kk * LD + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  // out (B, Hq, Sq, dv) contiguous
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int64_t row = q0 + ty * ROWS + i;
    if (row >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* o = out + ((b * hq + h) * sq + row) * dv;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 8 * j;
      if (c < dv) o[c] = from_f<T>(acc[i][j] / l_safe);
    }
  }
}

template <typename T, int HD>
int launch_mha(const T* q, const T* k, const T* v, T* out, int64_t b,
               int64_t hq, int64_t hkv, int64_t sq, int64_t skv, int64_t d,
               int64_t dv, const int64_t* st, int causal, int64_t window,
               float scale, cudaStream_t stream) {
  using Tile = AttnTile<HD>;
  auto kernel = mha_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((sq + Tile::BQ - 1) / Tile::BQ),
            static_cast<unsigned>(hq), static_cast<unsigned>(b));
  kernel<<<grid, kAttnThreads, Tile::kSmem, stream>>>(
      q, k, v, out, sq, skv, static_cast<int>(d), static_cast<int>(dv),
      static_cast<int>(hq), static_cast<int>(hq / hkv), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], causal, window, scale);
  return 0;
}

// ---------------------------------------------------------------------------
// wgmma path: bfloat16 and float16, d and dv up to 128, fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;         // query rows of a block: 2 consumers x 64
constexpr int kWgBK = 128;         // keys per tile
constexpr int kWgStages = 2;       // depth of the K and V rings
constexpr int kWgThreads = 384;    // producer + 2 consumer warpgroups
constexpr int kSw = 64;            // 16-bit elements of a 128-byte row

// HD: the padded width of q and k's rows (64 or 128), HDV: of v's rows
// and the output's (64 or 128, at most HD)
template <int HD, int HDV>
struct WgTile {
  static constexpr int NH = HD / kSw;    // 64-column boxes of a Q or K row
  static constexpr int NHV = HDV / kSw;  // of a V row
  static constexpr uint32_t kQBytes = kWgBQ * HD * 2;
  static constexpr uint32_t kKBytes = kWgBK * HD * 2;   // one K tile
  static constexpr uint32_t kVBytes = kWgBK * HDV * 2;  // one V tile
  // 1024 bytes of slack to align the swizzled tiles: two Q tiles, the
  // K and V rings, then 12 mbarriers
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + kWgStages * (kKBytes + kVBytes) + 128;
};

// one work item of the persistent kernel: a (b, query head, 128-row query
// tile), item 0 the longest causal walk; its keys [klo, klo + ntiles BK)
struct WgItem {
  int q0, h, b, klo, ntiles;
};

__device__ __forceinline__ WgItem wg_item(int i, int hq, int nb, int sq,
                                          int skv, int causal, int window) {
  const int nqt = (sq + kWgBQ - 1) / kWgBQ;
  WgItem w;
  const int qt = nqt - 1 - i / (hq * nb), rest = i % (hq * nb);
  w.h = rest % hq;
  w.b = rest / hq;
  w.q0 = qt * kWgBQ;
  const int off = skv - sq;   // queries aligned at the end
  // keys that some row of the item may see: [klo, khi)
  const int qlast = min(w.q0 + kWgBQ, sq) - 1;
  int khi = skv;
  if (causal) khi = min(khi, qlast + off + 1);
  w.klo = 0;
  if (window > 0)
    w.klo = static_cast<int>(max(0LL, static_cast<long long>(w.q0) + off -
                                          window + 1));
  w.ntiles = khi > w.klo ? (khi - w.klo + kWgBK - 1) / kWgBK : 0;
  return w;
}

// the two consumer warpgroups take turns at issuing their products:
// warpgroup cw waits on barrier 1 + cw and then signals the other's
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// wgmma m64nNk16 with float32 accumulators d (N / 2 per thread: of each
// 8-column n-tile j, d[4j], d[4j+1] are row g and d[4j+2], d[4j+3] row
// g + 8 of the warp's 16, columns 8j + 2 (lane % 4) + {0, 1})
template <typename T, int N>
struct Wgmma;

// for one 16-bit type CT (PTX name TY): ss at N = 128 (S = Q Kᵀ over a
// 128-key tile), rs at N = 64 and 128 (O += P V at HDV 64 and 128)
#define REPRO_WGMMA(CT, TY)                                               \
  template <>                                                             \
  struct Wgmma<CT, 64> {                                                  \
    /* d += A B: A (64 x 16) in registers, B (16 x 64) MN-major in */     \
    /* shared memory (read transposed) */                                 \
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, \
                                              uint64_t b) {               \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                    \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "     \
          "{" REPRO_R32 "}, "                                             \
          "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                   \
          : REPRO_D32                                                     \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));  \
    }                                                                     \
  };                                                                      \
  template <>                                                             \
  struct Wgmma<CT, 128> {                                                 \
    /* d += A B: A (64 x 16) and B (16 x 128) K-major in shared memory */ \
    static __device__ __forceinline__ void ss(float* d, uint64_t a,       \
                                              uint64_t b, int acc) {      \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                    \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "    \
          "{" REPRO_R64 "}, "                                             \
          "%64, %65, p, 1, 1, 0, 0;\n}\n"                                 \
          : REPRO_D64                                                     \
          : "l"(a), "l"(b), "r"(acc));                                    \
    }                                                                     \
    /* d += A B: A (64 x 16) in registers, B (16 x 128) MN-major in */    \
    /* shared memory (read transposed) */                                 \
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, \
                                              uint64_t b) {               \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                    \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "    \
          "{" REPRO_R64 "}, "                                             \
          "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                   \
          : REPRO_D64                                                     \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));  \
    }                                                                     \
  };

REPRO_WGMMA(__nv_bfloat16, "bf16")
REPRO_WGMMA(__half, "f16")
#undef REPRO_WGMMA

template <typename T, int HD, int HDV, bool PART>
__global__ void __launch_bounds__(kWgThreads, 1)
mha_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 T* __restrict__ out, int nb, int sq, int skv, int hq,
                 int group, int dv, int causal, int window,
                 float scale_log2) {
  using Tile = WgTile<HD, HDV>;
  constexpr int NH = Tile::NH, NHV = Tile::NHV, BK = kWgBK, ST = kWgStages;
  constexpr uint32_t kRow = 2 * kSw;           // bytes of a swizzled row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries of the shared window
  T* Qs = reinterpret_cast<T*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
                                               // [2][NH][kWgBQ][kSw]
  T* Ks = Qs + 2 * kWgBQ * HD;                 // [ST][NH][BK][kSw]
  T* Vs = Ks + ST * BK * HD;                   // [ST][NHV][BK][kSw]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(Vs + ST * BK * HDV);
  uint64_t* empty_q = full_q + 2;
  uint64_t* full_k = empty_q + 2;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;
  uint64_t* empty_v = empty_k + ST;
  const int off = skv - sq;   // queries aligned at the end
  const int nitems = (sq + kWgBQ - 1) / kWgBQ * hq * nb;

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      mbar_init(full_q + j, 1);
      mbar_init(empty_q + j, 2);   // one arrival per consumer warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, 2);   // one arrival per consumer warpgroup
      mbar_init(empty_v + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // the block's items in turn; seq counts the K/V tiles of all of
      // them, so the ring's stages and phases run on across items, and
      // an item's Q and first tiles load while the last one computes
      int seq = 0;
      for (int it = 0, item = blockIdx.x; item < nitems;
           ++it, item += gridDim.x) {
        const WgItem w = wg_item(item, hq, nb, sq, skv, causal, window);
        const int qb = it % 2, hk = w.h / group;
        if (it >= 2) mbar_wait(empty_q + qb, (it / 2 - 1) & 1);
        mbar_expect(full_q + qb, Tile::kQBytes);
        for (int c = 0; c < NH; ++c)
          tma_load(Qs + (qb * NH + c) * kWgBQ * kSw, &tq, full_q + qb,
                   c * kSw, w.q0, w.h, w.b);
        for (int t = 0; t < w.ntiles; ++t, ++seq) {
          const int s = seq % ST, k0 = w.klo + t * BK;
          const uint32_t par = (seq / ST) & 1;
          mbar_wait(empty_k + s, par ^ 1);   // the first round passes
          mbar_expect(full_k + s, Tile::kKBytes);
          for (int c = 0; c < NH; ++c)
            tma_load(Ks + (s * NH + c) * BK * kSw, &tk, full_k + s,
                     c * kSw, k0, hk, w.b);
          mbar_wait(empty_v + s, par ^ 1);
          mbar_expect(full_v + s, Tile::kVBytes);
          for (int c = 0; c < NHV; ++c)
            tma_load(Vs + (s * NHV + c) * BK * kSw, &tv, full_v + s,
                     c * kSw, k0, hk, w.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
    if (cw == 1) turn_pass(cw);   // warpgroup 1 lets warpgroup 0 go first

    int seq = 0;   // K/V tiles of the block's items so far, as the
    // producer counts them
    for (int it = 0, item = blockIdx.x; item < nitems;
         ++it, item += gridDim.x) {
      const WgItem w = wg_item(item, hq, nb, sq, skv, causal, window);
      const int qb = it % 2;   // the item's Q buffer
      const int r0 = w.q0 + cw * 64 + warp * 16 + g;  // this thread's rows:
      const int qp0 = r0 + off, qp1 = qp0 + 8;        // r0 and r0 + 8
      // positions of this warpgroup's real rows: [qa, qz]
      const int qa = w.q0 + cw * 64 + off;
      const int qz = min(w.q0 + cw * 64 + 63, sq - 1) + off;
      const uint32_t q_base =
          smem_addr(Qs + qb * kWgBQ * HD) + cw * 64 * kRow;

      float o[HDV / 2];
#pragma unroll
      for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      mbar_wait(full_q + qb, (it / 2) & 1);

      for (int t = 0; t < w.ntiles; ++t, ++seq) {
        const int s = seq % ST, k0 = w.klo + t * BK;
        const uint32_t par = (seq / ST) & 1;
        const int kend = min(k0 + BK, skv) - 1;     // last real key
        const bool seen = qz >= qa && (!causal || qz >= k0) &&
                          (window <= 0 || qa - kend < window);
        const bool whole = k0 + BK <= skv &&
                           (!causal || qa >= k0 + BK - 1) &&
                           (window <= 0 || qz - k0 < window);
        mbar_wait(full_k + s, par);
        if (!seen) {            // no row of this warpgroup sees the tile
          if (tid == 0) mbar_arrive(empty_k + s);
          mbar_wait(full_v + s, par);
          if (tid == 0) mbar_arrive(empty_v + s);
          turn_wait(cw);        // its two turns pass empty
          turn_pass(cw);
          turn_wait(cw);
          turn_pass(cw);
          continue;
        }

        // S = Q Kᵀ over HD in k-steps of 16: 32 bytes inside a 128-byte
        // swizzled row, then the next 64-column box. Columns d..HD-1 are
        // TMA's zero fill and add nothing; every k-step runs, so the
        // count stays a constant of the instantiation
        float sc[BK / 2];
        wg_fence();
        turn_wait(cw);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t c = kk / 4, w = (kk % 4) * 32;
          Wgmma<T, BK>::ss(
              sc, sw128_desc(q_base + c * kWgBQ * kRow + w, 16, 8 * kRow),
              sw128_desc(k_base + (s * NH + c) * BK * kRow + w, 16, 8 * kRow),
              kk > 0);
        }
        wg_commit();
        turn_pass(cw);
        wg_wait_all();
        pin<BK / 2>(sc);
        if (tid == 0) mbar_arrive(empty_k + s);

        if (!whole) {           // the diagonal, the window's edge, the end
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kp = k0 + 8 * j + 2 * t4 + c;
              const bool in = kp < skv;
              if (!(in && (!causal || qp0 >= kp) &&
                    (window <= 0 || qp0 - kp < window)))
                sc[4 * j + c] = -INFINITY;
              if (!(in && (!causal || qp1 >= kp) &&
                    (window <= 0 || qp1 - kp < window)))
                sc[4 * j + 2 + c] = -INFINITY;
            }
        }

        // online softmax in base 2; a row's 128 scores lie on one quad
        float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
        const float n0 = fmaxf(m0, x0 * scale_log2);
        const float n1 = fmaxf(m1, x1 * scale_log2);
        // a row masked so far keeps a finite base: exp2() gives 0, not NaN
        const float b0 = n0 == -INFINITY ? 0.f : n0;
        const float b1 = n1 == -INFINITY ? 0.f : n1;
        const float a0 = ex2(m0 - b0), a1 = ex2(m1 - b1);
        m0 = n0;
        m1 = n1;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -b0));
          sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -b0));
          sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -b1));
          sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -b1));
          s0 += sc[4 * j] + sc[4 * j + 1];
          s1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l0 = l0 * a0 + s0;      // this thread's share of the row sums
        l1 = l1 * a1 + s1;
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }

        // P as A fragments of 16-key k-steps: n-tiles 2kk and 2kk + 1 of
        // the scores, each split into hi and lo parts
        uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            Pair<T>::split(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1],
                           phi[kk][r], plo[kk][r]);

        // O += P V: V's 16 keys of a k-step are 16 swizzled rows; its 64-
        // column boxes lie BK rows apart
        mbar_wait(full_v + s, par);
        pin<HDV / 2>(o);
        wg_fence();
        turn_wait(cw);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t vdesc = sw128_desc(
              v_base + s * NHV * BK * kRow + kk * 16 * kRow, BK * kRow,
              8 * kRow);
          Wgmma<T, HDV>::rs(o, phi[kk], vdesc);
          Wgmma<T, HDV>::rs(o, plo[kk], vdesc);
        }
        wg_commit();
        turn_pass(cw);
        wg_wait_all();
        pin<HDV / 2>(o);
        if (tid == 0) mbar_arrive(empty_v + s);
      }

      if (tid == 0) mbar_arrive(empty_q + qb);   // every S product read Q

      // out (B, Hq, Sq, dv) contiguous; with PART (dv < HDV) only the
      // column pairs below dv (dv is even, so a pair is wholly in or
      // out). Without it the row is HDV wide and every store sits at a
      // constant offset, as before v had a width of its own: the run-time
      // width on every layer measured 3-5% slower at D 64 and 128
      const int ldo = PART ? dv : HDV;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
      const int64_t head = (static_cast<int64_t>(w.b) * hq + w.h) * sq;
      if (r0 < sq) {
        T* p = out + (head + r0) * ldo + 2 * t4;
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j)
          if (!PART || 8 * j + 2 * t4 < dv)
            *reinterpret_cast<uint32_t*>(p + 8 * j) =
                Pair<T>::pack(o[4 * j] / d0, o[4 * j + 1] / d0);
      }
      if (r0 + 8 < sq) {
        T* p = out + (head + r0 + 8) * ldo + 2 * t4;
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j)
          if (!PART || 8 * j + 2 * t4 < dv)
            *reinterpret_cast<uint32_t*>(p + 8 * j) =
                Pair<T>::pack(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
      }
    }
  }
}

template <typename T, int HD, int HDV>
int launch_mha_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                     const CUtensorMap& tv, T* out, int64_t b, int64_t hq,
                     int64_t hkv, int64_t sq, int64_t skv, int64_t dv,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  using Tile = WgTile<HD, HDV>;
  auto kernel = dv < HDV ? mha_wgmma_kernel<T, HD, HDV, true>
                         : mha_wgmma_kernel<T, HD, HDV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // one persistent block per SM walks the items
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = (sq + kWgBQ - 1) / kWgBQ * hq * b;
  kernel<<<static_cast<unsigned>(items < sms ? items : sms), kWgThreads,
           Tile::kSmem, stream>>>(
      tq, tk, tv, out, static_cast<int>(b), static_cast<int>(sq),
      static_cast<int>(skv), static_cast<int>(hq),
      static_cast<int>(hq / hkv), static_cast<int>(dv), causal, window,
      scale * 1.4426950408889634f);   // scale · log2 e
  return 0;
}

}  // namespace repro

// q (b, hq, sq, d) and k (b, hkv, skv, d), v (b, hkv, skv, dv), one
// dtype, each with the strides (over b, head, row) given and unit stride
// over its last dimension; out (b, hq, sq, dv) contiguous. window <= 0:
// no window. d and dv in 1..256; scale is d^-0.5 of the true d.
extern "C" int repro_mha_ffma(int dtype, const void* q, const void* k,
                              const void* v, void* out, int64_t b,
                              int64_t hq, int64_t hkv, int64_t sq,
                              int64_t skv, int64_t d, int64_t dv,
                              int64_t qsb, int64_t qsh, int64_t qss,
                              int64_t ksb, int64_t ksh, int64_t kss,
                              int64_t vsb, int64_t vsh, int64_t vss,
                              int causal, int64_t window, float scale,
                              void* stream) {
  if (d < 1 || d > 256 || dv < 1 || dv > 256 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const int64_t widest = d > dv ? d : dv;  // picks the bucket
  int err = 0;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* Q = static_cast<const T*>(q);
    const T* K = static_cast<const T*>(k);
    const T* V = static_cast<const T*>(v);
    T* O = static_cast<T*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto go = [&](auto hd) {  // hd: std::integral_constant, the bucket
      err = repro::launch_mha<T, decltype(hd)::value>(
          Q, K, V, O, b, hq, hkv, sq, skv, d, dv, st, causal, window, scale,
          s);
    };
    if (widest <= 32)
      go(std::integral_constant<int, 32>{});
    else if (widest <= 64)
      go(std::integral_constant<int, 64>{});
    else if (widest <= 128)
      go(std::integral_constant<int, 128>{});
    else
      go(std::integral_constant<int, 256>{});
  };
  REPRO_DISPATCH(dtype, run);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The same operands in bfloat16 or float16 with d and dv up to 128, dv
// even and no wider than d's 64-column boxes (the pairs (64, 64),
// (128, 128) and (128, 64) of padded widths), every base and stride a
// multiple of 16 bytes (the wrapper checks; a tensor map that TMA
// refuses returns cudaErrorInvalidValue). Sizes fit int32.
extern "C" int repro_mha_wgmma(int dtype, const void* q, const void* k,
                               const void* v, void* out, int64_t b,
                               int64_t hq, int64_t hkv, int64_t sq,
                               int64_t skv, int64_t d, int64_t dv,
                               int64_t qsb, int64_t qsh, int64_t qss,
                               int64_t ksb, int64_t ksh, int64_t kss,
                               int64_t vsb, int64_t vsh, int64_t vss,
                               int causal, int64_t window, float scale,
                               void* stream) {
  using repro::kBF16;
  using repro::kF16;
  const int hd = d <= 64 ? 64 : 128, hdv = dv <= 64 ? 64 : 128;
  if ((dtype != kBF16 && dtype != kF16) || d < 1 || d > 128 || dv < 2 ||
      dv > 128 || dv % 2 != 0 || hdv > hd || hkv < 1 || hq % hkv != 0 ||
      sq > INT_MAX || skv > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  // 64-column boxes: one 128-byte swizzled row each; the maps hold the
  // true widths, so TMA zero-fills the columns past d (and dv)
  constexpr auto kSw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!repro::view_map(&tq, dtype, q, b, hq, sq, d, qsb, qsh, qss,
                       repro::kSw, repro::kWgBQ, kSw128) ||
      !repro::view_map(&tk, dtype, k, b, hkv, skv, d, ksb, ksh, kss,
                       repro::kSw, repro::kWgBK, kSw128) ||
      !repro::view_map(&tv, dtype, v, b, hkv, skv, dv, vsb, vsh, vss,
                       repro::kSw, repro::kWgBK, kSw128))
    return static_cast<int>(cudaErrorInvalidValue);
  // a window of skv or more masks nothing
  const int win = window <= 0 || window >= skv ? 0 : static_cast<int>(window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    T* O = static_cast<T*>(out);
    if (hd == 64)
      err = repro::launch_mha_wgmma<T, 64, 64>(tq, tk, tv, O, b, hq, hkv, sq,
                                               skv, dv, causal, win, scale, s);
    else if (hdv == 64)
      err = repro::launch_mha_wgmma<T, 128, 64>(tq, tk, tv, O, b, hq, hkv,
                                                sq, skv, dv, causal, win,
                                                scale, s);
    else
      err = repro::launch_mha_wgmma<T, 128, 128>(tq, tk, tv, O, b, hq, hkv,
                                                 sq, skv, dv, causal, win,
                                                 scale, s);
  };
  if (dtype == kBF16)
    run(static_cast<__nv_bfloat16*>(nullptr));
  else
    run(static_cast<__half*>(nullptr));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
