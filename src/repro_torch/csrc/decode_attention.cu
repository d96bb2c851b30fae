// Decode attention for Hopper (sm_90a): one new query token per sequence
// over a KV cache, the G = Hq / Hkv query heads of a KV head together, a
// per-row cache length and an optional sliding window; float32 softmax
// state, one rounding to q's dtype.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention
// (pallas_call at decode_attention.py:85, body _decode_kernel :23). Same
// function: the valid keys of row b are kpos < len[b] and, with a window,
// kpos >= len[b] - window; scores in float32 times scale = d^-0.5; the
// online softmax of the Pallas body; a row with no valid key (len 0)
// gives 0. Keys are read up to the cache's capacity when len exceeds it;
// the window still counts back from len.
//
// Bound on an H100 SXM at Llama-3-8B's decode (B 8, 8 KV heads of 128,
// ~1800 cached tokens, bfloat16): the bytes of the valid K and V rows,
// 2 B Hkv len D 2 = 59 MB per layer, 17.6 us at 3.35 TB/s; the
// operations (4 D per query head and key, 7.5e7) are nothing beside
// them. So the design is about bytes in flight: the kernel reads only the
// valid range [lo, len), each K/V row once for all the query heads of a
// block.
//
// Design, common to both kernels:
// * Grid (splits, Hkv x head groups, B): the valid range of a row is cut
//   into `splits` equal shares (the wrapper's decode_plan, from the
//   cache's capacity, since the lengths stay on the device), so that the
//   blocks fill the card in one wave. A block serves a group of query
//   heads of its KV head (16 on the mma route, 4 on the simt route; more
//   heads make more groups, whose K/V re-reads hit L2).
// * A block of 4 warps walks its share in tiles; each warp keeps its own
//   online softmax (float32, base 2) over its keys of each tile, and at
//   the end the 4 warps are folded in shared memory in a fixed order.
// * Each block writes its (m, l, acc) partial in float32 and takes a
//   ticket; the last block of its (b, head group) folds the splits in a
//   fixed order (m = max m_s, l = sum 2^(m_s - m) l_s, acc likewise) and
//   divides once: one launch per call, and no float atomics, so a result
//   repeats bitwise whichever block comes last. The tickets live in the
//   call's own scratch, zeroed on the launch stream just before the
//   kernel, so no two launches share a counter (a CUDA graph replayed on
//   another stream included). With one split the block writes the output
//   itself.
// * Optionally (lse not null) the row's log-sum-exp of the scaled scores,
//   ln of sum exp(s - m) plus m in float32, is written beside the output
//   where the output is written (-inf for a row with no valid key): the
//   combine of partial attentions over blocks of a cache that a mesh
//   splits reads it. With lse null nothing more is written.
// * The cache comes in as a strided (B, Hkv, Smax, D) view of the model's
//   (B, Smax, Hkv, D) layer cache: strides over (b, head, row), unit
//   stride over d. q is a contiguous (B, Hq, D).
//
// decode_mma_kernel (repro_decode_attention_mma): bfloat16 and float16 at
// any even D up to 128 whose bases and strides are multiples of 16 bytes,
// in a tile of HD = 64 or 128 columns (llama's decode at D 128, danube's
// ring at D 120, hymba's at D 64). The tensor maps hold the true width d,
// so TMA zero-fills columns d..HD-1 of each 64-column box: K and V are
// read at their true width, and only the tensor-core work is padded. A
// full tile (d == HD) is compiled with its width as a constant (FULL):
// taken at run time, the width cost llama's D 128 step 3-4% of its
// device time.
// * Loads: a 3-stage ring of K and V tiles of 64 keys in shared memory,
//   in the cache's own 16-bit type, 128-byte swizzled (97 KB a block at
//   D 128: 2 blocks per SM), filled by TMA over 4-D maps (d, row, head, b)
//   of the cache views, rows past the capacity zero-filled: one thread
//   asks for tile t + 2 before the block computes tile t, with an mbarrier
//   per stage for "full" (the bytes landed) and one for "empty" (each warp
//   done reading it). No other barrier in the loop.
// * Compute on the tensor cores (mma.sync m16n8k16, float32 accumulate),
//   the G heads padded to the 16 rows of an mma: the padding costs nothing
//   on a card that waits for HBM here. Each warp takes 16 keys of a tile:
//   S = Q Kᵀ from q's A fragments (registers, loaded once) and K by
//   ldmatrix; the S accumulators are P's A fragment for O += P V, with V
//   by ldmatrix.trans. P is split into hi and lo 16-bit parts, both
//   multiplied, so P stays float32-like as in the Pallas body. V rows past
//   the share are zeroed in shared memory first (p = 0 there must not meet
//   a NaN the cache holds). The columns past d are zeros that TMA wrote,
//   never the cache's padding, so they meet no NaN either: q's A
//   fragments give 0 there, and the output and the partials are written
//   for columns below d only.
//
// decode_kernel (repro_decode_attention_simt): everything else (float32,
// odd D, D over 128 up to 256, views TMA refuses), on float32 FFMA with
// plain loads from global memory, tiles of 32 keys: each key row is read
// by LPK lanes (16 at D 128 in 16-bit types) as 16-byte chunks; a lane
// keeps q's matching chunks of the 4 heads in float32 registers, and the
// partial dots of a key are reduced over its LPK lanes with shuffles.
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kDecThreads = 128;   // 4 warps
constexpr int kDecBK = 32;         // keys per tile: 8 per warp
constexpr int kDecHeads = 4;       // query heads a block serves

template <typename T, int HD>
struct DecTile {
  static constexpr int V = vec_width<T>();       // elements of 16 bytes
  static constexpr int CH = HD / V;              // 16-byte chunks of a row
  static constexpr int LPK = CH < 32 ? CH : 32;  // lanes per key row
  static constexpr int CPL = CH / LPK;           // chunks per lane
  static constexpr int KPW = 32 / LPK;           // keys a warp reads at once
  static constexpr int NI = 8 / KPW;             // key steps per tile
  // the warps' partials, folded at the end
  static constexpr size_t kSmem = sizeof(float) * 4 * kDecHeads * (HD + 2);
};

// this block's share [start, end) of row b's valid range [lo, hi): keys
// below the length (read up to the capacity) and, with a window, at or
// above length - window, as the Pallas body masks them; in tiles of bk
struct Share {
  int64_t start, end;
  int ntiles;
};

__device__ __forceinline__ Share share_of(int64_t len, int64_t smax,
                                          int64_t window, int split,
                                          int splits, int bk) {
  const int64_t hi = len < 0 ? 0 : len < smax ? len : smax;
  int64_t lo = 0;
  if (window > 0 && len - window > 0) lo = len - window < hi ? len - window
                                                             : hi;
  const int64_t each = (hi - lo + splits - 1) / splits;
  Share sh;
  sh.start = lo + split * each;
  sh.end = sh.start + each < hi ? sh.start + each : hi;
  sh.ntiles = sh.end > sh.start
                  ? static_cast<int>((sh.end - sh.start + bk - 1) / bk)
                  : 0;
  return sh;
}

// the natural log-sum-exp of a row's scaled scores from its base-2 max
// and its sum of 2^(s - max); -inf where no key was valid (sum 0)
__device__ __forceinline__ float row_lse(float base2, float lsum) {
  return lsum == 0.f ? -INFINITY
                     : (base2 + log2f(lsum)) * 0.6931471805599453f;
}

// fold the warps' partials of a block, in shared memory (acc [warps]
// [heads][hd], ml [warps][heads][m, l], base-2 maxima), in order: into
// the output with one split, else into this split's partial (splits, B,
// Hq)
template <typename T>
__device__ void fold_warps(const float* acc, const float* ml, int warps,
                           int heads, int hd, int gn, int d, int64_t row0,
                           int split, int splits, int64_t rows, T* out,
                           float* wm, float* wl, float* wacc, float* lse) {
  for (int e = threadIdx.x; e < gn * d; e += blockDim.x) {
    const int g = e / d, c = e % d;
    float mx = -INFINITY;
    for (int w = 0; w < warps; ++w)
      mx = fmaxf(mx, ml[(w * heads + g) * 2]);
    const float base = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float f = ex2(ml[(w * heads + g) * 2] - base);
      lsum = fmaf(f, ml[(w * heads + g) * 2 + 1], lsum);
      a = fmaf(f, acc[(w * heads + g) * hd + c], a);
    }
    if (splits == 1) {
      out[(row0 + g) * d + c] = from_f<T>(a / (lsum == 0.f ? 1.f : lsum));
      if (lse != nullptr && c == 0) lse[row0 + g] = row_lse(base, lsum);
    } else {
      const int64_t r = split * rows + row0 + g;
      wacc[r * d + c] = a;
      if (c == 0) {
        wm[r] = mx;
        wl[r] = lsum;
      }
    }
  }
}

// after every block wrote its partial: the last block of its (b, head
// group) to take a ticket folds the splits in order 0..splits-1 (whichever
// block it is, so a result repeats bitwise).
// The block's writes reach the others through __syncthreads and one
// thread's acq_rel atomic (release on the way in, acquire for the last
// block); the fold reads the splits 8 at a time, loads first.
template <typename T>
__device__ void finish_splits(int* ticket, int splits, int gn, int d,
                              int64_t row0, int64_t rows, const float* wm,
                              const float* wl, const float* wacc, T* out,
                              float* lse) {
  constexpr int C = 8;   // splits read at once
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(ticket)
                 : "memory");
    last = old == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int e = threadIdx.x; e < gn * d; e += blockDim.x) {
    const int64_t row = row0 + e / d;
    const int c = e % d;
    // a running (max, sum of l, sum of acc) over the splits, in order
    float mx = -INFINITY, lsum = 0.f, a = 0.f;
    for (int s0 = 0; s0 < splits; s0 += C) {
      float m[C], l[C], x[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int64_t r = (s0 + j) * rows + row;
        const bool in = s0 + j < splits;
        m[j] = in ? __ldcg(wm + r) : -INFINITY;
        l[j] = in ? __ldcg(wl + r) : 0.f;
        x[j] = in ? __ldcg(wacc + r * d + c) : 0.f;
      }
      float mn = mx;
#pragma unroll
      for (int j = 0; j < C; ++j) mn = fmaxf(mn, m[j]);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float f0 = ex2(mx - base);
      lsum *= f0;
      a *= f0;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float f = ex2(m[j] - base);
        lsum = fmaf(f, l[j], lsum);
        a = fmaf(f, x[j], a);
      }
      mx = mn;
    }
    out[row * d + c] = from_f<T>(a / (lsum == 0.f ? 1.f : lsum));
    if (lse != nullptr && c == 0)
      lse[row] = row_lse(mx == -INFINITY ? 0.f : mx, lsum);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads, 4)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ lens,
              T* __restrict__ out, float* __restrict__ lse,
              float* __restrict__ wm,
              float* __restrict__ wl, float* __restrict__ wacc,
              int* __restrict__ tickets, int64_t smax, int d, int hq,
              int group, int ngroups, int64_t ksb, int64_t ksh, int64_t kss,
              int64_t vsb, int64_t vsh, int64_t vss, int64_t window,
              float scale_log2) {
  using Tile = DecTile<T, HD>;
  constexpr int V = Tile::V, LPK = Tile::LPK, CPL = Tile::CPL;
  constexpr int KPW = Tile::KPW, NI = Tile::NI;
  constexpr int G = kDecHeads, BK = kDecBK, W = CPL * V;
  extern __shared__ float fold[];   // [warp][G][HD], then [warp][G][m, l]
  const int split = blockIdx.x, splits = gridDim.x;
  const int hk = blockIdx.y / ngroups, g0 = (blockIdx.y % ngroups) * G;
  const int gn = min(G, group - g0);     // heads of this block
  const int64_t b = blockIdx.z, nb = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kg = lane / LPK, cl = lane % LPK;  // key of a step, chunk lane

  const Share sh = share_of(lens[b], smax, window, split, splits, BK);
  const int64_t start = sh.start, end = sh.end;
  const int ntiles = sh.ntiles;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // q's chunks of this lane, float32; zeros past d and past the heads
  const int64_t row0 = b * hq + static_cast<int64_t>(hk) * group + g0;
  float qr[G][W];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int col = (cl + LPK * cc) * V + e;
        qr[g][cc * V + e] =
            g < gn && col < d ? to_f(q[(row0 + g) * d + col]) : 0.f;
      }

  // chunk cc of key step i of tile t (K: kv 0, V: kv 1) as float32
  auto fetch = [&](int t, int i, int cc, int kv, float* dst) {
    const int64_t key =
        start + static_cast<int64_t>(t) * BK + warp * 8 + kg + KPW * i;
    const int col = (cl + LPK * cc) * V;
    const T* src = kv ? vb + key * vss : kb + key * kss;
#pragma unroll
    for (int j = 0; j < V; ++j)
      dst[j] = key < end && col + j < d ? to_f(src[col + j]) : 0.f;
  };

  float m[G], l[G], acc[G][W];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int64_t k0 = start + static_cast<int64_t>(t) * BK + warp * 8 + kg;

    // scores of the warp's 8 keys, scaled to base 2; LPK lanes per key
    float sc[G][NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        float kk[V];
        fetch(t, i, cc, 0, kk);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < V; ++e)
            part[g] = fmaf(qr[g][cc * V + e], kk[e], part[g]);
      }
      const bool valid = k0 + KPW * i < end;
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
        sc[g][i] = valid ? part[g] * scale_log2 : -INFINITY;
      }
    }

    // the warp's running max per head; p and the rescale in base 2
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = sc[g][0];
#pragma unroll
      for (int i = 1; i < NI; ++i) mt = fmaxf(mt, sc[g][i]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mn = fmaxf(m[g], mt);
      // a head masked so far keeps a finite base: exp2() gives 0
      const float base = mn == -INFINITY ? 0.f : mn;
      const float alpha = ex2(m[g] - base);
      m[g] = mn;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        sc[g][i] = ex2(sc[g][i] - base);
        l[g] += sc[g][i];
      }
    }

    // acc += p V over this lane's keys and columns
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        float vv[V];
        fetch(t, i, cc, 1, vv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[g][cc * V + e] = fmaf(sc[g][i], vv[e], acc[g][cc * V + e]);
      }
    }
  }

  // fold the lanes of a column (the warp's keys), then the 4 warps
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < W; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  float* ml = fold + 4 * G * HD;
  if (kg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int e = 0; e < V; ++e)
          fold[(warp * G + g) * HD + (cl + LPK * cc) * V + e] =
              acc[g][cc * V + e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      ml[(warp * G + g) * 2] = m[g];
      ml[(warp * G + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  const int64_t rows = nb * hq;
  fold_warps(fold, ml, 4, G, HD, gn, d, row0, split, splits, rows, out, wm,
             wl, wacc, lse);
  if (splits > 1)
    finish_splits(tickets + b * gridDim.y + blockIdx.y, splits, gn, d, row0,
                  rows, wm, wl, wacc, out, lse);
}

template <typename T, int HD>
int launch_decode(const T* q, const T* k, const T* v, const int32_t* lens,
                  T* out, float* lse, float* wm, float* wl, float* wacc,
                  int* tickets,
                  int64_t b, int64_t hq, int64_t hkv, int64_t smax, int64_t d,
                  const int64_t* st, int64_t window, float scale, int splits,
                  cudaStream_t stream) {
  using Tile = DecTile<T, HD>;
  auto kernel = decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = static_cast<int>(hq / hkv);
  const int ngroups = (group + kDecHeads - 1) / kDecHeads;
  if (splits > 1) {
    err = cudaMemsetAsync(tickets, 0, sizeof(int) * b * hkv * ngroups,
                          stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(splits),
            static_cast<unsigned>(hkv * ngroups), static_cast<unsigned>(b));
  kernel<<<grid, kDecThreads, Tile::kSmem, stream>>>(
      q, k, v, lens, out, lse, wm, wl, wacc, tickets, smax,
      static_cast<int>(d), static_cast<int>(hq), group, ngroups, st[0],
      st[1], st[2], st[3], st[4], st[5], window,
      scale * 1.4426950408889634f);  // scale log2 e
  return 0;
}

// ---------------------------------------------------------------------------
// Tensor-core path: bfloat16 and float16 at even D up to 128, in tiles of
// HD = 64 or 128 columns
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaBK = 16 * kMmaWarps;   // keys per tile: 16 per warp
constexpr int kMmaStages = 3;     // depth of the K/V ring
constexpr int kMmaHeads = 16;     // query heads a block serves: mma's rows

template <int HD>
struct DecMmaTile {
  static constexpr int NH = HD / 64;             // 64-column boxes of a row
  static constexpr uint32_t kTile = kMmaBK * HD * 2;   // bytes of K or V
  // 1024 bytes of slack to align the swizzled tiles
  static constexpr size_t kSmem = 1024 + kMmaStages * 2 * kTile;
};

// byte offset of row r, 16-byte chunk c (of the whole row) in a tile of
// 64-column boxes of BK rows, 128-byte swizzled as TMA writes them
template <int BK>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * (BK * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

template <typename T>
struct Mma16816;
template <>
struct Mma16816<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
};
template <>
struct Mma16816<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr,
                                            bool trans) {
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// FULL: d == HD, so that the width is a constant where the tile is full
template <typename T, int HD, bool FULL>
__global__ void __launch_bounds__(32 * kMmaWarps, 2)
decode_mma_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const T* __restrict__ q, const int32_t* __restrict__ lens,
                  T* __restrict__ out, float* __restrict__ lse,
                  float* __restrict__ wm,
                  float* __restrict__ wl, float* __restrict__ wacc,
                  int* __restrict__ tickets, int64_t smax, int width, int hq,
                  int group, int ngroups, int64_t window, float scale_log2) {
  using Tile = DecMmaTile<HD>;
  const int d = FULL ? HD : width;
  using Mma = Mma16816<T>;
  constexpr int NH = Tile::NH, BK = kMmaBK, ST = kMmaStages;
  constexpr int KS = HD / 16, OT = HD / 8, H = kMmaHeads, NW = kMmaWarps;
  constexpr uint32_t kTile = Tile::kTile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries: [ST][K, V][NH][BK][64]
  unsigned char* ring =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring_a = smem_addr(ring);
  __shared__ uint64_t full[ST], empty[ST];
  const int split = blockIdx.x, splits = gridDim.x;
  const int hk = blockIdx.y / ngroups, g0 = (blockIdx.y % ngroups) * H;
  const int gn = min(H, group - g0);     // heads of this block
  const int64_t b = blockIdx.z, nb = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Share sh = share_of(lens[b], smax, window, split, splits, BK);

  // tile t's K and V rows into stage t % ST, by one thread
  auto load = [&](int t) {
    const int s = t % ST;
    const int row = static_cast<int>(sh.start) + t * BK;
    mbar_expect(full + s, 2 * kTile);   // whole boxes, zero fill included
    for (int c = 0; c < NH; ++c) {
      tma_load(ring + 2 * s * kTile + c * BK * 128, &tk, full + s, c * 64,
               row, hk, static_cast<int>(b));
      tma_load(ring + (2 * s + 1) * kTile + c * BK * 128, &tv, full + s,
               c * 64, row, hk, static_cast<int>(b));
    }
  };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NW);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < ST - 1 && t < sh.ntiles; ++t) load(t);
  }
  __syncthreads();

  // the block's heads as A fragments (rows: heads; k: d), zero past gn
  // and past d (d even: a pair lies wholly below d or wholly past it)
  const int64_t row0 = b * hq + static_cast<int64_t>(hk) * group + g0;
  auto qpair = [&](int r, int col) -> uint32_t {
    return r < gn && col < d
               ? *reinterpret_cast<const uint32_t*>(q + (row0 + r) * d + col)
               : 0u;
  };
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qf[ks][0] = qpair(g, ks * 16 + 2 * t4);
    qf[ks][1] = qpair(g + 8, ks * 16 + 2 * t4);
    qf[ks][2] = qpair(g, ks * 16 + 8 + 2 * t4);
    qf[ks][3] = qpair(g + 8, ks * 16 + 8 + 2 * t4);
  }

  // this warp's running softmax of rows g and g + 8 and its O fragments
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < sh.ntiles; ++t) {
    const int s = t % ST;
    if (tid == 0 && t + ST - 1 < sh.ntiles) {
      const int next = t + ST - 1;   // into the stage tile t - 1 used
      if (next >= ST) mbar_wait(empty + next % ST, (next / ST - 1) & 1);
      load(next);
    }
    mbar_wait(full + s, (t / ST) & 1);
    const int64_t kw = sh.start + static_cast<int64_t>(t) * BK + warp * 16;
    const int rw = warp * 16;                  // the warp's rows of the tile
    const uint32_t kt = ring_a + 2 * s * kTile, vt = kt + kTile;
    if (kw < sh.end) {
      if (kw + 16 > sh.end) {
        // V rows past the share get zeros, so that p = 0 never meets a
        // NaN the cache may hold there (K's are masked below); columns
        // past d hold TMA's zero fill already
        for (int e = lane; e < 16 * OT; e += 32) {
          const int r = e / OT;
          if (kw + r >= sh.end)
            *reinterpret_cast<uint4*>(ring + (vt - ring_a) +
                                      swizzled<BK>(rw + r, e % OT)) =
                make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }

      // S = Q Kᵀ: 16 heads x the warp's 16 keys (two n-tiles of 8)
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < KS / 2; ++k2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + swizzled<BK>(rw + nt * 8 + (lane & 7),
                                            k2 * 4 + (lane >> 3)),
                      false);
          Mma::run(sc[nt], qf[2 * k2], kf);
          Mma::run(sc[nt], qf[2 * k2 + 1], kf + 2);
        }
      }
      // keys past the share, then the online softmax in base 2; a row's
      // 16 scores lie on one quad
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (kw + nt * 8 + 2 * t4 + c >= sh.end)
            sc[nt][c] = sc[nt][2 + c] = -INFINITY;
          x0 = fmaxf(x0, sc[nt][c]);
          x1 = fmaxf(x1, sc[nt][2 + c]);
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
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[nt][c] = ex2(fmaf(sc[nt][c], scale_log2, -b0));
          sc[nt][2 + c] = ex2(fmaf(sc[nt][2 + c], scale_log2, -b1));
        }
      l0 = l0 * a0 + sc[0][0] + sc[0][1] + sc[1][0] + sc[1][1];
      l1 = l1 * a1 + sc[0][2] + sc[0][3] + sc[1][2] + sc[1][3];
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }
      // P as the A fragment of one 16-key k-step, split into hi and lo
      // 16-bit parts, both multiplied: P stays float32-like
      uint32_t ph[4], pl[4];
      Pair<T>::split(sc[0][0], sc[0][1], ph[0], pl[0]);
      Pair<T>::split(sc[0][2], sc[0][3], ph[1], pl[1]);
      Pair<T>::split(sc[1][0], sc[1][1], ph[2], pl[2]);
      Pair<T>::split(sc[1][2], sc[1][3], ph[3], pl[3]);
      // O += P V: V read transposed, two 8-column n-tiles per ldmatrix
#pragma unroll
      for (int j2 = 0; j2 < OT / 2; ++j2) {
        uint32_t vf[4];
        ldmatrix_x4(vf, vt + swizzled<BK>(rw + (lane & 7) +
                                              ((lane >> 3) & 1) * 8,
                                          j2 * 2 + (lane >> 4)),
                    true);
        Mma::run(o[2 * j2], ph, vf);
        Mma::run(o[2 * j2], pl, vf);
        Mma::run(o[2 * j2 + 1], ph, vf + 2);
        Mma::run(o[2 * j2 + 1], pl, vf + 2);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);   // this warp is done
  }

  // fold the warps in shared memory, in order (the ring is free now); the
  // fold keeps HD columns a head, the output and the partials d
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __syncthreads();
  float* fold = reinterpret_cast<float*>(ring);  // [warp][H][HD]
  float* ml = fold + NW * H * HD;                // [warp][H][m, l]
  // only the block's gn real heads: rows g and g + 8
  float* f0 = fold + (warp * H + g) * HD + 2 * t4;
  if (g < gn) {
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      f0[j * 8] = o[j][0];
      f0[j * 8 + 1] = o[j][1];
    }
    if (t4 == 0) {
      ml[(warp * H + g) * 2] = m0;
      ml[(warp * H + g) * 2 + 1] = l0;
    }
  }
  if (g + 8 < gn) {
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      f0[8 * HD + j * 8] = o[j][2];
      f0[8 * HD + j * 8 + 1] = o[j][3];
    }
    if (t4 == 0) {
      ml[(warp * H + g + 8) * 2] = m1;
      ml[(warp * H + g + 8) * 2 + 1] = l1;
    }
  }
  __syncthreads();
  const int64_t rows = nb * hq;
  fold_warps(fold, ml, NW, H, HD, gn, d, row0, split, splits, rows, out, wm,
             wl, wacc, lse);
  if (splits > 1)
    finish_splits(tickets + b * gridDim.y + blockIdx.y, splits, gn, d, row0,
                  rows, wm, wl, wacc, out, lse);
}

template <typename T, int HD, bool FULL>
int launch_decode_mma(const CUtensorMap& tk, const CUtensorMap& tv,
                      const T* q, const int32_t* lens, T* out, float* lse,
                      float* wm,
                      float* wl, float* wacc, int* tickets, int64_t b,
                      int64_t hq, int64_t hkv, int64_t smax, int64_t d,
                      int64_t window, float scale, int splits,
                      cudaStream_t stream) {
  using Tile = DecMmaTile<HD>;
  auto kernel = decode_mma_kernel<T, HD, FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = static_cast<int>(hq / hkv);
  const int ngroups = (group + kMmaHeads - 1) / kMmaHeads;
  if (splits > 1) {
    err = cudaMemsetAsync(tickets, 0, sizeof(int) * b * hkv * ngroups,
                          stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(splits),
            static_cast<unsigned>(hkv * ngroups), static_cast<unsigned>(b));
  kernel<<<grid, 32 * kMmaWarps, Tile::kSmem, stream>>>(
      tk, tv, q, lens, out, lse, wm, wl, wacc, tickets, smax,
      static_cast<int>(d), static_cast<int>(hq), group, ngroups, window,
      scale * 1.4426950408889634f);  // scale log2 e
  return 0;
}

}  // namespace repro

// q (b, hq, d) contiguous; k and v (b, hkv, smax, d) with the strides
// given over (b, head, row) and unit stride over d; lens (b,) int32 on
// the device; out (b, hq, d) contiguous; lse null or (b, hq) float32, the
// rows' log-sum-exp; with splits > 1, wm and wl
// (splits, b, hq) and wacc (splits, b, hq, d) float32 scratch, and
// tickets, b hkv ceil(hq / hkv / 4) int32 scratch counters (zeroed here
// on the stream before the launch). window <= 0: no window. d in 1..256.
extern "C" int repro_decode_attention_simt(
    int dtype, const void* q, const void* k, const void* v,
    const int32_t* lens, void* out, float* lse, float* wm, float* wl,
    float* wacc,
    int* tickets, int64_t b, int64_t hq, int64_t hkv, int64_t smax,
    int64_t d, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
    int64_t vss, int64_t window, float scale, int splits, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[6] = {ksb, ksh, kss, vsb, vsh, vss};
  int err = 0;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* Q = static_cast<const T*>(q);
    const T* K = static_cast<const T*>(k);
    const T* Vc = static_cast<const T*>(v);
    T* O = static_cast<T*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto go = [&](auto hd) {  // hd: std::integral_constant, D's bucket
      err = repro::launch_decode<T, decltype(hd)::value>(
          Q, K, Vc, lens, O, lse, wm, wl, wacc, tickets, b, hq, hkv, smax, d,
          st,
          window, scale, splits, s);
    };
    if (d <= 32)
      go(std::integral_constant<int, 32>{});
    else if (d <= 64)
      go(std::integral_constant<int, 64>{});
    else if (d <= 128)
      go(std::integral_constant<int, 128>{});
    else
      go(std::integral_constant<int, 256>{});
  };
  REPRO_DISPATCH(dtype, run);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The same operands, bfloat16 or float16 at an even d up to 128 (padded to
// a tile of 64 or 128 columns), every base and stride a multiple of 16
// bytes (the wrapper checks; a tensor map that TMA refuses returns
// cudaErrorInvalidValue), with b hkv ceil(hq / hkv / 16) tickets.
extern "C" int repro_decode_attention_mma(
    int dtype, const void* q, const void* k, const void* v,
    const int32_t* lens, void* out, float* lse, float* wm, float* wl,
    float* wacc,
    int* tickets, int64_t b, int64_t hq, int64_t hkv, int64_t smax,
    int64_t d, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
    int64_t vsh, int64_t vss, int64_t window, float scale, int splits,
    void* stream) {
  using repro::kBF16;
  using repro::kF16;
  if ((dtype != kBF16 && dtype != kF16) || d < 2 || d > 128 || d % 2 != 0 ||
      hkv < 1 || hq % hkv != 0 || splits < 1 || smax > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk, tv;
  // 64-column boxes; the maps hold the true width d, so TMA zero-fills the
  // columns past it (and still counts the whole box's bytes)
  constexpr auto kSw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!repro::view_map(&tk, dtype, k, b, hkv, smax, d, ksb, ksh, kss, 64,
                       repro::kMmaBK, kSw128) ||
      !repro::view_map(&tv, dtype, v, b, hkv, smax, d, vsb, vsh, vss, 64,
                       repro::kMmaBK, kSw128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* Q = static_cast<const T*>(q);
    T* O = static_cast<T*>(out);
    auto go = [&](auto hd, auto full) {  // std::integral_constant each
      err = repro::launch_decode_mma<T, decltype(hd)::value,
                                     decltype(full)::value>(
          tk, tv, Q, lens, O, lse, wm, wl, wacc, tickets, b, hq, hkv, smax,
          d, window, scale, splits, s);
    };
    using std::integral_constant;
    if (d == 64)
      go(integral_constant<int, 64>{}, std::true_type{});
    else if (d < 64)
      go(integral_constant<int, 64>{}, std::false_type{});
    else if (d == 128)
      go(integral_constant<int, 128>{}, std::true_type{});
    else
      go(integral_constant<int, 128>{}, std::false_type{});
  };
  if (dtype == kBF16)
    run(static_cast<__nv_bfloat16*>(nullptr));
  else
    run(static_cast<__half*>(nullptr));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
