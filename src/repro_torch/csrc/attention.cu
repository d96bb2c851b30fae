// Flash-attention forward (mha) for Hopper (sm_90a): softmax(q kᵀ · scale)
// v with causal, sliding-window and GQA masking, the running max, sum and
// output accumulator kept in float32 on chip, one rounding to q's dtype.
//
// Replaces src/repro/kernels/attention.py::mha (pallas_call at
// attention.py:92, body _flash_kernel :26). Same function: scores in
// float32 from float32-widened q and k, times scale = d^-0.5; keys masked
// on global ids (kpos < skv; causal qpos >= kpos with queries aligned at
// the end, qpos = i + skv - sq; window qpos - kpos < window); the online
// softmax of the Pallas body, whose fully masked rows keep a finite base
// so that exp() gives 0, not NaN; a row with no visible key writes 0.
//
// Bound on an H100 SXM at Llama-3-8B's prefill (B 8, 32 query heads on 8
// KV heads, S 1781, D 128, bfloat16, causal): the operations, 4 D per
// visible (query, key) pair, 2.1e11 per layer, 0.21 ms at the tensor
// cores' 989 TFLOP/s (bf16 in, f32 accumulate); the bytes (q, k, v read
// once, the output written once) are 0.09 ms. The score matrix never
// reaches HBM.
//
// Design, common to both paths:
// * One block of 128 threads owns one (b, query head, tile of query
//   rows) and walks the key tiles of BK = 64 keys in a loop inside the
//   block, which takes the place of the Pallas kernel's sequential `ki`
//   grid axis. Query head h reads KV head h / group: K and V are never
//   copied per head.
// * Only the key tiles that the causal mask or the window leave partly
//   visible are walked; inside them every element is masked on its
//   global ids. The ragged tails of Q and K are zero-filled in shared
//   memory and masked, never padded in HBM. Blocks with the longest
//   causal walk start first.
// * q, k and v come in with any strides over (b, head, row); the head
//   dimension has unit stride.
//
// The tensor-core path (mha_mma_kernel, below) takes bfloat16 and
// float16 at D 64 and 128 with 16-byte aligned rows: Llama's prefill.
// Everything else (float32, other D up to 256) takes the FFMA path:
// * The thread grid is 16 row groups x 8 column lanes. A thread owns ROWS
//   query rows (4; 2 at D 256) and, of each key tile, the 8 keys
//   lane + 8 j; of the output, the D / 8 columns lane + 8 j. The row max
//   and row sum reduce over the 8 lanes of a row group with shuffles, so
//   m, l and the accumulator stay in registers.
// * Q is staged once in shared memory as float32; K and V take turns in
//   one shared buffer per key tile (K, scores, then V), and the scores'
//   probabilities go through a small shared tile for the P V product.
//   Rows are padded by one float, so the column reads are conflict free.
// * D in buckets of 32, 64, 128 and 256 (the unused columns are zeros).
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
           int64_t skv, int d, int hq, int group, int64_t qsb, int64_t qsh,
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
    stage_rows<T, HD>(vb, vss, k0, skv, d, BK, KV);
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

  // out (B, Hq, Sq, D) contiguous
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int64_t row = q0 + ty * ROWS + i;
    if (row >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* o = out + ((b * hq + h) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 8 * j;
      if (c < d) o[c] = from_f<T>(acc[i][j] / l_safe);
    }
  }
}

template <typename T, int HD>
int launch_mha(const T* q, const T* k, const T* v, T* out, int64_t b,
               int64_t hq, int64_t hkv, int64_t sq, int64_t skv, int64_t d,
               const int64_t* st, int causal, int64_t window, float scale,
               cudaStream_t stream) {
  using Tile = AttnTile<HD>;
  auto kernel = mha_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((sq + Tile::BQ - 1) / Tile::BQ),
            static_cast<unsigned>(hq), static_cast<unsigned>(b));
  kernel<<<grid, kAttnThreads, Tile::kSmem, stream>>>(
      q, k, v, out, sq, skv, static_cast<int>(d), static_cast<int>(hq),
      static_cast<int>(hq / hkv), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale);
  return 0;
}


// ---------------------------------------------------------------------------
// Tensor-core path: bfloat16 and float16 at D 64 and 128 (Llama's prefill)
// ---------------------------------------------------------------------------
//
// The same tiling as above, on mma.sync.m16n8k16 with float32
// accumulators: each of the 4 warps owns 16 of the block's 64 query rows,
// its Q fragments stay in registers, K and V tiles of 64 keys are staged
// in shared memory as they are (16-bit, rows padded by 16 bytes, so
// ldmatrix is conflict free) and fed to the tensor cores with ldmatrix.
// The scores' accumulator fragments are the P operand of the P V product
// without a trip through shared memory. The Pallas kernel multiplies P
// in float32; here P is split into two 16-bit parts, hi = round(p) and
// lo = round(p - hi), and both are multiplied, which keeps P to about
// 16 significant bits (float32-like next to the float32 sums) for one
// more tensor-core product.

constexpr int kMmaBQ = 64;       // 4 warps x 16 query rows
constexpr int kMmaPad = 8;       // elements of row padding (16 bytes)

template <typename T>
struct MmaOp;
template <>
struct MmaOp<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);  // x in the low half
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};
template <>
struct MmaOp<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half(x));
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// rows [row0, row0 + n) of one (b, head) slice, 16 bytes at a time, into
// a shared tile of rows of HD + kMmaPad elements; rows past `limit` are
// zeros
template <typename T, int HD>
__device__ __forceinline__ void stage_rows16(const T* __restrict__ src,
                                             int64_t row_stride, int64_t row0,
                                             int64_t limit, int n,
                                             T* __restrict__ dst) {
  constexpr int V = 8, LDS = HD + kMmaPad;
  for (int e = threadIdx.x; e < n * (HD / V); e += kAttnThreads) {
    const int r = e / (HD / V), c = (e % (HD / V)) * V;
    const int64_t row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit)
      val = __ldg(reinterpret_cast<const uint4*>(src + row * row_stride + c));
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kAttnThreads)
mha_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out, int64_t sq,
               int64_t skv, int hq, int group, int64_t qsb, int64_t qsh,
               int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
               int64_t vsb, int64_t vsh, int64_t vss, int causal,
               int64_t window, float scale) {
  constexpr int BQ = kMmaBQ, BK = kAttnBK, LDS = HD + kMmaPad;
  constexpr int KS = HD / 16;   // k-steps of the scores' product
  constexpr int NT = BK / 8;    // key n-tiles of a score tile
  constexpr int OT = HD / 8;    // output n-tiles
  using Op = MmaOp<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BQ][LDS]
  T* Ks = Qs + BQ * LDS;                    // [BK][LDS]
  T* Vs = Ks + BK * LDS;                    // [BK][LDS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qt = static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t q0 = qt * BQ;
  const int64_t off = skv - sq;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + static_cast<int64_t>(h / group) * ksh;
  const T* vb = v + b * vsb + static_cast<int64_t>(h / group) * vsh;

  stage_rows16<T, HD>(qb, qss, q0, sq, BQ, Qs);
  __syncthreads();
  uint32_t qf[KS][4];           // this warp's 16 query rows, A fragments
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LDS + ks * 16 +
                            (lane >> 4) * 8);

  const int64_t qlast = (q0 + BQ < sq ? q0 + BQ : sq) - 1;
  int64_t khi = skv;
  if (causal && qlast + off + 1 < khi) khi = qlast + off + 1;
  int64_t klo = 0;
  if (window > 0 && q0 + off - window + 1 > 0) klo = q0 + off - window + 1;

  // rows r0 = g and r1 = g + 8 of the warp's 16
  const int64_t qpos0 = q0 + warp * 16 + g + off, qpos1 = qpos0 + 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int64_t k0 = klo; k0 < khi; k0 += BK) {
    __syncthreads();  // the last tile's K and V reads are done
    stage_rows16<T, HD>(kb, kss, k0, skv, BK, Ks);
    stage_rows16<T, HD>(vb, vss, k0, skv, BK, Vs);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < KS / 2; ++k2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (nt * 8 + (lane & 7)) * LDS + k2 * 32 +
                            (lane >> 3) * 8);
        Op::run(s[nt], qf[2 * k2], kf);
        Op::run(s[nt], qf[2 * k2 + 1], kf + 2);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t qpos = i < 2 ? qpos0 : qpos1;
        const int64_t kpos = k0 + nt * 8 + 2 * t + (i & 1);
        bool ok = kpos < skv;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[nt][i] = ok ? s[nt][i] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // a row's 64 scores lie on the 4 lanes of one quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float ms0 = isfinite(mn0) ? mn0 : 0.f;
    const float ms1 = isfinite(mn1) ? mn1 : 0.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - ms0);
      s[nt][1] = expf(s[nt][1] - ms0);
      s[nt][2] = expf(s[nt][2] - ms1);
      s[nt][3] = expf(s[nt][3] - ms1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float a0 = expf(m[0] - ms0), a1 = expf(m[1] - ms1);
    l[0] = a0 * l[0] + sum0;
    l[1] = a1 * l[1] + sum1;
    m[0] = mn0;
    m[1] = mn1;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the scores of keys 16 kk .. 16 kk + 15 as A fragments, hi and lo
      const float* c0 = s[2 * kk];
      const float* c1 = s[2 * kk + 1];
      uint32_t ph[4], pl[4];
      const float h00 = Op::round(c0[0]), h01 = Op::round(c0[1]);
      const float h02 = Op::round(c0[2]), h03 = Op::round(c0[3]);
      const float h10 = Op::round(c1[0]), h11 = Op::round(c1[1]);
      const float h12 = Op::round(c1[2]), h13 = Op::round(c1[3]);
      ph[0] = Op::pack(h00, h01);
      ph[1] = Op::pack(h02, h03);
      ph[2] = Op::pack(h10, h11);
      ph[3] = Op::pack(h12, h13);
      pl[0] = Op::pack(c0[0] - h00, c0[1] - h01);
      pl[1] = Op::pack(c0[2] - h02, c0[3] - h03);
      pl[2] = Op::pack(c1[0] - h10, c1[1] - h11);
      pl[3] = Op::pack(c1[2] - h12, c1[3] - h13);
#pragma unroll
      for (int j2 = 0; j2 < OT / 2; ++j2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LDS +
                                  j2 * 16 + (lane >> 4) * 8);
        Op::run(o[2 * j2], ph, vf);
        Op::run(o[2 * j2], pl, vf);
        Op::run(o[2 * j2 + 1], ph, vf + 2);
        Op::run(o[2 * j2 + 1], pl, vf + 2);
      }
    }
  }

  const float ls0 = l[0] == 0.f ? 1.f : l[0];
  const float ls1 = l[1] == 0.f ? 1.f : l[1];
  const int64_t row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < sq) {
      T* p = out + ((b * hq + h) * sq + row0) * HD + c;
      p[0] = from_f<T>(o[j][0] / ls0);
      p[1] = from_f<T>(o[j][1] / ls0);
    }
    if (row0 + 8 < sq) {
      T* p = out + ((b * hq + h) * sq + row0 + 8) * HD + c;
      p[0] = from_f<T>(o[j][2] / ls1);
      p[1] = from_f<T>(o[j][3] / ls1);
    }
  }
}

template <typename T, int HD>
int launch_mha_mma(const T* q, const T* k, const T* v, T* out, int64_t b,
                   int64_t hq, int64_t hkv, int64_t sq, int64_t skv,
                   const int64_t* st, int causal, int64_t window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(T) * (kMmaBQ + 2 * kAttnBK) * (HD + kMmaPad);
  auto kernel = mha_mma_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((sq + kMmaBQ - 1) / kMmaBQ),
            static_cast<unsigned>(hq), static_cast<unsigned>(b));
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      q, k, v, out, sq, skv, static_cast<int>(hq),
      static_cast<int>(hq / hkv), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale);
  return 0;
}

// the tensor-core path takes 16-bit types at D 64 or 128 whose rows start
// on 16-byte boundaries
template <typename T>
constexpr bool kHasMma = !std::is_same<T, float>::value;

template <typename T, int HD>
int launch_mha_any(const T* q, const T* k, const T* v, T* out, int64_t b,
                   int64_t hq, int64_t hkv, int64_t sq, int64_t skv,
                   int64_t d, const int64_t* st, int causal, int64_t window,
                   float scale, cudaStream_t stream) {
  if constexpr (kHasMma<T> && (HD == 64 || HD == 128)) {
    bool fits = d == HD && aligned16(q) && aligned16(k) && aligned16(v);
    for (int i = 0; i < 9; ++i) fits = fits && st[i] % 8 == 0;
    if (fits)
      return launch_mha_mma<T, HD>(q, k, v, out, b, hq, hkv, sq, skv, st,
                                   causal, window, scale, stream);
  }
  return launch_mha<T, HD>(q, k, v, out, b, hq, hkv, sq, skv, d, st, causal,
                           window, scale, stream);
}

}  // namespace repro

// q (b, hq, sq, d), k and v (b, hkv, skv, d), one dtype, each with the
// strides (over b, head, row) given and unit stride over d; out (b, hq,
// sq, d) contiguous. window <= 0: no window. d in 1..256.
extern "C" int repro_mha(int dtype, const void* q, const void* k,
                         const void* v, void* out, int64_t b, int64_t hq,
                         int64_t hkv, int64_t sq, int64_t skv, int64_t d,
                         int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                         int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                         int64_t vss, int causal, int64_t window, float scale,
                         void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  int err = 0;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* Q = static_cast<const T*>(q);
    const T* K = static_cast<const T*>(k);
    const T* V = static_cast<const T*>(v);
    T* O = static_cast<T*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto go = [&](auto hd) {  // hd: std::integral_constant, D's bucket
      err = repro::launch_mha_any<T, decltype(hd)::value>(
          Q, K, V, O, b, hq, hkv, sq, skv, d, st, causal, window, scale, s);
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
