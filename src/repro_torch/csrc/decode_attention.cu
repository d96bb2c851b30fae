// Decode attention for Hopper (sm_90a): one new query token per sequence
// over a KV cache, all G = Hq / Hkv query heads of a KV head together, a
// per-row cache length and an optional sliding window; float32 softmax
// state, one rounding to q's dtype.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention
// (pallas_call at decode_attention.py:85, body _decode_kernel :23). Same
// function: the valid keys of row b are kpos < len[b] and, with a window,
// kpos >= len[b] - window; scores in float32 times scale = d^-0.5; the
// online softmax of the Pallas body; a row with no valid key (len 0)
// gives 0. A len above the cache's capacity is read as the capacity.
//
// Bound on an H100 SXM at Llama-3-8B's decode (B 8, 8 KV heads of 128,
// ~1800 cached tokens, bfloat16): the bytes of the valid K and V rows,
// 2 B Hkv len D 2 = 59 MB per layer, 17.6 us at 3.35 TB/s; the
// operations (4 D per query head and key, 7.5e7) are nothing beside
// them. The kernel reads only the valid range [lo, len), never the whole
// capacity, and each K/V row once for all G heads that share it.
//
// Design:
// * B Hkv = 64 blocks of one (b, KV head) would leave half of the 132
//   SMs idle, so the valid range is split across grid.x (`splits`, chosen
//   by the wrapper from the cache's capacity, since the lengths stay on
//   the device): block s takes the s-th equal share of [lo, len), read
//   from the device, and walks it in tiles of 64 keys.
// * A tile's K and V rows go to shared memory as float32 through 16-byte
//   streaming loads (evict-first: the cache is read once per step); the
//   G x 64 scores go to shared memory, one warp per head takes their max
//   and sum, and the G x D accumulator is updated from the V tile.
// * Each block writes its (m, l, acc) partial in float32; a second
//   launch folds the splits in a fixed order (m = max m_s, l = sum
//   e^(m_s - m) l_s, acc likewise) and divides once. No atomics: a result
//   repeats bitwise. With one split the block writes the output itself.
// * The cache comes in as a strided (B, Hkv, Smax, D) view of the
//   model's (B, Smax, Hkv, D) layer cache: strides over (b, head, row),
//   unit stride over d. q is a contiguous (B, Hq, D).
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kDecThreads = 128;
constexpr int kDecBK = 64;  // keys per tile: two per lane of a warp

// floats of shared memory for G heads of width d
__host__ __device__ inline int64_t decode_smem_floats(int g, int d) {
  return 2LL * g * d + 2LL * kDecBK * (d + 1) + static_cast<int64_t>(g) *
         kDecBK + 3LL * g;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// rows [row0, row0 + n) of one (b, head) cache slice into a shared tile
// of rows of d + 1 floats
template <typename T, bool VEC>
__device__ __forceinline__ void stage_cache(const T* __restrict__ src,
                                            int64_t row_stride, int64_t row0,
                                            int n, int d,
                                            float* __restrict__ dst) {
  const int ld = d + 1;
  if constexpr (VEC) {
    constexpr int V = vec_width<T>();
    const int per_row = d / V;
    for (int e = threadIdx.x; e < n * per_row; e += kDecThreads) {
      const int r = e / per_row, c = (e % per_row) * V;
      float tmp[V];
      load_stream(src + (row0 + r) * row_stride + c, tmp);
#pragma unroll
      for (int i = 0; i < V; ++i) dst[r * ld + c + i] = tmp[i];
    }
  } else {
    for (int e = threadIdx.x; e < n * d; e += kDecThreads) {
      const int r = e / d, c = e % d;
      dst[r * ld + c] = to_f(src[(row0 + r) * row_stride + c]);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ lens,
              T* __restrict__ out, float* __restrict__ wm,
              float* __restrict__ wl, float* __restrict__ wacc, int64_t smax,
              int d, int hq, int group, int64_t ksb, int64_t ksh,
              int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
              int64_t window, float scale) {
  const int split = blockIdx.x, splits = gridDim.x;
  const int hk = blockIdx.y;
  const int64_t b = blockIdx.z, nb = gridDim.z;
  const int G = group, ld = d + 1, BK = kDecBK;
  extern __shared__ float smem[];
  float* Qs = smem;              // [G][d]
  float* Acc = Qs + G * d;       // [G][d]
  float* Ks = Acc + G * d;       // [BK][d + 1]
  float* Vs = Ks + BK * ld;      // [BK][d + 1]
  float* Ss = Vs + BK * ld;      // [G][BK]
  float* Ms = Ss + G * BK;       // [G] running max
  float* Ls = Ms + G;            // [G] running sum
  float* As = Ls + G;            // [G] this tile's rescale
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qb = q + (b * hq + static_cast<int64_t>(hk) * G) * d;
  for (int e = tid; e < G * d; e += kDecThreads) {
    Qs[e] = to_f(qb[e]);
    Acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kDecThreads) {
    Ms[g] = -INFINITY;
    Ls[g] = 0.f;
  }

  // this block's share of the valid range [lo, hi)
  int64_t hi = lens[b];
  if (hi > smax) hi = smax;
  if (hi < 0) hi = 0;
  int64_t lo = 0;
  if (window > 0 && hi - window > 0) lo = hi - window;
  const int64_t chunk = (hi - lo + splits - 1) / splits;
  const int64_t start = lo + split * chunk;
  const int64_t end = start + chunk < hi ? start + chunk : hi;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int64_t k0 = start; k0 < end; k0 += BK) {
    const int nt = static_cast<int>(end - k0 < BK ? end - k0 : BK);
    __syncthreads();  // q staged; the last tile's reads are done
    stage_cache<T, VEC>(kb, kss, k0, nt, d, Ks);
    stage_cache<T, VEC>(vb, vss, k0, nt, d, Vs);
    __syncthreads();
    for (int e = tid; e < G * BK; e += kDecThreads) {
      const int g = e / BK, j = e % BK;
      float s = -INFINITY;
      if (j < nt) {
        float dot = 0.f;
        for (int c = 0; c < d; ++c)
          dot = fmaf(Qs[g * d + c], Ks[j * ld + c], dot);
        s = dot * scale;
      }
      Ss[e] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kDecThreads / 32) {
      const float s0 = Ss[g * BK + lane], s1 = Ss[g * BK + lane + 32];
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p0 = expf(s0 - m_safe), p1 = expf(s1 - m_safe);
      Ss[g * BK + lane] = p0;
      Ss[g * BK + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_safe);
        Ls[g] = alpha * Ls[g] + sum;
        As[g] = alpha;
        Ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * d; e += kDecThreads) {
      const int g = e / d, c = e % d;
      float a = Acc[e] * As[g];
      for (int j = 0; j < nt; ++j) a = fmaf(Ss[g * BK + j], Vs[j * ld + c], a);
      Acc[e] = a;
    }
  }
  __syncthreads();

  const int64_t row0 = b * hq + static_cast<int64_t>(hk) * G;  // of (B, Hq)
  for (int e = tid; e < G * d; e += kDecThreads) {
    const int g = e / d, c = e % d;
    if (splits == 1) {
      const float l = Ls[g];
      out[(row0 + g) * d + c] = from_f<T>(Acc[e] / (l == 0.f ? 1.f : l));
    } else {
      const int64_t r = split * nb * hq + row0 + g;  // of (splits, B, Hq)
      wacc[r * d + c] = Acc[e];
      if (c == 0) {
        wm[r] = Ms[g];
        wl[r] = Ls[g];
      }
    }
  }
}

// out[row] = sum_s e^(m_s - m) acc_s / sum_s e^(m_s - m) l_s, m = max_s
// m_s, s in order 0..splits-1; rows = B Hq
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decode_combine_kernel(const float* __restrict__ wm,
                      const float* __restrict__ wl,
                      const float* __restrict__ wacc, T* __restrict__ out,
                      int splits, int64_t rows, int d) {
  const int64_t row = blockIdx.x;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, wm[s * rows + row]);
  const float m_safe = isfinite(m) ? m : 0.f;
  float l = 0.f;
  for (int s = 0; s < splits; ++s)
    l += expf(wm[s * rows + row] - m_safe) * wl[s * rows + row];
  const float l_safe = l == 0.f ? 1.f : l;
  for (int c = threadIdx.x; c < d; c += kDecThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      a = fmaf(expf(wm[s * rows + row] - m_safe),
               wacc[(s * rows + row) * d + c], a);
    out[row * d + c] = from_f<T>(a / l_safe);
  }
}

}  // namespace repro

// q (b, hq, d) contiguous; k and v (b, hkv, smax, d) with the strides
// given over (b, head, row) and unit stride over d; lens (b,) int32 on
// the device; out (b, hq, d) contiguous; with splits > 1, wm and wl
// (splits, b, hq) and wacc (splits, b, hq, d) float32 scratch. window
// <= 0: no window. d in 1..256.
extern "C" int repro_decode_attention(
    int dtype, const void* q, const void* k, const void* v,
    const int32_t* lens, void* out, float* wm, float* wl, float* wacc,
    int64_t b, int64_t hq, int64_t hkv, int64_t smax, int64_t d,
    int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
    int64_t vss, int64_t window, float scale, int splits, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = static_cast<int>(hq / hkv);
  const size_t smem = sizeof(float) * repro::decode_smem_floats(
      g, static_cast<int>(d));
  int err = 0;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int V = repro::vec_width<T>();
    const T* Q = static_cast<const T*>(q);
    const T* K = static_cast<const T*>(k);
    const T* Vc = static_cast<const T*>(v);
    T* O = static_cast<T*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = d % V == 0 && ksb % V == 0 && ksh % V == 0 &&
                     kss % V == 0 && vsb % V == 0 && vsh % V == 0 &&
                     vss % V == 0 && repro::aligned16(k) &&
                     repro::aligned16(v);
    auto kernel = vec ? repro::decode_kernel<T, true>
                      : repro::decode_kernel<T, false>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      err = static_cast<int>(e);
      return;
    }
    dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(hkv),
              static_cast<unsigned>(b));
    kernel<<<grid, repro::kDecThreads, smem, s>>>(
        Q, K, Vc, lens, O, wm, wl, wacc, smax, static_cast<int>(d),
        static_cast<int>(hq), g, ksb, ksh, kss, vsb, vsh, vss, window, scale);
    if (splits > 1)
      repro::decode_combine_kernel<T>
          <<<static_cast<unsigned>(b * hq), repro::kDecThreads, 0, s>>>(
              wm, wl, wacc, O, splits, b * hq, static_cast<int>(d));
  };
  REPRO_DISPATCH(dtype, run);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
