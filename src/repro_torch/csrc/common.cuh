// Shared helpers of the port's CUDA kernels: element conversions, a warp
// sum, 16-byte loads and four-element shared-memory reads, the
// fixed-order combine of per-block partials (gemm's split plans); the
// once-per-device shared-memory opt-in, mbarriers, TMA loads and tensor
// maps (gemm, symv and the attention kernels) and 16-bit pairs
// (attention). Tensor maps come from
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so no
// library needs -lcuda.
//
// Every C entry point returns cudaGetLastError() after its launches;
// the Python wrapper raises when that is not cudaSuccess. Nothing here
// allocates or synchronises: the wrapper allocates outputs and scratch
// with torch.empty and the kernels run on the stream it passes.
#pragma once

#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with kernels/cuda.py
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// elements of T in one 16-byte load
template <typename T>
__host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

// one 16-byte load of VEC elements of a streamed operand (evict-first:
// the matrix is read once and would only push x out of the caches)
template <typename T>
__device__ __forceinline__ void load_stream(const T* p, float* out) {
  float4 raw = __ldcs(reinterpret_cast<const float4*>(p));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < vec_width<T>(); ++k) out[k] = to_f(v[k]);
}

// the same through the read-only cache, for the reused vector x
template <typename T>
__device__ __forceinline__ void load_cached(const T* p, float* out) {
  float4 raw = __ldg(reinterpret_cast<const float4*>(p));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < vec_width<T>(); ++k) out[k] = to_f(v[k]);
}

// four consecutive elements of T in shared memory, widened
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = to_f(v[q]);
}

// butterfly sum over the 32 lanes of a warp; the order is fixed, so a
// result repeats bitwise
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

inline bool aligned16(const void* p) {  // host: picks the 16-byte path
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// out[i] = alpha * sum_s work[s, i] + beta * y[i], s in order 0..S-1.
// It takes the place of the TPU kernels' sequential grid axis, which
// carried one accumulator from step to step: blocks here run in
// parallel, so each writes a float32 partial and this second launch
// folds them in a fixed order, with no float atomics.
template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ work, const T* __restrict__ y,
               T* __restrict__ out, const float* __restrict__ scal,
               int64_t len, int splits) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += work[s * len + i];
  out[i] = from_f<T>(scal[0] * acc + scal[1] * to_f(y[i]));
}

template <typename T>
void launch_combine(const float* work, const T* y, T* out,
                    const float* scal, int64_t len, int splits,
                    cudaStream_t stream) {
  unsigned blocks = static_cast<unsigned>((len + 255) / 256);
  combine_kernel<T><<<blocks, 256, 0, stream>>>(work, y, out, scal, len,
                                                splits);
}

// let `kernel` use `bytes` of dynamic shared memory (above 48 KB only
// after this opt-in), once per device: `raised` is the caller's static
// record of the devices done, one per kernel instantiation
template <typename K>
int allow_smem(K kernel, int bytes, std::atomic<uint64_t>& raised) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit);
  }
  return 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA transfers
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map at (c0, c1, c2, c3) into shared memory;
// completion is reported to `bar` as transferred bytes
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// one box of a 2-D tensor map at (c0, c1) into shared memory under an
// L2 cache policy (from createpolicy); completion is reported to `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as one register of two 16-bit values (x in the low half),
// rounded to nearest; split() also gives the rounding's remainder
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void split(float x, float y,
                                               uint32_t& hi, uint32_t& lo) {
    hi = pack(x, y);
    lo = pack(x - __uint_as_float(hi << 16),
              y - __uint_as_float(hi & 0xffff0000u));
  }
};
template <>
struct Pair<__half> {
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void split(float x, float y,
                                               uint32_t& hi, uint32_t& lo) {
    __half2 h = __floats2half2_rn(x, y);
    const float2 r = __half22float2(h);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = pack(x - r.x, y - r.y);
  }
};

// ---------------------------------------------------------------------------
// wgmma (sm_90a): shared-memory descriptors, fences, and the accumulator
// operand lists of the attention and gemm kernels
// ---------------------------------------------------------------------------

// wgmma shared-memory descriptor of a 128-byte swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers that an
// asynchronous wgmma reads or writes
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime: the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-D tensor map (d, row, head, b) over a (B, H, S, D) view of 16-bit
// elements (dtype code kBF16 or kF16), with the strides given (elements;
// each a multiple of 16 bytes, as is the base), in boxes of `cols` x
// `rows`; rows past S read as zeros
inline bool view_map(CUtensorMap* map, int dtype, const void* base,
                     int64_t b, int64_t h, int64_t s, int64_t d, int64_t sb,
                     int64_t sh, int64_t ss, int cols, int rows,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t bytes = 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * bytes,
                                 static_cast<cuuint64_t>(sh) * bytes,
                                 static_cast<cuuint64_t>(sb) * bytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = dtype == kBF16
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return enc(map, type, 4, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D tensor map over a row-major (rows, cols) matrix of dtype code
// `dtype` (the base and the row stride of cols elements multiples of 16
// bytes), in boxes of `box_cols` x `box_rows`; elements past the edge
// read as zeros
inline bool matrix_map(CUtensorMap* map, int dtype, const void* base,
                       int64_t rows, int64_t cols, int box_cols,
                       int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t bytes = dtype == kF32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType type =
      dtype == kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace repro

// instantiate `body` (a lambda over a typed null pointer) for the
// dtype code; returns cudaErrorInvalidValue for an unknown code
#define REPRO_DISPATCH(dtype, body)                              \
  switch (dtype) {                                               \
    case repro::kF32: body(static_cast<float*>(nullptr)); break; \
    case repro::kBF16:                                           \
      body(static_cast<__nv_bfloat16*>(nullptr));                \
      break;                                                     \
    case repro::kF16: body(static_cast<__half*>(nullptr)); break; \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }

// the accumulators of an m64nNk16 wgmma as asm operands, and their
// register list
#define REPRO_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_D32 REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24)
#define REPRO_D64 \
  REPRO_D32, REPRO_D8(32), REPRO_D8(40), REPRO_D8(48), REPRO_D8(56)
#define REPRO_R32                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
  "%8, %9, %10, %11, %12, %13, %14, %15,"                                 \
  "%16, %17, %18, %19, %20, %21, %22, %23,"                               \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define REPRO_R64                                                         \
  REPRO_R32 ","                                                           \
  "%32, %33, %34, %35, %36, %37, %38, %39,"                               \
  "%40, %41, %42, %43, %44, %45, %46, %47,"                               \
  "%48, %49, %50, %51, %52, %53, %54, %55,"                               \
  "%56, %57, %58, %59, %60, %61, %62, %63"
