// Shared device helpers of the CBAM kernels (avg_max_pool.cu,
// gated_spatial_stats.cu, cbam_tail.cu) and of SegNet's indexed pool and
// unpool (unpool.cu, which also takes int8 codes): dtype conversion, the per-op
// rounding of a bf16 computation, NaN-keeping max, and 16-byte vector
// loads and stores of VEC consecutive channels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cbam {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return float(v); }  // exact

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// int8 codes travel as exact floats (a code, or a code times 0 or 1)
template <>
__device__ __forceinline__ int8_t from_float<int8_t>(float v) { return int8_t(__float2int_rn(v)); }

// v rounded to T and widened again: the rounding after each op of a T computation
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// running max from -inf that keeps a NaN once seen, as torch.amax and jnp.max do
// (fmaxf would drop it)
__device__ __forceinline__ float nanmax(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

// relu that keeps NaN, as torch.relu and jax.nn.relu do
__device__ __forceinline__ float relu_keep_nan(float v) { return v < 0.0f ? 0.0f : v; }

// VEC consecutive elements at p as floats; one 16-byte load when VEC * sizeof(T)
// == 16 (the caller guarantees the alignment), else scalar loads
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_float(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_float(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_float<T>(f[j]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_float<T>(f[j]);
  }
}

}  // namespace cbam

// dtype codes of the C entry points: 0 float32, 1 bfloat16. `vec` != 1 selects
// the 16-byte path (8 bf16 or 4 f32 channels a load); the caller checks that C
// is a multiple of it and that every pointer is 16-byte aligned.
#define CBAM_DISPATCH(dtype, vec, FN, ...)                                     \
  ((dtype) == 1 ? ((vec) != 1 ? FN<__nv_bfloat16, 8>(__VA_ARGS__)              \
                              : FN<__nv_bfloat16, 1>(__VA_ARGS__))             \
                : ((vec) != 1 ? FN<float, 4>(__VA_ARGS__) : FN<float, 1>(__VA_ARGS__)))
