// SegNet's indexed 2x2/stride-2 max pool and its inverse, the max unpool.
//
// Replaces the TPU kernels of coastline/pallas/unpool.py, with the function of
// the XLA formulation that SegNet runs (coastline/ops/primitives.py:340-375):
//   * max_pool_with_indices_pallas: x (B, H, W, C) -> vals (B, H/2, W/2, C) in
//     x's dtype and int32 codes, the row-major position 0..3 of each 2x2
//     window's first maximum (jnp.argmax: a tie goes to the first, a NaN
//     counts as the maximum and the first NaN wins). vals is XLA's max, which
//     takes +0.0 over -0.0 in a tie of zeros, so it is the element at the code
//     except where a window's maximum is a zero of both signs;
//   * max_unpool_pallas: vals, codes (B, h, w, C) -> out (B, 2h, 2w, C), with
//     vals * (codes == k) at window position k. It multiplies, as the JAX
//     package does: the zeros carry the value's sign, and an inf or NaN value
//     writes NaN into the other three positions.
// On SegNet's eval path each runs 4 times a forward, once per level.
//
// What bounds them on an H100: a few comparisons or multiplies an element, so
// HBM bytes. The pool reads x once and writes the values and the int32 codes
// (the JAX interface: the codes are 2/3 of its output bytes); the unpool moves
// the same bytes the other way. At SegNet's top level, bf16 x (8, 512, 512, 64):
// 268.4 MB in, 67.1 + 134.2 MB out, 0.140 ms at 3.35 TB/s.
//
// Design. The TPU kernels stage row tiles in VMEM and build the window by
// reshapes; here a thread owns one output pixel (pool) or input pixel (unpool)
// and VEC consecutive channels (16 bytes: 8 bf16 or 4 float32; VEC = 1 where C
// or an address does not allow it). The pool's four window loads and the
// unpool's four window stores are 16-byte vectors, and neighbouring threads
// touch neighbouring channel groups, so every access is coalesced; a warp's
// (0, 0) and (0, 1) accesses together cover whole rows of the input. The
// comparisons are on the exact float widening of the input, with a strict >
// in window order, so ties keep the first position bit for bit. One pass, no
// shared memory, a grid-stride loop over the items.

#include "cbam_common.cuh"

namespace {

using namespace cbam;

// VEC int32 codes at p: 16-byte vectors where VEC allows (the caller checks the
// alignment), else scalars
template <int VEC>
__device__ __forceinline__ void load_codes(const int* __restrict__ p, int (&k)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const int4 u = __ldg(reinterpret_cast<const int4*>(p) + q);
      k[4 * q] = u.x; k[4 * q + 1] = u.y; k[4 * q + 2] = u.z; k[4 * q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) k[j] = p[j];
  }
}

template <int VEC>
__device__ __forceinline__ void store_codes(int* __restrict__ p, const int (&k)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      reinterpret_cast<int4*>(p)[q] = make_int4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = k[j];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
max_pool_idx_kernel(const T* __restrict__ x, T* __restrict__ vals, int* __restrict__ codes,
                    int W2, int C, size_t items) {
  const int G = C / VEC;
  for (size_t i = size_t(blockIdx.x) * THREADS + threadIdx.x; i < items;
       i += size_t(gridDim.x) * THREADS) {
    const int c0 = int(i % G) * VEC;
    const size_t px = i / G;       // output pixel (b, oy, ox)
    const size_t row = px / W2;    // b * H/2 + oy: input row 2 * row
    const int ox = int(px - row * W2);
    const T* top = x + ((2 * row) * (2 * size_t(W2)) + 2 * ox) * C + c0;
    const T* bot = top + 2 * size_t(W2) * C;
    float f[4][VEC];
    load_vec<T, VEC>(top, f[0]);
    load_vec<T, VEC>(top + C, f[1]);
    load_vec<T, VEC>(bot, f[2]);
    load_vec<T, VEC>(bot + C, f[3]);
    float best[VEC];
    int code[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      best[j] = f[0][j];
      code[j] = 0;
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        const float v = f[k][j];
        const bool have_nan = best[j] != best[j];  // the first NaN stays
        if (!have_nan && (v > best[j] || v != v)) {
          best[j] = v;
          code[j] = k;
        } else if (v == best[j]) {  // equal values have equal bits, but for +0 / -0:
          best[j] = __uint_as_float(__float_as_uint(best[j]) & __float_as_uint(v));  // +0 wins
        }
      }
    }
    store_vec<T, VEC>(vals + px * C + c0, best);
    store_codes<VEC>(codes + px * C + c0, code);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
max_unpool_kernel(const T* __restrict__ vals, const int* __restrict__ codes, T* __restrict__ out,
                  int w, int C, size_t items) {
  const int G = C / VEC;
  for (size_t i = size_t(blockIdx.x) * THREADS + threadIdx.x; i < items;
       i += size_t(gridDim.x) * THREADS) {
    const int c0 = int(i % G) * VEC;
    const size_t px = i / G;     // input pixel (b, y, x)
    const size_t row = px / w;   // b * h + y: output row 2 * row
    const int xx = int(px - row * w);
    float v[VEC];
    int k[VEC];
    load_vec<T, VEC>(vals + px * C + c0, v);
    load_codes<VEC>(codes + px * C + c0, k);
    T* top = out + ((2 * row) * (2 * size_t(w)) + 2 * xx) * C + c0;
    T* bot = top + 2 * size_t(w) * C;
    T* dst[4] = {top, top + C, bot, bot + C};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = v[j] * (k[j] == q ? 1.0f : 0.0f);  // v * onehot
      store_vec<T, VEC>(dst[q], o);
    }
  }
}

unsigned grid_for(size_t items) {
  const size_t blocks = (items + THREADS - 1) / THREADS;
  return unsigned(blocks < (size_t(1) << 30) ? blocks : (size_t(1) << 30));
}

template <typename T, int VEC>
int launch_pool(const void* x, void* vals, void* codes, int B, int H, int W, int C,
                cudaStream_t stream) {
  const size_t items = size_t(B) * (H / 2) * (W / 2) * (C / VEC);
  max_pool_idx_kernel<T, VEC><<<grid_for(items), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(vals), static_cast<int*>(codes), W / 2, C, items);
  return int(cudaGetLastError());
}

template <typename T, int VEC>
int launch_unpool(const void* vals, const void* codes, void* out, int B, int h, int w, int C,
                  cudaStream_t stream) {
  const size_t items = size_t(B) * h * w * (C / VEC);
  max_unpool_kernel<T, VEC><<<grid_for(items), THREADS, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(codes), static_cast<T*>(out), w, C,
      items);
  return int(cudaGetLastError());
}

}  // namespace

// x (B, H, W, C) dt -> vals (B, H/2, W/2, C) dt, codes (B, H/2, W/2, C) int32; H, W even.
extern "C" int coastline_max_pool_with_indices(const void* x, void* vals, void* codes, int B, int H,
                                               int W, int C, int dtype, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2) return int(cudaErrorInvalidValue);
  return CBAM_DISPATCH(dtype, vec, launch_pool, x, vals, codes, B, H, W, C,
                       static_cast<cudaStream_t>(stream));
}

// vals (B, h, w, C) dt, codes (B, h, w, C) int32 -> out (B, 2h, 2w, C) dt.
extern "C" int coastline_max_unpool(const void* vals, const void* codes, void* out, int B, int h,
                                    int w, int C, int dtype, int vec, void* stream) {
  if (B <= 0 || h <= 0 || w <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  return CBAM_DISPATCH(dtype, vec, launch_unpool, vals, codes, out, B, h, w, C,
                       static_cast<cudaStream_t>(stream));
}
