// CBAM spatial-attention input from the channel-gated activation.
//
// Replaces the TPU kernel coastline/pallas/cbam.py::gated_spatial_stats:
//   x (B, H, W, C), gate (B, C) -> out (B, 2, H, W),
//   z = dt(x * gate), out[:, 0] = dt(sum_f32(z) / C), out[:, 1] = max_c(z),
// in x's dtype dt (bfloat16 or float32); z is never written. On the Robust
// U-Net eval path it runs once per ResidualBlock, 9 a forward.
//
// What bounds it on an H100: one read of x plus a 2/C-sized write, three
// operations an element, so HBM bytes: (8, 512, 512, 64) bf16 is 268 MB +
// 8.4 MB, 0.083 ms at 3.35 TB/s.
//
// Design. The TPU kernel lane-packs C < 128 to fill its 128-lane vregs; here a
// group of L lanes (a power of two <= 32, about one 16-byte load each) owns
// one pixel's C contiguous channels, so a warp reads 32/L whole pixels and
// every load is coalesced. The image's gate sits in shared memory as float32.
// Each lane forms z = dt(x * g) (a bf16 x bf16 product is exact in float32,
// so this is the correctly rounded bf16 product), keeps a float32 sum and a
// NaN-keeping max, and the group folds them with xor shuffles in a fixed
// order. Lane 0 writes the two planes. All threads of a block run the same
// number of pixel steps, so the shuffles always have every lane present.

#include "cbam_common.cuh"

namespace {

using namespace cbam;

constexpr int STEPS = 8;  // pixel steps of a group per block

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
cbam_gated_stats_kernel(const T* __restrict__ x, const T* __restrict__ gate,
                        T* __restrict__ out, int HW, int C, int L) {
  extern __shared__ float g_s[];  // C floats: this image's gate
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += THREADS) g_s[c] = to_float(gate[(size_t)b * C + c]);
  __syncthreads();

  const int G = C / VEC;
  const int lane = threadIdx.x % L;
  const int groups = THREADS / L;
  const int grp = threadIdx.x / L;
  const int px_per_block = groups * STEPS;
  const int p_begin = blockIdx.x * px_per_block;
  const int p_end = min(p_begin + px_per_block, HW);
  for (int base = p_begin; base < p_end; base += groups) {
    const int p = base + grp;
    float s = 0.0f, m = -INFINITY;
    if (p < p_end) {
      const T* px = x + ((size_t)b * HW + p) * C;
      for (int g = lane; g < G; g += L) {
        float v[VEC];
        load_vec<T, VEC>(px + g * VEC, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float z = round_to<T>(v[j] * g_s[g * VEC + j]);
          s += z;
          m = nanmax(m, z);
        }
      }
    }
    for (int off = L / 2; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off, L);
      m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off, L));
    }
    if (p < p_end && lane == 0) {
      out[((size_t)b * 2) * HW + p] = from_float<T>(s / float(C));
      out[((size_t)b * 2 + 1) * HW + p] = from_float<T>(m);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* gate, void* out, int B, int HW, int C, cudaStream_t stream) {
  const int G = C / VEC;
  int L = 1;
  while (L < G && L < 32) L *= 2;
  const int px_per_block = (THREADS / L) * STEPS;
  const size_t smem = size_t(C) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(cbam_gated_stats_kernel<T, VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((HW + px_per_block - 1) / px_per_block, B);
  cbam_gated_stats_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gate), static_cast<T*>(out), HW, C, L);
  return int(cudaGetLastError());
}

}  // namespace

// x (B, HW, C) dt, gate (B, C) dt -> out (B, 2, HW) dt.
extern "C" int coastline_gated_spatial_stats(const void* x, const void* gate, void* out, int B,
                                             int HW, int C, int dtype, int vec, void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  return CBAM_DISPATCH(dtype, vec, launch, x, gate, out, B, HW, C,
                       static_cast<cudaStream_t>(stream));
}
