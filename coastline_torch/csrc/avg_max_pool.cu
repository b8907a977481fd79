// Per-image, per-channel mean and max over H x W of an NHWC activation.
//
// Replaces the TPU kernels coastline/pallas/cbam.py::avg_max_pool and
// coastline/pallas/pools.py::fused_avg_max_pool:
//   (B, H, W, C) -> avg (B, C) = dt(sum_f32(x) / (H * W)), max (B, C),
// in x's dtype dt (bfloat16 or float32). On the Robust U-Net eval path it
// pools the CBAM channel gate's input once per ResidualBlock, 9 a forward.
//
// What bounds it on an H100: one read of x and two operations an element, so
// HBM bytes: (8, 512, 512, 64) bf16 is 268 MB, 0.080 ms at 3.35 TB/s.
//
// Design. The TPU kernel walks H in sequence and carries its sums in VMEM
// scratch from one grid step to the next; Hopper's blocks run in no order, so
// the reduction takes two passes:
//   * pass 1, grid (pixel slices, channel chunks, images): a thread owns VEC
//     consecutive channels (one 16-byte load) and strides over the pixels of
//     its slice, so a warp reads whole pixel rows and every load is
//     coalesced. Sum and max accumulate in float32 registers; the block folds
//     its pixel lanes through shared memory in a fixed order and writes one
//     float32 (sum, max) partial per (image, slice, channel);
//   * pass 2: one thread per (image, channel) folds the slices in order and
//     writes avg and max in dt.
// No float atomics, so the result is the same on every run. The slice count is
// the caller's (it sizes the partial buffers): enough blocks to fill the card.
// Max starts at -inf (the tail's input is post-BN with no ReLU, so whole
// channels can be negative) and keeps NaN, as torch.amax and jnp.max do.

#include "cbam_common.cuh"

namespace {

using namespace cbam;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
cbam_avg_max_partial_kernel(const T* __restrict__ x, float* __restrict__ psum,
                            float* __restrict__ pmax, int HW, int C, int groups_per_block,
                            int px_per_slice) {
  __shared__ float s_sum[THREADS * VEC];
  __shared__ float s_max[THREADS * VEC];
  const int G = C / VEC;
  const int gb = groups_per_block;
  const int lanes = THREADS / gb;  // pixel lanes of the block
  const int tid = threadIdx.x;
  const int gl = tid % gb, lane = tid / gb;
  const int g = blockIdx.y * gb + gl;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * px_per_slice;
  const int p1 = min(p0 + px_per_slice, HW);

  float sum[VEC], mx[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sum[j] = 0.0f;
    mx[j] = -INFINITY;
  }
  if (lane < lanes && g < G) {
    const T* base = x + (size_t)b * HW * C + (size_t)g * VEC;
#pragma unroll 4
    for (int p = p0 + lane; p < p1; p += lanes) {
      float v[VEC];
      load_vec<T, VEC>(base + (size_t)p * C, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sum[j] += v[j];
        mx[j] = nanmax(mx[j], v[j]);
      }
    }
  }
  const int width = gb * VEC;  // channels of this block
  if (lane < lanes) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s_sum[lane * width + gl * VEC + j] = sum[j];
      s_max[lane * width + gl * VEC + j] = mx[j];
    }
  }
  __syncthreads();
  for (int k = tid; k < width; k += THREADS) {
    const int c = blockIdx.y * width + k;
    if (c >= C) continue;
    float s = 0.0f, m = -INFINITY;
    for (int l = 0; l < lanes; ++l) {
      s += s_sum[l * width + k];
      m = nanmax(m, s_max[l * width + k]);
    }
    const size_t o = ((size_t)b * gridDim.x + blockIdx.x) * C + c;
    psum[o] = s;
    pmax[o] = m;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cbam_avg_max_finalize_kernel(const float* __restrict__ psum, const float* __restrict__ pmax,
                             T* __restrict__ avg, T* __restrict__ mx, int B, int HW, int C,
                             int slices) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * C) return;
  const int b = int(i / C), c = int(i % C);
  float s = 0.0f, m = -INFINITY;
  for (int k = 0; k < slices; ++k) {
    const size_t o = ((size_t)b * slices + k) * C + c;
    s += psum[o];
    m = nanmax(m, pmax[o]);
  }
  avg[i] = from_float<T>(s / float(HW));
  mx[i] = from_float<T>(m);
}

template <typename T, int VEC>
int launch(const void* x, void* psum, void* pmax, void* avg, void* mx, int B, int HW, int C,
           int groups_per_block, int slices, int px_per_slice, cudaStream_t stream) {
  const int G = C / VEC;
  const int chunks = (G + groups_per_block - 1) / groups_per_block;
  cbam_avg_max_partial_kernel<T, VEC><<<dim3(slices, chunks, B), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(psum), static_cast<float*>(pmax), HW, C,
      groups_per_block, px_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long n = (long long)B * C;
  cbam_avg_max_finalize_kernel<T><<<unsigned((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const float*>(psum), static_cast<const float*>(pmax), static_cast<T*>(avg),
      static_cast<T*>(mx), B, HW, C, slices);
  return int(cudaGetLastError());
}

}  // namespace

// x (B, HW, C) dt; psum, pmax (B, slices, C) float32 scratch; avg, mx (B, C) dt.
// groups_per_block channel groups of `vec` channels each per block (<= 256,
// dividing the block's 256 threads into pixel lanes); px_per_slice pixels per
// slice, slices * px_per_slice >= HW.
extern "C" int coastline_avg_max_pool(const void* x, void* psum, void* pmax, void* avg, void* mx,
                                      int B, int HW, int C, int dtype, int vec,
                                      int groups_per_block, int slices, int px_per_slice,
                                      void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || groups_per_block <= 0 || groups_per_block > cbam::THREADS ||
      slices <= 0 || slices > 65535 || (long long)slices * px_per_slice < HW)
    return int(cudaErrorInvalidValue);
  return CBAM_DISPATCH(dtype, vec, launch, x, psum, pmax, avg, mx, B, HW, C, groups_per_block,
                       slices, px_per_slice, static_cast<cudaStream_t>(stream));
}
