// Fused 3x3 conv + folded BatchNorm + optional ReLU for NHWC bf16, C_in = C_out = 64.
//
// Replaces the TPU kernel coastline/pallas/fused_conv.py::fused_conv3x3_bn_relu:
//   out = relu(conv3x3_same(x, w) * scale + bias), f32 accumulation, bf16 out.
// On the UNet serving path it runs the two full-resolution 64->64 layers
// (enc1 conv 2, dec1 conv 2), (8, 512, 512, 64) at batch 8.
//
// What bounds it on an H100: at that shape the layer does 154.6 GFLOP over
// 537 MB of input + output, so the bf16 tensor-core roof (~0.156 ms) and the
// HBM roof (~0.160 ms) are nearly equal. This first version is neither: it is
// a simple, correct kernel built from warp-level wmma (mma.sync) tiles.
//
// Design:
//   * persistent CTAs (as many as fit, ~2 per SM); each loads the 576x64 bf16
//     weight matrix into shared memory ONCE (row stride 72 elements, so the
//     wmma row loads spread over the banks), then walks output tiles;
//   * a tile is TH x TW = 2 x 32 output pixels x all 64 channels; its
//     (TH+2) x (TW+2) input halo is staged in shared memory with 16-byte
//     loads, zero-filled outside the image (the conv's zero padding);
//     the pixel stride is 80 elements (160 B) so every wmma row pointer keeps
//     the 32-byte alignment wmma requires;
//   * 4 warps; each owns 16 consecutive output pixels of one row and all 64
//     output channels (4 accumulator fragments); the K = 9 taps x 64 channels
//     contraction is 36 steps of 16, A read straight from the halo (a tap is
//     a pointer offset: no im2col buffer), B from the weight matrix;
//   * epilogue: fragments are staged as f32 in the (then idle) halo buffer,
//     each lane applies scale/bias/ReLU to 8 channels and writes them as one
//     16-byte bf16 store; a warp writes whole 128-byte pixel rows.
// Not yet used: wgmma, TMA, clusters, double-buffered halos.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int C = 64;
constexpr int K = 9 * C;
constexpr int TH = 2;
constexpr int TW = 32;
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int A_LD = 80;  // halo pixel stride, elements
constexpr int B_LD = 72;  // weight row stride, elements
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int W_ELEMS = K * B_LD;
constexpr int X_ELEMS = HALO_H * HALO_W * A_LD;
constexpr size_t SMEM_BYTES = size_t(W_ELEMS + X_ELEMS) * sizeof(__nv_bfloat16);

static_assert(WARPS == (TH * TW) / 16, "one warp per 16 output pixels");
static_assert(WARPS * 16 * C * sizeof(float) <= X_ELEMS * sizeof(__nv_bfloat16),
              "epilogue staging must fit in the halo buffer");
static_assert((W_ELEMS * sizeof(__nv_bfloat16)) % 128 == 0, "halo buffer alignment");

// two floats -> two round-to-nearest bf16 in one 32-bit word, lower channel first
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__global__ void __launch_bounds__(THREADS)
fused_conv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int B, int H, int W, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = ws + W_ELEMS;
  float* stage = reinterpret_cast<float*>(xs);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < K * (C / 8); i += THREADS) {
    const int k = i / (C / 8), v = i % (C / 8);
    *reinterpret_cast<uint4*>(ws + k * B_LD + v * 8) =
        __ldg(reinterpret_cast<const uint4*>(w + size_t(k) * C + v * 8));
  }

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const long long n_tiles = (long long)B * tiles_y * tiles_x;
  const int wr = warp / (TW / 16);         // output row of this warp in the tile
  const int wc = (warp % (TW / 16)) * 16;  // first output column of this warp

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int tx = int(t % tiles_x);
    const int ty = int((t / tiles_x) % tiles_y);
    const int b = int(t / ((long long)tiles_x * tiles_y));
    const int y0 = ty * TH, x0 = tx * TW;

    __syncthreads();  // the previous tile's epilogue is done with the staging area
    for (int i = tid; i < HALO_H * HALO_W * (C / 8); i += THREADS) {
      const int p = i / (C / 8), v = i % (C / 8);
      const int gy = y0 - 1 + p / HALO_W, gx = x0 - 1 + p % HALO_W;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        val = __ldg(reinterpret_cast<const uint4*>(
            x + ((size_t(b) * H + gy) * W + gx) * C + v * 8));
      *reinterpret_cast<uint4*>(xs + p * A_LD + v * 8) = val;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C / 16];
#pragma unroll
    for (int n = 0; n < C / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const __nv_bfloat16* a_base = xs + ((wr + dy) * HALO_W + wc + dx) * A_LD;
      const __nv_bfloat16* b_base = ws + tap * C * B_LD;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a_base + kc * 16, A_LD);
#pragma unroll
        for (int n = 0; n < C / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
          wmma::load_matrix_sync(bm, b_base + kc * 16 * B_LD + n * 16, B_LD);
          wmma::mma_sync(acc[n], a, bm, acc[n]);
        }
      }
    }

    __syncthreads();  // every warp has finished reading the halo
    float* st = stage + warp * 16 * C;
#pragma unroll
    for (int n = 0; n < C / 16; ++n)
      wmma::store_matrix_sync(st + n * 16, acc[n], C, wmma::mem_row_major);
    __syncwarp();

    const int oy = y0 + wr;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int px = it * 4 + lane / 8;
      const int c0 = (lane % 8) * 8;
      const int ox = x0 + wc + px;
      if (oy < H && ox < W) {
        const float4 v0 = *reinterpret_cast<const float4*>(st + px * C + c0);
        const float4 v1 = *reinterpret_cast<const float4*>(st + px * C + c0 + 4);
        float f[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          f[j] = f[j] * __ldg(scale + c0 + j) + __ldg(bias + c0 + j);
          if (relu) f[j] = fmaxf(f[j], 0.0f);
        }
        *reinterpret_cast<uint4*>(out + ((size_t(b) * H + oy) * W + ox) * C + c0) =
            make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                       pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
      }
    }
  }
}

}  // namespace

extern "C" int coastline_fused_conv3x3_bn_relu(const void* x, const void* w, const void* scale,
                                               const void* bias, void* out, int B, int H, int W,
                                               int relu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_conv_kernel, THREADS,
                                                           SMEM_BYTES)) != cudaSuccess)
    return int(err);
  const long long n_tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return 0;
  fused_conv_kernel<<<int(grid), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), B, H, W, relu);
  return int(cudaGetLastError());
}
