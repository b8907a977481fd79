// CBAM attention tail: spatial gate and residual ReLU in one pass.
//
// Replaces the XLA tail that coastline/pallas/cbam.py::fused_cbam_tail runs
// after its two kernels (the 7x7 conv on the stats map, its sigmoid, and
// relu(y * gate * att + shortcut)):
//   att = dt(sigmoid(dt(conv7x7_pad3(stats, w))))                  (B, H, W)
//   out = relu(dt(dt(dt(y * gate) * att) + shortcut))              (B, H, W, C)
// with y, shortcut NHWC, gate (B, C), stats (B, 2, H, W) from
// gated_spatial_stats, w (2, 7, 7) already rounded to dt; dt is bfloat16 or
// float32 and every op rounds to it, as the module path does. On the Robust
// U-Net eval path it ends every ResidualBlock, 9 a forward.
//
// What bounds it on an H100: it reads y and shortcut and writes out (3 bytes
// of dt per element, 98 multiply-adds a pixel), so HBM bytes: (8, 512, 512, 64)
// bf16 reads 268 + 268 + 8 MB and writes 268 MB, 0.243 ms at 3.35 TB/s.
//
// Design. A block owns a TH x TW pixel tile (TW = min(W, 32), TH * TW <= 256)
// and a chunk of up to 64 channels (grid.y), so the deep levels (1024
// channels at 32 x 32) still fill the card. It stages the two stats planes
// with a 3-pixel zero halo (the conv's zero padding), the 98 weights and its
// gate chunk in shared memory, computes one attention value per tile pixel
// (float32 sum of the taps), then streams the tile's channels of y and
// shortcut with 16-byte loads, consecutive threads on consecutive channels
// and pixels, and writes the result with 16-byte stores. The attention map is
// never written to device memory; each channel chunk recomputes its tile's 98
// taps a pixel, which is cheap beside the channel traffic.
//
// Halo. A rank that holds some rows of the image (the mesh's space axis)
// passes stats with `halo` (0..3) extra rows above and below its H rows: the
// neighbouring ranks' rows, or zeros outside the image. The kernel reads
// stats row gy + halo for output row gy, and takes zeros only beyond them,
// so y, gate and shortcut are never exchanged.

#include "cbam_common.cuh"

namespace {

using namespace cbam;

constexpr int K = 7, PAD = 3;
constexpr int CCH = 64;  // channels of a block
// largest (TH + 6) * (TW + 6) over TW <= 32, TH = 256 / TW: at TW = 1
constexpr int HALO_MAX = (THREADS + 2 * PAD) * (1 + 2 * PAD);

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
cbam_tail_kernel(const T* __restrict__ y, const T* __restrict__ sc, const T* __restrict__ gate,
                 const T* __restrict__ stats, const float* __restrict__ w, T* __restrict__ out,
                 int H, int W, int C, int TH, int TW, int halo) {
  __shared__ float st_s[2 * HALO_MAX];
  __shared__ float w_s[2 * K * K];
  __shared__ float att_s[THREADS];
  __shared__ float g_s[CCH];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int c0 = blockIdx.y * CCH;
  const int cn = min(CCH, C - c0);
  const int HH = TH + 2 * PAD, WW = TW + 2 * PAD;

  const int SH = H + 2 * halo;  // rows of the stats planes
  for (int i = tid; i < 2 * HH * WW; i += THREADS) {
    const int plane = i / (HH * WW), r = i % (HH * WW);
    const int sy = y0 - PAD + r / WW + halo, gx = x0 - PAD + r % WW;
    st_s[i] = (sy >= 0 && sy < SH && gx >= 0 && gx < W)
                  ? to_float(stats[(((size_t)b * 2 + plane) * SH + sy) * W + gx])
                  : 0.0f;
  }
  if (tid < 2 * K * K) w_s[tid] = w[tid];
  if (tid < cn) g_s[tid] = to_float(gate[(size_t)b * C + c0 + tid]);
  __syncthreads();

  if (tid < TH * TW) {
    const int py = tid / TW, px = tid % TW;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int ky = 0; ky < K; ++ky)
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
          acc += st_s[i * HH * WW + (py + ky) * WW + px + kx] * w_s[(i * K + ky) * K + kx];
    att_s[tid] = round_to<T>(1.0f / (1.0f + expf(-round_to<T>(acc))));
  }
  __syncthreads();

  const int GC = cn / VEC;
  const int total = TH * TW * GC;
#pragma unroll 4
  for (int idx = tid; idx < total; idx += THREADS) {
    const int p = idx / GC, g = idx % GC;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if (gy >= H || gx >= W) continue;
    const size_t off = (((size_t)b * H + gy) * W + gx) * C + c0 + g * VEC;
    float yv[VEC], sv[VEC];
    load_vec<T, VEC>(y + off, yv);
    load_vec<T, VEC>(sc + off, sv);
    const float a = att_s[p];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float z = round_to<T>(round_to<T>(yv[j] * g_s[g * VEC + j]) * a);
      yv[j] = relu_keep_nan(round_to<T>(z + sv[j]));
    }
    store_vec<T, VEC>(out + off, yv);
  }
}

template <typename T, int VEC>
int launch(const void* y, const void* sc, const void* gate, const void* stats, const void* w,
           void* out, int B, int H, int W, int C, int halo, cudaStream_t stream) {
  const int TW = W < 32 ? W : 32;
  const int TH = H < THREADS / TW ? H : THREADS / TW;
  const long long tiles = (long long)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(tiles), (C + CCH - 1) / CCH, B);
  cbam_tail_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(sc), static_cast<const T*>(gate),
      static_cast<const T*>(stats), static_cast<const float*>(w), static_cast<T*>(out), H, W, C,
      TH, TW, halo);
  return int(cudaGetLastError());
}

}  // namespace

// y, shortcut, out (B, H, W, C) dt; gate (B, C) dt; stats (B, 2, H + 2 halo, W)
// dt; w (2, 7, 7) float32 (the conv weight [in][ky][kx], values already rounded
// to dt); halo 0..3.
extern "C" int coastline_cbam_tail(const void* y, const void* shortcut, const void* gate,
                                   const void* stats, const void* w, void* out, int B, int H,
                                   int W, int C, int halo, int dtype, int vec, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || (C + CCH - 1) / CCH > 65535 ||
      halo < 0 || halo > PAD)
    return int(cudaErrorInvalidValue);
  return CBAM_DISPATCH(dtype, vec, launch, y, shortcut, gate, stats, w, out, B, H, W, C, halo,
                       static_cast<cudaStream_t>(stream));
}
