// Grayscale dilation by a structuring element (SE) whose rows are contiguous.
//
// Replaces the TPU kernel coastline/pallas/morphology.py::dilate_disk:
//   dst(y, x) = max over SE cells (i, j) of src(y + i - ay, x + j - ax),
// anchor (ay, ax) = (size // 2, size // 2), zero outside the image, max
// starting from 0 (as the TPU kernel's accumulator does). It reads and
// writes (N, H, W) uint8 or float32. On the serving path it dilates every
// predicted (8, 512, 512) uint8 mask batch for the coastline band.
//
// The SE arrives as its row groups: every SE row with the same column
// interval [lo, hi] (relative to the anchor) forms one group, listed with the
// vertical shifts s = ay - i of its rows. Then
//   dst(y, x) = max_g max_{s in g} hwin_g(y - s, x),
//   hwin_g(r, x) = max_{u in [lo_g, hi_g]} src(r, x + u).
//
// What bounds it on an H100: moving the mask costs 2 bytes a pixel at uint8,
// ~1.3 us for (8, 512, 512), so the work per pixel (one max per SE row plus
// the horizontal windows) decides its time, not HBM.
//
// Design: the TPU kernel kept whole images (or row/2-D bands) in VMEM; here
// one CTA owns a TH x TW output tile and stages the tile plus its halo (the
// SE's vertical reach above and below, its column reach left and right) in
// shared memory, zero-filled outside the image. That one scheme covers 512^2
// masks, 2048^2 masks and 64 x 10980 strips alike. Each thread owns one output
// column: it builds the horizontal window of every halo row for one group at
// a time and folds that group's vertical shifts into TH accumulators held in
// registers, so no barrier is needed after the tile is loaded. Groups come
// sorted by width; when a group's interval contains the previous one (always,
// for an ellipse) its window extends the previous window by the new columns
// only, so the horizontal work per pixel is the SE width, not its area.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 64;   // output rows per tile
constexpr int TW = 128;  // output columns per tile = threads per CTA

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__global__ void __launch_bounds__(TW)
dilate_kernel(const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ desc,
              int H, int W, int top, int bot, int left, int right) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = TH + top + bot;
  const int cols = TW + left + right;
  T* sin = reinterpret_cast<T*>(smem);
  T* hw = sin + rows * cols;

  const size_t plane = size_t(H) * W;
  const T* src = x + blockIdx.z * plane;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  for (int i = threadIdx.x; i < rows * cols; i += TW) {
    const int gy = y0 - top + i / cols, gx = x0 - left + i % cols;
    sin[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? src[size_t(gy) * W + gx] : T(0);
  }
  __syncthreads();

  const int c = threadIdx.x;
  T acc[TH];
#pragma unroll
  for (int j = 0; j < TH; ++j) acc[j] = T(0);

  const int groups = __ldg(desc);
  int pos = 1, plo = 0, phi = -1;
  for (int g = 0; g < groups; ++g) {
    const int lo = __ldg(desc + pos), hi = __ldg(desc + pos + 1), ns = __ldg(desc + pos + 2);
    const bool extend = g > 0 && lo <= plo && hi >= phi;
    for (int r = 0; r < rows; ++r) {
      const T* row = sin + r * cols + left + c;
      T v;
      if (extend) {
        v = hw[r * TW + c];
        for (int u = lo; u < plo; ++u) v = tmax(v, row[u]);
        for (int u = phi + 1; u <= hi; ++u) v = tmax(v, row[u]);
      } else {
        v = row[lo];
        for (int u = lo + 1; u <= hi; ++u) v = tmax(v, row[u]);
      }
      hw[r * TW + c] = v;  // only this thread reads column c of hw
    }
    for (int k = 0; k < ns; ++k) {
      const T* col = hw + (top - __ldg(desc + pos + 3 + k)) * TW + c;
#pragma unroll
      for (int j = 0; j < TH; ++j) acc[j] = tmax(acc[j], col[j * TW]);
    }
    plo = lo;
    phi = hi;
    pos += 3 + ns;
  }

  const int gx = x0 + c;
  if (gx < W) {
    T* dst = out + blockIdx.z * plane;
#pragma unroll
    for (int j = 0; j < TH; ++j)
      if (y0 + j < H) dst[size_t(y0 + j) * W + gx] = acc[j];
  }
}

template <typename T>
int launch(const void* x, void* out, const void* desc, int N, int H, int W, int top, int bot,
           int left, int right, void* stream) {
  const size_t rows = TH + top + bot, cols = TW + left + right;
  const size_t smem = (rows * cols + rows * TW) * sizeof(T);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  if (smem > size_t(optin)) return int(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(dilate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  dilate_kernel<T><<<grid, TW, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const int*>(desc), H, W, top,
      bot, left, right);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = uint8, 1 = float32. desc: int32 [G, (lo, hi, n, s_0 .. s_{n-1}) x G],
// groups sorted by width. top/bot/left/right: the SE's reach (max s, max -s,
// max -lo, max hi), each >= 0.
extern "C" int coastline_dilate_disk(const void* x, void* out, const void* desc, int dtype, int N,
                                     int H, int W, int top, int bot, int left, int right,
                                     void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (dtype == 0)
    return launch<uint8_t>(x, out, desc, N, H, W, top, bot, left, right, stream);
  if (dtype == 1)
    return launch<float>(x, out, desc, N, H, W, top, bot, left, right, stream);
  return int(cudaErrorInvalidValue);
}
