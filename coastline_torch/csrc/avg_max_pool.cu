// Per-image, per-channel mean and max over H x W of an NHWC activation.
//
// Replaces the TPU kernels coastline/pallas/cbam.py::avg_max_pool and
// coastline/pallas/pools.py::fused_avg_max_pool:
//   (B, H, W, C) -> avg (B, C) = dt(sum_f32(x) / (H * W)), max (B, C),
// in x's dtype dt (bfloat16 or float32), written as one (2, B, C) tensor. On
// the Robust U-Net eval path it pools the CBAM channel gate's input once per
// ResidualBlock, 9 a forward; WaterNet pools its bottleneck once.
//
// What bounds it on an H100: one read of x and two operations an element, so
// HBM bytes: (8, 512, 512, 64) bf16 is 268 MB, 0.080 ms at 3.35 TB/s;
// (8, 32, 32, 1024) is 16.8 MB, 0.005 ms, where a launch, a second pass or a
// serial fold is as long as the read.
//
// Design: one launch. The TPU kernel walks H in sequence and carries its sums
// in VMEM from one grid step to the next; Hopper's blocks run in no order, so
// the pixels of an (image, channel chunk) are split over a thread block
// cluster of `cluster` CTAs, and the CTAs fold their partials through
// distributed shared memory, with no global scratch and no second kernel:
//   * a chunk is `gw` channel groups of VEC channels (one 16-byte load each;
//     a whole 128-byte line of a pixel on the 16-byte path); a CTA's threads
//     are gw groups x (threads / gw) pixel lanes, so a warp reads whole lines
//     of consecutive pixels. CTA `rank` of the cluster streams pixels
//     [rank * px, (rank + 1) * px); each thread issues UNROLL independent
//     loads before it adds them, which keeps 32 KB a CTA in flight;
//   * sum and max accumulate in float32 registers, each thread over its
//     pixels in order; the lanes of a warp fold by a fixed shuffle tree, the
//     warps through shared memory in warp order, into one partial per
//     channel of the CTA;
//   * after cluster.sync() rank r folds the chunk's channels
//     [r * share, (r + 1) * share) over the cluster's CTAs in rank order,
//     reading their partials through map_shared_rank, and writes avg and max;
//     a second cluster.sync() keeps every CTA's shared memory alive until
//     then.
// Every fold is in a fixed order and there are no atomics, so two calls give
// the same bits. The geometry (gw, cluster, px, threads) is the caller's,
// chosen per shape and SM count to fill the card
// (coastline_torch/kernels/cbam.py::pool_geometry); clusters above 8 CTAs
// take the non-portable cluster size, which the H100 allows up to 16.
// Max starts at -inf (the tail's input is post-BN with no ReLU, so whole
// channels can be negative) and keeps NaN, as torch.amax and jnp.max do.
//
// Partials mode (`partials` = 1): out is a float32 (2, B, C) of the sums,
// undivided, and the maxima, unrounded. A rank that holds some rows of the
// image (the mesh's space axis) writes these; the ranks' sums are added and
// divided by the whole image's area in float32, so a bf16 mean rounds once,
// as in one process.

#include <cooperative_groups.h>

#include <type_traits>

#include "cbam_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cbam;

constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 16;
constexpr int UNROLL = 8;

// one load of VEC channels: a uint4 on the 16-byte path, else one element
template <typename T, int VEC>
using Raw = std::conditional_t<VEC * sizeof(T) == 16, uint4, T>;

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* __restrict__ p) {
  if constexpr (VEC * sizeof(T) == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return *p;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const Raw<T, VEC>& r, float (&sum)[VEC],
                                           float (&mx)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float v = to_float(e[j]);
    sum[j] += v;
    mx[j] = nanmax(mx[j], v);
  }
}

// grid: one cluster of `cluster` CTAs per (image, chunk), cluster index
// b * chunks + chunk; dynamic shared memory as `smem_bytes` below
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
cbam_avg_max_kernel(const T* __restrict__ x, void* __restrict__ out, int B, int HW, int C, int gw,
                    int px, int partials) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int G = C / VEC;
  const int chunks = (G + gw - 1) / gw;
  const int cid = blockIdx.x / K;
  const int b = cid / chunks, chunk = cid % chunks;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int gl = tid % gw, lane = tid / gw, lanes = nthreads / gw;
  const int g = chunk * gw + gl;
  const int p0 = rank * px, p1 = min(p0 + px, HW);

  float sum[VEC], mx[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sum[j] = 0.0f;
    mx[j] = -INFINITY;
  }
  if (g < G) {
    const T* base = x + (size_t)b * HW * C + (size_t)g * VEC;
    int p = p0 + lane;
    for (; p + (UNROLL - 1) * lanes < p1; p += UNROLL * lanes) {
      Raw<T, VEC> r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) r[u] = load_raw<T, VEC>(base + (size_t)(p + u * lanes) * C);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) accumulate<T, VEC>(r[u], sum, mx);
    }
    for (; p < p1; p += lanes) accumulate<T, VEC>(load_raw<T, VEC>(base + (size_t)p * C), sum, mx);
  }

  // the CTA's fold: warp lanes of one group by a shuffle tree, then the rows
  // (warps, or pixel lanes when a group spans warps) in order
  const int width = gw * VEC;  // channels of the chunk
  const int span = max(gw, 32);
  const int rows = nthreads / span;
  float* red_sum = smem;
  float* red_max = red_sum + rows * width;
  float* part_sum = red_max + rows * width;
  float* part_max = part_sum + width;
  for (int off = 16; off >= gw; off >>= 1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sum[j] += __shfl_down_sync(0xffffffffu, sum[j], off);
      mx[j] = nanmax(mx[j], __shfl_down_sync(0xffffffffu, mx[j], off));
    }
  }
  if ((tid & 31) < gw) {
    const int o = (tid / span) * width + gl * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red_sum[o + j] = sum[j];
      red_max[o + j] = mx[j];
    }
  }
  __syncthreads();
  for (int k = tid; k < width; k += nthreads) {
    float s = 0.0f, m = -INFINITY;
    for (int r = 0; r < rows; ++r) {
      s += red_sum[r * width + k];
      m = nanmax(m, red_max[r * width + k]);
    }
    part_sum[k] = s;
    part_max[k] = m;
  }

  // the cluster's fold: this rank's share of the chunk's channels over the
  // CTAs' partials in rank order, through distributed shared memory
  cluster.sync();
  const int share = (width + K - 1) / K;
  for (int i = tid; i < share; i += nthreads) {
    const int k = rank * share + i;
    const int c = chunk * width + k;
    if (k >= width || c >= C) continue;
    float vs[MAX_CLUSTER], vm[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < K) {
        vs[r] = cluster.map_shared_rank(part_sum, r)[k];
        vm[r] = cluster.map_shared_rank(part_max, r)[k];
      }
    }
    float s = 0.0f, m = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < K) {
        s += vs[r];
        m = nanmax(m, vm[r]);
      }
    }
    if (partials) {
      float* o = static_cast<float*>(out);
      o[(size_t)b * C + c] = s;
      o[(size_t)(B + b) * C + c] = m;
    } else {
      T* o = static_cast<T*>(out);
      o[(size_t)b * C + c] = from_float<T>(s / float(HW));
      o[(size_t)(B + b) * C + c] = from_float<T>(m);
    }
  }
  cluster.sync();
}

size_t smem_bytes(int gw, int vec, int threads) {
  const int width = gw * vec, rows = threads / (gw > 32 ? gw : 32);
  return size_t(2 * rows * width + 2 * width) * sizeof(float);
}

template <typename T, int VEC>
int launch(const void* x, void* out, int B, int HW, int C, int gw, int cluster, int px,
           int threads, int partials, cudaStream_t stream) {
  auto kernel = cbam_avg_max_kernel<T, VEC>;
  if (cluster > 8) {  // once a device: the H100 schedules clusters of up to 16 CTAs
    static unsigned long long allowed = 0;  // bit d: set on device d
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return int(err);
    if (dev >= 64) return int(cudaErrorInvalidDevice);
    if (!((allowed >> dev) & 1ull)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return int(err);
      allowed |= 1ull << dev;
    }
  }
  const long long G = C / VEC;
  const long long ctas = (long long)B * ((G + gw - 1) / gw) * cluster;
  if (ctas > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(ctas));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes(gw, VEC, threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), out, B, HW, C, gw,
                                       px, partials);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

namespace {

int entry(const void* x, void* out, int B, int HW, int C, int dtype, int vec, int gw, int cluster,
          int px, int threads, int partials, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || gw <= 0 || (gw & (gw - 1)) != 0 || threads <= 0 ||
      threads > MAX_THREADS || threads % 32 != 0 || threads % gw != 0 || cluster < 1 ||
      cluster > MAX_CLUSTER || px <= 0 || (long long)cluster * px < HW ||
      (vec != 1 && C % vec != 0) || smem_bytes(gw, vec, threads) > 48 * 1024)
    return int(cudaErrorInvalidValue);
  return CBAM_DISPATCH(dtype, vec, launch, x, out, B, HW, C, gw, cluster, px, threads, partials,
                       static_cast<cudaStream_t>(stream));
}

}  // namespace

// x (B, HW, C) dt; out (2, B, C) dt: [avg, max]. Geometry: gw channel groups
// of `vec` channels a chunk (a power of two dividing `threads`), `cluster`
// CTAs (1..16) per (image, chunk), `px` pixels a CTA (cluster * px >= HW),
// `threads` a CTA (a multiple of 32, at most 512).
extern "C" int coastline_avg_max_pool(const void* x, void* out, int B, int HW, int C, int dtype,
                                      int vec, int gw, int cluster, int px, int threads,
                                      void* stream) {
  return entry(x, out, B, HW, C, dtype, vec, gw, cluster, px, threads, 0, stream);
}

// The same in partials mode: out (2, B, C) float32 [sum, max].
extern "C" int coastline_avg_max_pool_partials(const void* x, void* out, int B, int HW, int C,
                                               int dtype, int vec, int gw, int cluster, int px,
                                               int threads, void* stream) {
  return entry(x, out, B, HW, C, dtype, vec, gw, cluster, px, threads, 1, stream);
}
