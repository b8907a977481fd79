// Fused 3x3 conv + folded BatchNorm + optional ReLU for NHWC bf16, C_in = C_out = 64.
//
// Replaces the TPU kernel coastline/pallas/fused_conv.py::fused_conv3x3_bn_relu:
//   out = act(conv3x3_same(x, w) * scale + bias), f32 accumulation, bf16 out.
// It runs the full-resolution 64->64 layers of the three ported models, e.g.
// (8, 512, 512, 64) at batch 8 (UNet enc1/dec1 conv 2 with ReLU, SegNet enc1
// conv 2 and dec1 conv 0 with ReLU, Robust U-Net ResidualBlock_0/_8 conv 2
// without).
//
// What bounds it on an H100: at that shape the layer does 154.6 GFLOP over
// 537 MB of input + output, so the bf16 tensor-core roof (~0.156 ms) and the
// HBM roof (~0.160 ms) are nearly equal: it nears its bound only if loads,
// tensor-core work and stores overlap.
//
// Design (Hopper: TMA, mbarrier, wgmma):
//   * persistent CTAs, one per SM, each walking output tiles of TH x TW =
//     4 x 64 pixels x all 64 channels; the 576 x 64 weight matrix (72 KB) is
//     loaded once per CTA into shared memory in the 128-byte-swizzled K-major
//     layout a wgmma B descriptor reads (the wrapper repacks w to (3, 3, O, I)
//     so each tap's rows are output channels with 64 contiguous inputs);
//   * one producer thread (its warpgroup gives its registers to the
//     consumers with setmaxnreg) loads each tile's (TH+2) x (TW+2) x 64
//     input halo with one 4-D TMA box (C, W, H, B), requested at (0, x0-1,
//     y0-1, b): TMA zero-fills what lies outside the tensor, which is the
//     conv's zero padding and the ragged right and bottom edges. A pixel's 64
//     channels are one 128-byte swizzle row. Two stages on full/empty
//     mbarriers, so the next tile's load overlaps this tile's products;
//   * two consumer warpgroups, two output rows each. A row is one
//     wgmma.mma_async m64n64k16 (M = 64 pixels, N = 64 output channels) per
//     16-channel step of each tap, K = 9 x 64 = 576 in 36 steps, accumulated
//     in registers (32 f32 a thread a row). A tap shifted by dx = 1 or 2
//     pixels starts inside a 1 KB swizzle atom, which an SS descriptor cannot
//     address, so A comes from registers (the RS form): ldmatrix.x4 from the
//     swizzled halo, chunk k of halo pixel p at p*128 + ((k ^ (p & 7)) * 16).
//     A fragments rotate through four buffers by K step, so the loads of
//     step k+1 overlap the products of steps k-2 .. k;
//   * epilogue in registers: acc * scale + bias, optional ReLU, one bf16
//     rounding, written swizzled to a staging tile and stored by one TMA
//     store, which clips rows and columns beyond the image.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;
constexpr int TW = 64;                  // output pixels a tile row: wgmma M
constexpr int TH = 4;                   // output rows a tile
constexpr int CONSUMERS = 2;            // consumer warpgroups
constexpr int RPW = TH / CONSUMERS;     // output rows a consumer warpgroup
constexpr int STAGES = 2;
constexpr int HALO_W = TW + 2, HALO_H = TH + 2;
constexpr int PIX = C * 2;              // bytes a pixel: one 128-byte swizzle row
constexpr int HALO_BYTES = HALO_W * HALO_H * PIX;            // one TMA box, 50,688
constexpr int STAGE_BYTES = (HALO_BYTES + 1023) / 1024 * 1024;
constexpr int TAP_BYTES = C * PIX;                           // 8 KB of weights a tap
constexpr int W_BYTES = 9 * TAP_BYTES;                       // 72 KB
constexpr int OUT_BYTES = RPW * TW * PIX;                    // staging a consumer
constexpr int THREADS = (CONSUMERS + 1) * 128;               // + one producer warpgroup
constexpr int A_BUFS = 4;  // A fragment buffers: K steps whose products may be in flight
constexpr int SMEM_BYTES = 1024 + W_BYTES + STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES +
                           2 * C * 4 + 16 * STAGES;  // + alignment slack, scale and bias, barriers

static_assert(TH % CONSUMERS == 0, "whole rows a warpgroup");
static_assert(SMEM_BYTES <= 232448, "fits one SM's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// wgmma B descriptor: K-major, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 64 f32, this thread's 32) += A (64 x 16 bf16, registers) * B (16 x 64, descriptor)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));  // scale-d: accumulate
}

// two floats -> two round-to-nearest bf16 in one 32-bit word, lower channel first
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap omap,
                  const __nv_bfloat16* __restrict__ wpk, const float* __restrict__ scale,
                  const float* __restrict__ bias, int B, int H, int W, int relu) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t w_s = (raw + 1023) & ~1023u;  // TMA and wgmma swizzle want 1024-byte atoms
  const uint32_t x_s = w_s + W_BYTES;
  const uint32_t o_s = x_s + STAGES * STAGE_BYTES;
  const uint32_t sb_s = o_s + CONSUMERS * OUT_BYTES;  // scale[64], then bias[64]
  const uint32_t full = sb_s + 2 * C * 4, empty = full + 8 * STAGES;
  const int tid = threadIdx.x;
  // the role of this thread's warpgroup, read through a shuffle so the
  // compiler knows it is warp-uniform and keeps the wgmma path convergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  // weights: row R = tap * 64 + output channel, 16-byte chunk c of its 64 inputs
  for (int i = tid; i < 9 * C * 8; i += THREADS) {
    const int R = i >> 3, c = i & 7;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(wpk) + i);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(w_s + R * PIX +
                                                                   ((c ^ (R & 7)) << 4)),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
  if (tid < 2 * C) {
    const float v = tid < C ? __ldg(scale + tid) : __ldg(bias + tid - C);
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(sb_s + tid * 4), "f"(v) : "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // weights -> wgmma's proxy
  __syncthreads();

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long n_tiles = (long long)B * tiles_y * tiles_x;

  if (wg == CONSUMERS) {  // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == CONSUMERS * 128) {
      int it = 0;
      for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // a fresh ring passes at once
        mbar_arrive_expect_tx(full + 8 * s, HALO_BYTES);    // OOB zeros count too
        const int tx = int(t % tiles_x), ty = int((t / tiles_x) % tiles_y);
        const int b = int(t / ((long long)tiles_x * tiles_y));
        tma_load(x_s + s * STAGE_BYTES, &xmap, full + 8 * s, 0, tx * TW - 1, ty * TH - 1, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int ltid = tid % 128, warp = ltid / 32, lane = tid % 32;
  // ldmatrix.x4 row and 8-channel half that this lane addresses
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;
  const uint32_t stage_out = o_s + wg * OUT_BYTES;

  int it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = it % STAGES;
    const int tx = int(t % tiles_x), ty = int((t / tiles_x) % tiles_y);
    const int b = int(t / ((long long)tiles_x * tiles_y));
    const uint32_t xs = x_s + s * STAGE_BYTES;

    float acc[RPW][32];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[r][j] = 0.0f;
    uint32_t a[A_BUFS][RPW][4];

    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    // 36 steps of K = 16: tap = step / 4, input channels 16 * (step % 4) ...
#pragma unroll
    for (int step = 0; step < 36; ++step) {
      const int tap = step / 4, kk = step % 4, dy = tap / 3, dx = tap % 3;
      if (step >= A_BUFS) wgmma_wait<A_BUFS - 1>();  // step - A_BUFS is done with this buffer
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int p = (wg * RPW + r + dy) * HALO_W + a_row + dx;  // halo pixel
        ldmatrix_x4(xs + p * PIX + (((kk * 2 + a_half) ^ (p & 7)) << 4), a[step % A_BUFS][r]);
      }
      if (step == 35) mbar_arrive(empty + 8 * s);  // the halo is in registers: hand it back
      wgmma_fence();
      const uint64_t desc = b_desc(w_s + tap * TAP_BYTES + kk * 32);
#pragma unroll
      for (int r = 0; r < RPW; ++r) wgmma_rs(acc[r], a[step % A_BUFS][r], desc);
      wgmma_commit();
    }
    wgmma_wait<0>();

    // epilogue: the previous tile's TMA store must have read the staging tile
    if (ltid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // channels i * 8 + (lane & 3) * 2 + {0, 1} of staged pixel p
          const int p = r * TW + warp * 16 + (lane >> 2) + h * 8;
          float2 sc, bi;
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                       : "=f"(sc.x), "=f"(sc.y) : "r"(sb_s + (i * 8 + (lane & 3) * 2) * 4));
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                       : "=f"(bi.x), "=f"(bi.y) : "r"(sb_s + (C + i * 8 + (lane & 3) * 2) * 4));
          float y0 = acc[r][4 * i + 2 * h] * sc.x + bi.x;
          float y1 = acc[r][4 * i + 2 * h + 1] * sc.y + bi.y;
          if (relu) {
            y0 = fmaxf(y0, 0.0f);
            y1 = fmaxf(y1, 0.0f);
          }
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(stage_out + p * PIX +
                                                       ((i ^ (p & 7)) << 4) + (lane & 3) * 4),
                       "r"(pack_bf16x2(y0, y1))
                       : "memory");
        }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // staging -> TMA's proxy
    named_barrier(1 + wg, 128);
    const int oy = ty * TH + wg * RPW;
    if (ltid == 0 && oy < H) tma_store(&omap, stage_out, 0, tx * TW, oy, b);
  }
  if (ltid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; looking it up through the
// runtime (cudaGetDriverEntryPointByVersion) spares the library -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map (C, W, H, B) over an NHWC bf16 tensor, box C x box_w x box_h x 1,
// 128-byte swizzle (one pixel's 64 channels are one swizzle row), zero fill
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int H, int W,
              int box_w, int box_h) {
  const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(PIX), cuuint64_t(W) * PIX,
                                 cuuint64_t(H) * cuuint64_t(W) * PIX};
  const cuuint32_t box[4] = {cuuint32_t(C), cuuint32_t(box_w), cuuint32_t(box_h), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x, out: contiguous NHWC bf16 (B, H, W, 64), 16-byte aligned; w: the (3, 3, 64 out,
// 64 in) bf16 repack of the HWIO weights; scale, bias: float32 (64,).
extern "C" int coastline_fused_conv3x3_bn_relu(const void* x, const void* w, const void* scale,
                                               const void* bias, void* out, int B, int H, int W,
                                               int relu, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorSymbolNotFound);
  CUtensorMap xmap, omap;
  if (!make_map(encode, &xmap, x, B, H, W, HALO_W, HALO_H) ||
      !make_map(encode, &omap, out, B, H, W, TW, RPW))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  const long long n_tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int grid = int(n_tiles < sms ? n_tiles : sms);
  fused_conv_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xmap, omap, static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), B, H, W, relu);
  return int(cudaGetLastError());
}
