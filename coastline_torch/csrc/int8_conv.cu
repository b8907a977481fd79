// Int8 convolution with a fused epilogue for the PTQ serving path: dequantize,
// bias, an optional ReLU or leaky ReLU and, in codes mode, the next site's int8
// quantization.
//
// No Pallas counterpart: the JAX package runs these convs as XLA s8 x s8 -> s32
// convolutions with the epilogue and the site's quantization fused by XLA
// (coastline/infer/quant.py:573-578, the int8 branch of `_conv`, and `_Ctx.site`
// at :546-548). It computes, at stride s (1, 2 or 4), NHWC:
//   acc[n, oy, ox, co] = sum over (ky, kx, ci) of
//       x[n, s * oy - pad_t + ky * dil, s * ox - pad_l + kx * dil, ci]
//       * w[co][(ky * KW + kx) * Cin + ci]
//   v = cast(RN(RN(float(acc) * RN(x_step * w_step[co])) + bias[co])), then the activation:
//       relu: max(v, 0); leaky: v >= 0 ? v : cast(v * cast(0.1)), jax.nn.leaky_relu(v, 0.1)
//       in the output dtype (in bf16 the product of two bf16 values is exact in float,
//       so one RN to bf16 is JAX's bf16 multiply)
//   values mode: out = v (float32 or bf16)
//   codes mode:  out = int8(clamp(rint(float(v) / out_step), -127, 127))
//                (the float division's result, found without a division: `quantize`)
// with x int8, w int8 packed K-major (kernels/int8_conv.py::pack_weights), acc
// int32 (exact), x_step and out_step floats, w_step and bias float per output
// channel. Each float op is an explicit round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn) so that nvcc cannot contract them into an FMA; a bf16 cast rounds
// once (RN) and codes mode divides that bf16 value widened, with the result of
// a true float division (never the float product with a reciprocal); rint
// rounds half to even. The kernel is then bit-equal to its plain version and
// to `_Ctx.site(act(conv))`.
//
// A transposed conv (lhs dilation 2, a k x k kernel, padding (lo, k - lo), lo =
// k / 2 rounded down: the UNets' 2x2 decoders, DeepLabV3+'s and YOLO-SEG's 4x4
// ones, ENet's 3x3 with output padding, pads (1, 2)) runs as its four
// output-parity sub-problems. Output row 2a + p sums the stored (flipped) taps t
// with p + t - lo even, over input rows a + (p + t - lo) / 2: taps t0 + 2j, t0 =
// (lo - p) mod 2, at rows a - ((lo - p) >> 1) + j, j < n = (k + 1) / 2, a dense
// n x n conv over the input grid with leading padding (lo - p) >> 1
// (pack_weights gathers its taps, and pads a 3x3's parity 0 with zero taps to
// 2x2), written at output stride 2 (the sub-problem is part of the tile index).
// For k = 2 that is a 1x1 GEMM with tap 1 - p; for k = 4 a 2x2 conv, padded by
// one row and column at parity 0; for k = 3 a 2x2 conv over rows a and a + 1
// (9 of its 16 tap products are not zero; TMA zero-fills row H). Only the 3x3
// multiplies zeros, and fewer than a tap loop over the zero-inserted input
// would.
//
// Stride 2 (PSPNet's, DeepLabV3+'s, HRNet-Water's and SegFormer-Lite's
// downsampling convs) and 4 (SegFormer-Lite's 4x4 spatial reduction) are in the
// A tensor map: its element strides are s on W and H, so a box of s TW x s TH
// pixels lands as the TW x TH pixels of the strided grid, one tap a stage (TMA
// boxes are at most 256 wide: TW <= 256 / s).
//
// What bounds it on an H100: bytes at the full-resolution levels (at (8, 512,
// 512, 64 -> 64) 3x3: 134.2 MB in; out 268.4 MB as bf16, 0.120 ms at 3.35 TB/s,
// or 134.2 MB as codes, 0.080 ms), int8 tensor operations at the deep ones (at
// (8, 32, 32, 1024 -> 1024) 3x3: 154.6 GOP, 0.078 ms at 1979 TOPS).
//
// Design (Hopper: TMA, mbarrier, wgmma), an implicit GEMM with M = output
// pixels, N = Cout, K = KH * KW * Cin:
//   * a persistent grid walks the output tiles, BM = 128 pixels x BN channels:
//     for Cout > 64, 128 x 128 tiles in one block per SM with two consumer
//     warpgroups (64 rows each); for Cout <= 64 (the full-resolution levels),
//     128 x 64 tiles in two blocks per SM with one consumer warpgroup each, so
//     one block's epilogue runs beside the other's products (with one block
//     an SM, the epilogue, run after the products, was about half the time
//     at (8, 512, 512, 64 -> 64) on an H100). A tile's pixels are a
//     rectangle TH x TW of one image (TW a power of two, up to 32 for a KH >
//     1 kernel, else up to BM, so a narrow image wastes no rows), one parity
//     sub-problem, BN channels.
//   * one producer thread keeps a ring of 3-8 stages full (as many as the
//     block's shared memory holds beside the staging tiles). A stage is one
//     64-channel chunk at one kx for all KH taps ky: one 4-D TMA box (C, W, H, N) of TH +
//     (KH - 1) * dil rows, requested at (c0, x0 - pad_l + kx * dil, y0 - pad_t,
//     n), in which tap ky's pixels start ky * dil rows down (a whole number of
//     512-byte swizzle atoms when TW % 8 == 0), and the KH weight slices (64 x
//     BN each, 2-D TMA boxes over the packed matrix at (tap * Cin + c0, n0)).
//     A box a tap would read each input row three times over per kx; the
//     taller box reads it (TH + 2) / TH times, which is what bounds the
//     full-resolution levels: the L2-to-shared traffic. Where a tile is
//     narrower than 8 pixels a stage is one tap (a box of TH rows at y0 -
//     pad_t + ky * dil), as at stride 2, where tap ky's rows are not rows of
//     the strided grid of tap 0 (for odd ky * dil). TMA zero-fills what lies
//     outside the tensor: the
//     padding (uneven too), the dilations, the ragged right and bottom edges,
//     and the channels past Cin when Cin % 64 != 0 (a zero A value cancels
//     whatever B holds there). Both land in the 64-byte swizzle a wgmma
//     descriptor reads (a pixel's 64 channels are one swizzle row), so no
//     thread computes an address. Im2col-mode TMA would fetch one box a tap;
//     the tiled mode shares the rows between taps and keeps the dilations and
//     per-side padding in plain coordinates. A C_in that is a multiple of 16 but
//     not of 64 (HRNet-Water's 144) leaves its last chunk part zero-filled; the
//     B tile there reads the next tap's rows (or TMA's zeros past the last),
//     which the zero A columns cancel.
//   * the consumer warpgroups, each 64 or 128 rows of the tile, issue
//     wgmma.mma_async m64nBNk32 s8 x s8 -> s32 with both operands in shared
//     memory (SS, K-major), two K steps a tap, and hand a stage back once
//     the products of the next one are issued (wgmma.wait_group 1). The
//     accumulators stay in registers for the whole K loop.
//   * the epilogue: scale (x_step * w_step) and bias sit in shared memory once
//     per block; each consumer warpgroup rounds its accumulators in the order
//     above, stages the tile in shared memory (1, 2 or 4 bytes a value; rows
//     padded by 16 bytes against bank conflicts) and writes whole pixel rows
//     with coalesced 16-byte stores (8-byte when a codes row is not a multiple
//     of 16 bytes), skipping pixels and channels outside the output; a
//     transposed conv's sub-problem writes at output stride 2. The producer
//     meanwhile loads the next tile's first stages, so the epilogue overlaps
//     the next tile's loads. Codes mode quantizes without a division and, but
//     for near-ties, without a conversion instruction (`quantize`).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;           // int8 values of K a stage: one 64-byte swizzle row a pixel
constexpr int MAX_STAGES = 8;
constexpr int SMEM_SM = 233472;  // an H100 SM's shared memory, 1 KB of it reserved a block

// A block: CONS consumer warpgroups and a producer (a warpgroup beside two
// consumers, whose registers they take with setmaxnreg; a warp beside one),
// CONS == 1 blocks two to an SM.
__host__ __device__ constexpr int threads(int cons) { return cons * 128 + (cons == 1 ? 32 : 128); }
__host__ __device__ constexpr int blocks_per_sm(int cons) { return cons == 1 ? 2 : 1; }
constexpr int smem_limit(int cons) { return SMEM_SM / blocks_per_sm(cons) - 1024; }

struct Geometry {
  int Cin, Cout, KH, KW, chunks;  // chunks: 64-channel K steps a tap
  int pad_t, pad_l, dil, stride;  // a transposed conv's pad is its lo (`lead_pad`)
  int R, row_groups;       // ky taps a stage (KH or 1), KH / R
  int a_box_bytes, a_bytes, stage_bytes;  // a stage: the A box (rounded to 1 KB), then R B tiles
  int Mh, Mw;              // the grid of output pixels of one sub-problem
  int TW, TH, tw_log;      // tile rectangle, TW = 1 << tw_log
  int tiles_x, tiles_y, n_tiles_n, subs;
  long long n_tiles;
  int out_h, out_w, os;    // output tensor H, W; output stride (2 for a transposed conv)
  int cout_pad;            // n_tiles_n * BN: the scale and bias arrays in shared memory
  int stages, stage_out_bytes, out_row_stride, vec, row_chunks_log;  // vec-byte chunks a row
  float x_step;
  float out_inv;     // RN(1 / out_step): codes mode multiplies by it (see `quantize`)
  double out_inv_d;  // the same in double, for the exact path
};

struct Tile {
  int nt, sub, tx, ty, b;
};

// tile t: output-channel tile fastest (neighbouring blocks share their A boxes
// in L2), then the parity sub-problem, then the pixel rectangle and the image
__device__ __forceinline__ Tile decode(long long t, const Geometry& g) {
  Tile r;
  r.nt = int(t % g.n_tiles_n);
  t /= g.n_tiles_n;
  r.sub = int(t % g.subs);
  t /= g.subs;
  r.tx = int(t % g.tiles_x);
  t /= g.tiles_x;
  r.ty = int(t % g.tiles_y);
  r.b = int(t / g.tiles_y);
  return r;
}

// the leading padding of sub-problem parity p (0 or 1) along an axis: a plain
// conv's own; in a transposed conv, whose pad is lo, (lo - p) >> 1
__device__ __forceinline__ int lead_pad(const Geometry& g, int pad, int p) {
  return g.subs == 4 ? (pad - p) >> 1 : pad;
}

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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor: K-major, 64-byte swizzle, 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(512 >> 4) << 32) |
         (uint64_t(2) << 62);
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

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b);

// d (64 x 64 s32, this thread's 32) += A (64 x 32 s8) * B (32 x 64 s8), both read
// from shared memory through their descriptors
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));  // scale-d: accumulate
}

// d (64 x 128 s32, this thread's 64) += A (64 x 32 s8) * B (32 x 128 s8), both read
// from shared memory through their descriptors
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));  // scale-d: accumulate
}

// The site's quantization of one widened output value v: q = RN(v / step) as
// a float, rounded half to even to an integer, clamped to +-127, without a
// division and, but for near-ties, without a conversion instruction (those
// run at a quarter of the float rate).
//   * qa = RN(v * RN(1 / step)) is within 2^-13 of q wherever |q| <= 256 (two
//     relative errors of 2^-24 at most, and q's own rounding). Rounding and
//     clamping to the integers +-127 commute, so qa is clamped first; its
//     rint comes from the magic-number add (1.5 * 2^23 rounds the sum half to
//     even to an integer), which also gives its bits. Where qa lies 2^-12 or
//     more from every half-integer, q lies on the same side of each as qa,
//     and rint(q) = rint(qa); past +-127.5 both clamp alike.
//   * otherwise (exact ties, as a power-of-two step gives, and near-ties) q is
//     computed exactly: v times the double RN(1 / step), rounded to double,
//     then to float, is RN(v / step): the product is within 2^-52 (relative) of
//     v / step, and the quotient of two floats (24-bit significands) is never
//     within 2^-49 of a float rounding midpoint (a 25-bit odd significand: v =
//     M * step would need more than 24 bits), so both round alike.
// __fdiv_rn costs far more here: its range check sends zeros (half the
// values after a ReLU), and whole warps with them, down a slow path.
__device__ __forceinline__ int quantize(float v, float inv, double inv_d) {
  constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23
  const float qa = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  const float t = __fadd_rn(qa, MAGIC);
  const float frac = __fsub_rn(qa, __fsub_rn(t, MAGIC));  // qa - rint(qa), exact
  if (fabsf(fabsf(frac) - 0.5f) < 0x1p-12f) {
    const int n = __float2int_rn(__double2float_rn(__dmul_rn(double(v), inv_d)));
    return min(max(n, -127), 127);
  }
  return __float_as_int(t) - 0x4B400000;  // rint(qa): t's low mantissa bits
}

// v * 0.1 in the output dtype: in bf16, the slope is bf16(0.1) = 0.10009765625
// and the product of two bf16 values is exact in float, then rounded once
template <bool BF16>
__device__ __forceinline__ float leaky(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, 0.10009765625f)));
  return __fmul_rn(v, 0.1f);
}

// MODE = 4 ACT + OUT. ACT: 0 none, 1 relu, 2 leaky (kernels/int8_conv.py::ACTS);
// OUT 0: float32 values, 1: bf16 values, 2: codes of float32 values, 3: codes of
// bf16 values. Writes this warpgroup's accumulators, finished, to its staging
// tile (row = the warpgroup's pixel, out_row_stride bytes a row).
template <int BN, int MW, int MODE>
__device__ __forceinline__ void stage_tile(const int (&acc)[MW][BN / 2], uint32_t dst,
                                           uint32_t sb, const Geometry& g, int n0, int warp,
                                           int lane) {
  constexpr int ACT = MODE >> 2, OUT = MODE & 3;
  constexpr bool BF16 = OUT == 1 || OUT == 3;
  const uint32_t sc_s = sb + n0 * 4, bi_s = sb + (g.cout_pad + n0) * 4;
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = i * 8 + (lane & 3) * 2;
      float2 sc, bi;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                   : "=f"(sc.x), "=f"(sc.y) : "r"(sc_s + col * 4));
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                   : "=f"(bi.x), "=f"(bi.y) : "r"(bi_s + col * 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m * 64 + warp * 16 + (lane >> 2) + h * 8;
        float y0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[m][4 * i + 2 * h]), sc.x), bi.x);
        float y1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[m][4 * i + 2 * h + 1]), sc.y), bi.y);
        if (BF16) {
          y0 = __bfloat162float(__float2bfloat16_rn(y0));
          y1 = __bfloat162float(__float2bfloat16_rn(y1));
        }
        if (ACT == 1) {  // torch.relu's choice: -0.0 stays, NaN stays
          y0 = y0 < 0.0f ? 0.0f : y0;
          y1 = y1 < 0.0f ? 0.0f : y1;
        } else if (ACT == 2) {  // where(v >= 0, v, v * slope): -0.0 stays, NaN stays
          y0 = y0 >= 0.0f ? y0 : leaky<BF16>(y0);
          y1 = y1 >= 0.0f ? y1 : leaky<BF16>(y1);
        }
        const uint32_t at = dst + row * g.out_row_stride;
        if (OUT == 0) {
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(at + col * 4), "f"(y0), "f"(y1)
                       : "memory");
        } else if (OUT == 1) {
          __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);  // exact: both are bf16 values
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + col * 2),
                       "r"(*reinterpret_cast<uint32_t*>(&v))
                       : "memory");
        } else {
          const uint32_t q = (uint32_t(quantize(y0, g.out_inv, g.out_inv_d)) & 0xFFu) |
                             ((uint32_t(quantize(y1, g.out_inv, g.out_inv_d)) & 0xFFu) << 8);
          asm volatile("st.shared.b16 [%0], %1;" ::"r"(at + col), "h"(uint16_t(q)) : "memory");
        }
      }
    }
}

// Writes this warpgroup's staged rows to the output: whole pixel rows of
// g.vec-byte chunks, neighbouring threads on neighbouring chunks.
template <int BN, int MW, int OB>
__device__ __forceinline__ void store_tile(uint32_t src, unsigned char* __restrict__ out,
                                           const Geometry& g, const Tile& T, int wg, int ltid) {
  constexpr int ROWS = 64 * MW;
  const int n0 = T.nt * BN, py = T.sub >> 1, px = T.sub & 1;
  for (int idx = ltid; idx < ROWS << g.row_chunks_log; idx += 128) {
    const int r = idx >> g.row_chunks_log, ch = idx & ((1 << g.row_chunks_log) - 1);
    const int p = wg * ROWS + r;  // the tile's pixel
    const int oy = T.ty * g.TH + (p >> g.tw_log), ox = T.tx * g.TW + (p & (g.TW - 1));
    const int c = n0 + ch * g.vec / OB;
    if (oy >= g.Mh || ox >= g.Mw || c >= g.Cout) continue;
    const size_t pix =
        (size_t(T.b) * g.out_h + size_t(oy) * g.os + py) * g.out_w + size_t(ox) * g.os + px;
    unsigned char* dst = out + (pix * g.Cout + c) * OB;
    const uint32_t at = src + r * g.out_row_stride + ch * g.vec;
    if (g.vec == 16) {
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(at));
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      uint2 v;
      asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(at));
      *reinterpret_cast<uint2*>(dst) = v;
    }
  }
}

template <int BN, int MW, int MODE>
__device__ __forceinline__ void epilogue(const int (&acc)[MW][BN / 2], uint32_t staging,
                                         uint32_t sb, unsigned char* __restrict__ out,
                                         const Geometry& g, const Tile& T, int wg, int ltid) {
  constexpr int OB = (MODE & 3) == 0 ? 4 : ((MODE & 3) == 1 ? 2 : 1);
  named_barrier(1 + wg, 128);  // the previous tile's stores have read the staging tile
  stage_tile<BN, MW, MODE>(acc, staging, sb, g, T.nt * BN, ltid >> 5, ltid & 31);
  named_barrier(1 + wg, 128);
  store_tile<BN, MW, OB>(staging, out, g, T, wg, ltid);
}

// the epilogue of `mode` (MODE of `stage_tile`), one instantiation each, so
// that no branch on the activation or the output is left among the values
template <int BN, int MW, int MODE = 0>
__device__ __forceinline__ void epilogue_of(int mode, const int (&acc)[MW][BN / 2],
                                            uint32_t staging, uint32_t sb,
                                            unsigned char* __restrict__ out, const Geometry& g,
                                            const Tile& T, int wg, int ltid) {
  if constexpr (MODE < 11) {
    if (mode != MODE) return epilogue_of<BN, MW, MODE + 1>(mode, acc, staging, sb, out, g, T, wg,
                                                           ltid);
  }
  epilogue<BN, MW, MODE>(acc, staging, sb, out, g, T, wg, ltid);
}

template <int BN, int MW, int CONS>
__global__ void __launch_bounds__(threads(CONS), blocks_per_sm(CONS))
int8_conv_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap, const float* __restrict__ w_step,
                 const float* __restrict__ bias, unsigned char* __restrict__ out,
                 const Geometry g, int mode) {
  constexpr int B_BYTES = BN * BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // TMA's and wgmma's swizzle atoms
  const uint32_t staging = ring + g.stages * g.stage_bytes;
  const uint32_t sb = staging + CONS * g.stage_out_bytes;  // scale[cout_pad], bias[cout_pad]
  const uint32_t full = sb + 8 * g.cout_pad, empty = full + 8 * MAX_STAGES;
  const int tid = threadIdx.x;
  // the role of this thread's warpgroup, read through a shuffle so the
  // compiler knows it is warp-uniform and keeps the wgmma path convergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  for (int c = tid; c < g.cout_pad; c += threads(CONS)) {
    const bool in = c < g.Cout;
    const float s = in ? __fmul_rn(g.x_step, __ldg(w_step + c)) : 0.0f;
    const float b = in ? __ldg(bias + c) : 0.0f;
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(sb + c * 4), "f"(s) : "memory");
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(sb + (g.cout_pad + c) * 4), "f"(b) : "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONS * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int k_iters = g.chunks * g.KW * g.row_groups;
  if (wg == CONS) {  // the producer: one thread keeps the ring full
    if constexpr (CONS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == CONS * 128) {
      int s = 0;
      uint32_t ph = 0;
      for (long long t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
        const Tile T = decode(t, g);
        const int x0 = T.tx * g.TW * g.stride - lead_pad(g, g.pad_l, T.sub & 1);
        const int y0 = T.ty * g.TH * g.stride - lead_pad(g, g.pad_t, T.sub >> 1);
        const int brow = T.sub * g.Cout + T.nt * BN;
        for (int c = 0; c < g.chunks; ++c)
          for (int kx = 0; kx < g.KW; ++kx)
            for (int gy = 0; gy < g.row_groups; ++gy) {
              mbar_wait(empty + 8 * s, ph ^ 1);  // a fresh ring passes at once
              // zero-filled bytes count too
              mbar_arrive_expect_tx(full + 8 * s, g.a_box_bytes + g.R * B_BYTES);
              const uint32_t dst = ring + s * g.stage_bytes;
              tma_load_4d(dst, &amap, full + 8 * s, c * BK, x0 + kx * g.dil,
                          y0 + gy * g.R * g.dil, T.b);
              for (int j = 0; j < g.R; ++j) {
                const int tap = (gy * g.R + j) * g.KW + kx;
                tma_load_2d(dst + g.a_bytes + j * B_BYTES, &bmap, full + 8 * s,
                            tap * g.Cin + c * BK, brow);
              }
              if (++s == g.stages) {
                s = 0;
                ph ^= 1;
              }
            }
      }
    }
    return;
  }

  if constexpr (CONS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int ltid = tid % 128, lane = tid % 32;
  const uint32_t my_staging = staging + wg * g.stage_out_bytes;
  int s = 0;
  uint32_t ph = 0;
  for (long long t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const Tile T = decode(t, g);
    int acc[MW][BN / 2];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[m][j] = 0;
    int prev = 0;
    for (int k = 0; k < k_iters; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t a_s = ring + s * g.stage_bytes + wg * MW * 64 * BK;  // this warpgroup's rows
      const uint32_t b_s = ring + s * g.stage_bytes + g.a_bytes;
      wgmma_fence();
      for (int j = 0; j < g.R; ++j) {  // tap ky = gy * R + j: its pixels start j * dil rows down
        const uint32_t a_j = a_s + j * g.dil * g.TW * BK, b_j = b_s + j * B_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
          for (int m = 0; m < MW; ++m)
            wgmma_s8<BN>(acc[m], desc64(a_j + m * 64 * BK + kk * 32), desc64(b_j + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: hand it back
      if (k > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == g.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    epilogue_of<BN, MW>(mode, acc, my_staging, sb, out, g, T, wg, ltid);
  }
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

// an int8 map with a 64-byte swizzle, zero fill outside the tensor; `elem` the
// traversal strides (a box of b elements at stride e loads ceil(b / e) of them)
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
              const cuuint32_t* elem) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, cuuint32_t(rank), const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the ring's depth for `g`'s stage size: as many stages as the shared memory
// holds beside the staging tiles, the scale and bias and the barriers
int ring_stages(const Geometry& g, int cons) {
  const int fixed = 1024 + cons * g.stage_out_bytes + 8 * g.cout_pad + 16 * MAX_STAGES;
  const int stages = (smem_limit(cons) - fixed) / g.stage_bytes;
  return stages > MAX_STAGES ? MAX_STAGES : stages;
}

template <int BN, int MW, int CONS>
int launch(const CUtensorMap& amap, const CUtensorMap& bmap, const float* w_step,
           const float* bias, void* out, const Geometry& g, int mode, cudaStream_t stream) {
  const int smem = 1024 + CONS * g.stage_out_bytes + 8 * g.cout_pad + 16 * MAX_STAGES +
                   g.stages * g.stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<BN, MW, CONS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  // all of the SM's L1 as shared memory, so two narrow blocks fit beside each other
  err = cudaFuncSetAttribute(int8_conv_kernel<BN, MW, CONS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  const long long slots = (long long)sms * blocks_per_sm(CONS);
  const int grid = int(g.n_tiles < slots ? g.n_tiles : slots);
  int8_conv_kernel<BN, MW, CONS><<<grid, threads(CONS), smem, stream>>>(
      amap, bmap, w_step, bias, static_cast<unsigned char*>(out), g, mode);
  return int(cudaGetLastError());
}

}  // namespace

// x int8 (N, H, W, Cin); w int8 packed (subs, Cout, KH * KW * Cin); w_step, bias
// float (Cout); out (N, Ho, Wo, Cout) float32 or bf16 (values) or int8 (codes).
// For a plain conv (transposed 0) the M grid is (Mh, Mw) = (Ho, Wo), stride 1, 2
// or 4; for a transposed one (transposed 1: KH = KW = n, the sub-problems'
// kernel, 1 or 2; pad_t = pad_l = lo, from which the parities' leading pads
// come: (n, lo) = (1, 1), (2, 2) or (2, 1); dil 1, stride 1) it is the input
// grid (H, W) and the output is (2H, 2W). act: 0 none, 1 relu, 2 leaky.
extern "C" int coastline_int8_conv(const void* x, const void* w, const void* w_step,
                                   const void* bias, void* out, int N, int H, int W, int Cin,
                                   int Cout, int KH, int KW, int pad_t, int pad_l, int dil,
                                   int stride, int Mh, int Mw, int transposed, float x_step,
                                   int out_bf16, int act, int codes, float out_step,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || KH <= 0 || KW <= 0 || dil <= 0 ||
      Mh <= 0 || Mw <= 0 || Cin % 16 || Cout % 8 || (stride != 1 && stride != 2 && stride != 4) ||
      act < 0 || act > 2)
    return int(cudaErrorInvalidValue);
  if (transposed && (KH != KW || KH > 2 || pad_t != pad_l ||
                     !(pad_t == KH || (KH == 2 && pad_t == 1)) || dil != 1 || stride != 1 ||
                     Mh != H || Mw != W))
    return int(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorSymbolNotFound);
  const bool wide = Cout > 64;  // 128 x 128 tiles, two consumers; else 128 x 64, one
  const int BN = wide ? 128 : 64, BM = 128, cons = wide ? 2 : 1;
  Geometry g;
  g.Cin = Cin; g.Cout = Cout; g.KH = KH; g.KW = KW; g.chunks = (Cin + BK - 1) / BK;
  g.pad_t = pad_t; g.pad_l = pad_l; g.dil = dil; g.stride = stride;
  g.Mh = Mh; g.Mw = Mw;
  // with KH > 1 a tile row is at most 32 pixels, so a tile spans 4-8 rows and
  // its box of TH + 2 dil rows loads each row 1.25-1.5 times a kx, not 3; a
  // strided box spans stride * TW <= 256 columns
  int tw_max = KH > 1 ? 32 : BM;
  if (tw_max * stride > 256) tw_max = 256 / stride;
  g.tw_log = 0;
  while ((1 << g.tw_log) < Mw && (1 << g.tw_log) < tw_max) ++g.tw_log;
  g.TW = 1 << g.tw_log; g.TH = BM / g.TW;
  g.tiles_x = (Mw + g.TW - 1) / g.TW; g.tiles_y = (Mh + g.TH - 1) / g.TH;
  g.n_tiles_n = (Cout + BN - 1) / BN;
  g.subs = transposed ? 4 : 1;
  g.n_tiles = (long long)g.subs * N * g.tiles_y * g.tiles_x * g.n_tiles_n;
  g.os = transposed ? 2 : 1;
  g.out_h = Mh * g.os; g.out_w = Mw * g.os;
  g.cout_pad = g.n_tiles_n * BN;
  const int ob = codes ? 1 : (out_bf16 ? 2 : 4);
  g.vec = (Cout * ob) % 16 == 0 ? 16 : 8;
  g.row_chunks_log = 0;
  while ((g.vec << g.row_chunks_log) < BN * ob) ++g.row_chunks_log;
  g.out_row_stride = BN * ob + 16;
  g.stage_out_bytes = BM / cons * g.out_row_stride;
  // Merge the KH row taps of a (chunk, kx) into one stage when a tap's rows
  // start on a swizzle atom (TW % 8 == 0: j * dil * TW pixels of 64 bytes is
  // a multiple of 512) and the box and the ring fit; else, and at stride 2,
  // one tap a stage.
  for (g.R = stride == 1 ? KH : 1; ; g.R = 1) {
    const int a_rows = g.TH + (g.R - 1) * dil;
    g.a_box_bytes = a_rows * g.TW * BK;
    g.a_bytes = (g.a_box_bytes + 1023) / 1024 * 1024;
    g.stage_bytes = g.a_bytes + g.R * BN * BK;
    g.stages = ring_stages(g, cons);
    if (g.R == 1 || (g.TW % 8 == 0 && a_rows <= 256 && g.stages >= 3)) break;
  }
  g.row_groups = KH / g.R;
  if (g.stages < 3) return int(cudaErrorInvalidValue);  // C_out too wide for the staging
  g.x_step = x_step;
  g.out_inv = codes ? 1.0f / out_step : 1.0f;  // an IEEE float division: RN(1 / out_step)
  g.out_inv_d = codes ? 1.0 / double(out_step) : 1.0;
  const int mode = 4 * act + (codes ? 2 : 0) + (out_bf16 ? 1 : 0);

  // A: the input, (C, W, H, N); a box is one 64-channel chunk of TH + (R - 1) dil
  // rows; at stride s > 1 the map steps by s on W and H, and a box of s TW x s TH
  // pixels loads the TW x TH of the strided grid (R is 1 there)
  const cuuint64_t a_dims[4] = {cuuint64_t(Cin), cuuint64_t(W), cuuint64_t(H), cuuint64_t(N)};
  const cuuint64_t a_strides[3] = {cuuint64_t(Cin), cuuint64_t(W) * Cin,
                                   cuuint64_t(H) * cuuint64_t(W) * Cin};
  const cuuint32_t a_box[4] = {BK, cuuint32_t(g.TW * stride),
                               cuuint32_t((g.TH + (g.R - 1) * dil) * stride), 1};
  const cuuint32_t a_elem[4] = {1, cuuint32_t(stride), cuuint32_t(stride), 1};
  // B: the packed weights, (K, rows): rows = Cout, or 4 * Cout for the sub-problems
  const int kdim = KH * KW * Cin;
  const cuuint64_t b_dims[2] = {cuuint64_t(kdim), cuuint64_t(Cout) * g.subs};
  const cuuint64_t b_strides[1] = {cuuint64_t(kdim)};
  const cuuint32_t b_box[2] = {BK, cuuint32_t(BN)};
  CUtensorMap amap, bmap;
  const cuuint32_t b_elem[2] = {1, 1};
  if (!make_map(encode, &amap, x, 4, a_dims, a_strides, a_box, a_elem) ||
      !make_map(encode, &bmap, w, 2, b_dims, b_strides, b_box, b_elem))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(w_step);
  const float* bp = static_cast<const float*>(bias);
  return wide ? launch<128, 1, 2>(amap, bmap, sp, bp, out, g, mode, s)
              : launch<64, 2, 1>(amap, bmap, sp, bp, out, g, mode, s);
}
