// Int8 convolution with a fused dequantizing epilogue, for the PTQ serving path.
//
// No Pallas counterpart: the JAX package runs these convs as XLA s8 x s8 -> s32
// convolutions with the epilogue fused by XLA (coastline/infer/quant.py:573-578,
// the int8 branch of `_conv`). It computes, stride 1, NHWC:
//   y[n, oy, ox, co] = cast(float(acc) * (x_step * w_step[co]) + bias[co])
//   acc = sum over (ky, kx, ci) of x[n, oy - pad_t + ky * dil, ox - pad_l + kx * dil, ci]
//                                  * w[co][(ky * KW + kx) * Cin + ci]
// with x int8, w int8 packed K-major (kernels/int8_conv.py::pack_weights), acc
// int32 (exact), x_step a float, w_step and bias float per output channel. The
// epilogue rounds as XLA does, in its order: x_step * w_step, then acc * that,
// then + bias, each an explicit round-to-nearest intrinsic so that nvcc cannot
// contract them into an FMA; a bf16 result is rounded once (RN). The kernel is
// then bit-equal to the plain version.
//
// A transposed conv of the UNets' decoders (lhs dilation 2, 2x2 kernel, padding
// 1) is launched as its four output-parity sub-problems (blockIdx.z = 2 py + px):
// output pixel (2a + py, 2b + px) is the 1x1 product of input pixel (a, b) with
// tap (1 - py, 1 - px), so each is a dense GEMM over the input grid with no
// zero taps, written at output stride 2.
//
// What bounds it on an H100: bytes at the full-resolution levels (at (8, 512,
// 512, 64 -> 64) 3x3: 134 MB in, 268 MB out in bf16, 0.120 ms at 3.35 TB/s),
// int8 tensor operations at the deep ones (at (8, 32, 32, 1024 -> 1024): 154.6
// GOP, 0.078 ms at 1979 TOPS).
//
// Design (simple first): an implicit GEMM with M = N * Ho * Wo output pixels,
// N = Cout, K = KH * KW * Cin. A block of 256 threads owns a 128 x 64 output
// tile; its 8 warps each own 32 x 32 of it. The K loop steps 32 channels of one
// tap at a time (Cin % 32 == 0, so a step never straddles two taps): the A rows
// are the 32 input channels at each output pixel's tap position (zero-filled by
// cp.async where the tap falls in the padding), the B rows the 32 weights of
// each output channel. Four stages of cp.async keep loads in flight; shared
// rows are padded to 48 bytes so the fragment loads of a warp hit 32 distinct
// banks. The products run on the tensor cores as
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (eight a warp a step). The
// epilogue applies the scale and bias from registers and stores pairs of
// channels. wgmma, TMA and a coalesced store through shared memory are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels a block
constexpr int BN = 64;       // output channels a block
constexpr int BK = 32;       // int8 values of K a stage (one mma depth)
constexpr int LDS = BK + 16; // shared row stride in bytes: conflict-free fragment loads
constexpr int STAGES = 4;
constexpr int THREADS = 256;

struct Geometry {
  int H, W, Cin, Cout, KW, pad_t, pad_l, dil;
  int Mh, Mw;        // the grid of output pixels of one sub-problem
  int out_h, out_w;  // the output tensor's H and W
  int os;            // output stride: 2 for a transposed conv's sub-problems, else 1
  int K, M;          // KH * KW * Cin, N * Mh * Mw
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool BF16>
__device__ __forceinline__ void store_pair(void* out, size_t idx, float y0, float y1) {
  if constexpr (BF16) {
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(y0);
    v.y = __float2bfloat16_rn(y1);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) = v;
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(y0, y1);
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ w_step, const float* __restrict__ bias,
                 void* __restrict__ out, Geometry g, float x_step) {
  __shared__ __align__(16) int8_t As[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's 32 x 32 sub-tile
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int py = blockIdx.z >> 1, px = blockIdx.z & 1;
  const int8_t* wz = w + size_t(blockIdx.z) * g.Cout * g.K;
  const int plane = g.Mh * g.Mw;

  // this thread's A row (one output pixel) and 16-byte half of it
  const int a_row = tid >> 1, a_half = tid & 1;
  const int am = m0 + a_row;
  const bool a_in = am < g.M;
  int an = 0, aoy = 0, aox = 0;
  if (a_in) {
    an = am / plane;
    const int r = am - an * plane;
    aoy = r / g.Mw;
    aox = r - aoy * g.Mw;
  }
  const int8_t* a_img = x + size_t(an) * g.H * g.W * g.Cin + a_half * 16;
  // this thread's B row (one output channel), threads 0..127
  const int b_row = (tid & 127) >> 1;
  const bool b_in = tid < 128 && n0 + b_row < g.Cout;
  const int8_t* b_src = wz + size_t(b_in ? n0 + b_row : 0) * g.K + a_half * 16;

  const int cin_steps = g.Cin / BK;
  const int k_steps = g.K / BK;

  auto load = [&](int stage, int kt) {
    const int tap = kt / cin_steps;
    const int ci0 = (kt - tap * cin_steps) * BK;
    const int ky = tap / g.KW, kx = tap - (tap / g.KW) * g.KW;
    const int iy = aoy - g.pad_t + ky * g.dil, ix = aox - g.pad_l + kx * g.dil;
    const bool ok = a_in && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const int8_t* src = ok ? a_img + (size_t(iy) * g.W + ix) * g.Cin + ci0 : x;
    cp_async16(&As[stage][a_row * LDS + a_half * 16], src, ok);
    if (tid < 128) cp_async16(&Bs[stage][b_row * LDS + a_half * 16], b_src + size_t(kt) * BK, b_in);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_steps) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_steps; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();              // ... and everyone's; stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < k_steps) load(next % STAGES, next);
    cp_async_commit();

    const int8_t* as = As[kt % STAGES];
    const int8_t* bs = Bs[kt % STAGES];
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* r0 = as + (wm * 32 + i * 16 + gid) * LDS + tig * 4;
      a[i][0] = lds32(r0);
      a[i][1] = lds32(r0 + 8 * LDS);
      a[i][2] = lds32(r0 + 16);
      a[i][3] = lds32(r0 + 8 * LDS + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* c0 = bs + (wn * 32 + j * 8 + gid) * LDS + tig * 4;
      const uint32_t b0 = lds32(c0), b1 = lds32(c0 + 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
  }
  cp_async_wait<0>();

  // epilogue: rows gid and gid + 8 of each 16-row tile, channels 2 tig, 2 tig + 1
  float sc[4][2], bi[4][2];
  bool col_in[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = n0 + wn * 32 + j * 8 + tig * 2;
    col_in[j] = co < g.Cout;  // Cout % 8 == 0: the pair is in or out together
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[j][e] = col_in[j] ? __fmul_rn(x_step, w_step[co + e]) : 0.0f;
      bi[j][e] = col_in[j] ? bias[co + e] : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + h * 8 + gid;
      if (m >= g.M) continue;
      const int n = m / plane;
      const int r = m - n * plane;
      const int oy = r / g.Mw, ox = r - (r / g.Mw) * g.Mw;
      const size_t pix = (size_t(n) * g.out_h + oy * g.os + py) * g.out_w + ox * g.os + px;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!col_in[j]) continue;
        const int co = n0 + wn * 32 + j * 8 + tig * 2;
        const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), sc[j][0]), bi[j][0]);
        const float y1 =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sc[j][1]), bi[j][1]);
        store_pair<BF16>(out, pix * g.Cout + co, y0, y1);
      }
    }
  }
}

}  // namespace

// x int8 (N, H, W, Cin); w int8 packed (subs, Cout, KH * KW * Cin); w_step, bias
// float (Cout); out (N, Ho, Wo, Cout) float or bf16. For a plain conv (transposed
// 0) the M grid is (Mh, Mw) = (Ho, Wo); for a transposed one (transposed 1, KH =
// KW = 1, pad 0, dil 1) it is the input grid (H, W) and the output is (2H, 2W).
extern "C" int coastline_int8_conv(const void* x, const void* w, const void* w_step,
                                   const void* bias, void* out, int N, int H, int W, int Cin,
                                   int Cout, int KH, int KW, int pad_t, int pad_l, int dil,
                                   int Mh, int Mw, int transposed, float x_step, int out_bf16,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || KH <= 0 || KW <= 0 || dil <= 0 ||
      Mh <= 0 || Mw <= 0 || Cin % BK || Cout % 8)
    return int(cudaErrorInvalidValue);
  if (transposed && (KH != 1 || KW != 1 || pad_t || pad_l || dil != 1 || Mh != H || Mw != W))
    return int(cudaErrorInvalidValue);
  const long long m = (long long)N * Mh * Mw;
  if (m >= (1LL << 31) - BM) return int(cudaErrorInvalidValue);
  Geometry g;
  g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout; g.KW = KW;
  g.pad_t = pad_t; g.pad_l = pad_l; g.dil = dil;
  g.Mh = Mh; g.Mw = Mw;
  g.os = transposed ? 2 : 1;
  g.out_h = Mh * g.os; g.out_w = Mw * g.os;
  g.K = KH * KW * Cin;
  g.M = int(m);
  const dim3 grid(unsigned((m + BM - 1) / BM), unsigned((Cout + BN - 1) / BN), transposed ? 4 : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(w_step);
  const float* bp = static_cast<const float*>(bias);
  if (out_bf16)
    int8_conv_kernel<true><<<grid, THREADS, 0, s>>>(xp, wp, sp, bp, out, g, x_step);
  else
    int8_conv_kernel<false><<<grid, THREADS, 0, s>>>(xp, wp, sp, bp, out, g, x_step);
  return int(cudaGetLastError());
}
