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
// ~1.3 us for (8, 512, 512), and one max per SE column and per SE row a
// pixel is far below the integer rate, so neither roof binds: launch and
// latency do. The design keeps the card full and every thread's work short
// and independent:
//   * small tiles, TH = 32 rows x 16 words (64 uint8 or 16 float32 pixels),
//     256 threads: (8, 512, 512) uint8 gives 1,024 CTAs, ~8 per SM;
//   * uint8 pixels are packed 4 to a 32-bit word; a SIMD byte max is two of
//     Hopper's native 16x2 integer maxima (max.u16x2, DPX __vimax3_u16x2,
//     even and odd bytes apart), where __vmaxu4 is emulated in several
//     instructions; the window at any pixel offset is one __funnelshift_r of
//     two staged words, four offsets a source word; float32 keeps one pixel
//     a word;
//   * the tile and its halo (the SE's vertical reach above and below, its
//     column reach left and right, rounded up to whole words) are staged in
//     shared memory with 4-byte loads, zero-filled outside the image; a word
//     that starts unaligned in device memory (a plane of (3, 97, 301)) is two
//     aligned loads and a funnel shift, and a word at the image edge takes
//     the byte path;
//   * per row group, a horizontal pass (one thread per halo word column and
//     four halo rows 16 apart, four independent chains of equal length) grows
//     the window from the previous, narrower group's (the nested-window
//     trick; a group whose interval does not contain the previous one is
//     rebuilt), then, after one barrier, a vertical pass (one thread per two
//     output words, two independent accumulators) folds the group's shifts.
//     The windows alternate between two buffers, so one barrier a group
//     suffices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;       // output rows per tile
constexpr int WORDS = 16;    // output words per tile row
constexpr int THREADS = 256;
constexpr int OUT_WORDS = TH * WORDS / THREADS;  // output words per thread
constexpr int CHAINS = 4;    // halo rows a thread folds at once, for latency hiding

static_assert(THREADS % WORDS == 0 && (TH * WORDS) % THREADS == 0, "tile mapping");

// the 16x2 unsigned max of PTX 8.0, native on sm_90
__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

struct U8 {
  using word = uint32_t;
  using pixel = uint8_t;
  static constexpr int PX = 4;
  // A SIMD byte max from Hopper's 16x2 integer max (DPX): the even bytes and
  // the odd bytes of a word, each in its own halfword lane.
  static constexpr word EVEN = 0x00ff00ffu, ODD = 0xff00ff00u;
  __device__ static word vmax(word a, word b) {
    return max_u16x2(a & EVEN, b & EVEN) | max_u16x2(a & ODD, b & ODD);
  }
  __device__ static word vmax3(word a, word b, word c) {
    return __vimax3_u16x2(a & EVEN, b & EVEN, c & EVEN) | __vimax3_u16x2(a & ODD, b & ODD, c & ODD);
  }
  // v[k] = max of v[k] and the words that start at pixel offsets o .. o + n - 1
  // of staged row row[k]: K independent chains of one trip count (the rows
  // share their offsets), the two byte halves kept apart until the end
  template <int K>
  __device__ static void fold(const word* const (&row)[K], int o, int n, word (&v)[K]) {
    if (n <= 0) return;
    word ve[K], vo[K], cur[K], nxt[K];
    int q = o >> 2, sh = o & 3, i = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ve[k] = v[k] & EVEN;
      vo[k] = v[k] & ODD;
      cur[k] = row[k][q];
      nxt[k] = row[k][q + 1];  // a read past the row stays in the buffer, unused
    }
    for (; i < n && sh != 0; ++i) {  // single offsets up to a word boundary
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const word w = __funnelshift_r(cur[k], nxt[k], sh * 8);
        ve[k] = max_u16x2(ve[k], w & EVEN);
        vo[k] = max_u16x2(vo[k], w & ODD);
      }
      if (++sh == 4) {
        sh = 0;
        ++q;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          cur[k] = nxt[k];
          nxt[k] = row[k][q + 1];
        }
      }
    }
    for (; i + 4 <= n; i += 4) {  // four offsets of one source word at a time
      ++q;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const word c = cur[k], d = nxt[k];
        const word w1 = __funnelshift_r(c, d, 8), w2 = __funnelshift_r(c, d, 16),
                   w3 = __funnelshift_r(c, d, 24);
        ve[k] = __vimax3_u16x2(__vimax3_u16x2(ve[k], c & EVEN, w1 & EVEN), w2 & EVEN, w3 & EVEN);
        vo[k] = __vimax3_u16x2(__vimax3_u16x2(vo[k], c & ODD, w1 & ODD), w2 & ODD, w3 & ODD);
        cur[k] = d;
        nxt[k] = row[k][q + 1];
      }
    }
    for (; i < n; ++i, ++sh) {  // the last one to three offsets (sh < 4)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const word w = __funnelshift_r(cur[k], nxt[k], sh * 8);
        ve[k] = max_u16x2(ve[k], w & EVEN);
        vo[k] = max_u16x2(vo[k], w & ODD);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = ve[k] | vo[k];
  }
  // the staged word of image row `src` (W pixels) at columns gc .. gc + 3
  __device__ static word stage(const pixel* src, int gc, int W) {
    if (gc >= 0 && gc + 4 <= W) {
      const uintptr_t addr = reinterpret_cast<uintptr_t>(src + gc);
      const int sh = int(addr & 3);
      if (sh == 0) return __ldg(reinterpret_cast<const word*>(addr));
      const uintptr_t a = addr - sh;
      if (a >= reinterpret_cast<uintptr_t>(src) && a + 8 <= reinterpret_cast<uintptr_t>(src + W))
        return __funnelshift_r(__ldg(reinterpret_cast<const word*>(a)),
                               __ldg(reinterpret_cast<const word*>(a + 4)), sh * 8);
    }
    word v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (gc + b >= 0 && gc + b < W) v |= word(__ldg(src + gc + b)) << (8 * b);
    return v;
  }
  __device__ static void store(pixel* dst, int gc, int W, word v) {
    if (gc + 4 <= W && (reinterpret_cast<uintptr_t>(dst + gc) & 3) == 0) {
      *reinterpret_cast<word*>(dst + gc) = v;
      return;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (gc + b < W) dst[gc + b] = pixel(v >> (8 * b));
  }
};

struct F32 {
  using word = float;
  using pixel = float;
  static constexpr int PX = 1;
  // NaN-propagating, as torch.maximum in the plain version
  __device__ static word vmax(word a, word b) { return (a > b || a != a) ? a : b; }
  __device__ static word vmax3(word a, word b, word c) { return vmax(vmax(a, b), c); }
  template <int K>
  __device__ static void fold(const word* const (&row)[K], int o, int n, word (&v)[K]) {
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = vmax(v[k], row[k][o + i]);
  }
  __device__ static word stage(const pixel* src, int gc, int W) {
    return (gc >= 0 && gc < W) ? __ldg(src + gc) : 0.0f;
  }
  __device__ static void store(pixel* dst, int gc, int W, word v) {
    if (gc < W) dst[gc] = v;
  }
};

// pad: the staged columns left of the tile (the SE's left reach, rounded up
// to whole words); rw: staged words a row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dilate_kernel(const typename T::pixel* __restrict__ x, typename T::pixel* __restrict__ out,
              const int* __restrict__ desc, int H, int W, int top, int bot, int pad, int rw) {
  using word = typename T::word;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = TH + top + bot;
  word* sin = reinterpret_cast<word*>(smem);
  word* hw0 = sin + rows * rw + 1;  // one padding word after the staged rows
  word* hw1 = hw0 + rows * WORDS;

  const size_t plane = size_t(H) * W;
  const typename T::pixel* src = x + blockIdx.z * plane;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * WORDS * T::PX;
  const int tid = threadIdx.x;

  for (int i = tid; i < rows * rw; i += THREADS) {
    const int r = i / rw, q = i % rw;
    const int gy = y0 - top + r;
    sin[i] = (gy >= 0 && gy < H) ? T::stage(src + size_t(gy) * W, x0 - pad + q * T::PX, W)
                                 : word(0);
  }
  if (tid == 0) sin[rows * rw] = word(0);
  __syncthreads();  // the tile is staged

  const int ow = tid % WORDS, oj = tid / WORDS;  // this thread's output words: rows oj + k * (THREADS / WORDS)
  word acc[OUT_WORDS];
#pragma unroll
  for (int k = 0; k < OUT_WORDS; ++k) acc[k] = word(0);

  const int groups = __ldg(desc);
  int pos = 1, plo = 0, phi = -1;
  word* prev = hw1;
  for (int g = 0; g < groups; ++g) {
    const int lo = __ldg(desc + pos), hi = __ldg(desc + pos + 1), ns = __ldg(desc + pos + 2);
    const bool extend = g > 0 && lo <= plo && hi >= phi;
    // Group g writes one buffer and reads only its own items of the other:
    // a thread here has passed group g - 1's barrier, so no thread still
    // reads this buffer for group g - 2.
    word* cur = (g & 1) ? hw1 : hw0;
    // a thread's items: one word column, CHAINS rows 16 apart, folded together
    for (int i0 = tid; i0 < rows * WORDS; i0 += CHAINS * THREADS) {
      const int r0 = i0 / WORDS, w = i0 % WORDS, base = pad + w * T::PX;
      const word* row[CHAINS];
      word v[CHAINS];
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) {
        const int r = min(r0 + k * (THREADS / WORDS), rows - 1);  // past the end: a spare chain
        row[k] = sin + r * rw;
        v[k] = extend ? prev[r * WORDS + w] : word(0);
      }
      if (extend) {
        T::fold(row, base + lo, plo - lo, v);
        T::fold(row, base + phi + 1, hi - phi, v);
      } else {
        T::fold(row, base + lo, hi - lo + 1, v);
      }
#pragma unroll
      for (int k = 0; k < CHAINS; ++k)
        if (r0 + k * (THREADS / WORDS) < rows) cur[i0 + k * THREADS] = v[k];
    }
    __syncthreads();  // the window of group g is complete
    constexpr int STEP = (THREADS / WORDS) * WORDS;  // between a thread's output words
    int k = 0;
    for (; k + 2 <= ns; k += 2) {  // two SE rows at a time
      const word* c0 = cur + (top - __ldg(desc + pos + 3 + k) + oj) * WORDS + ow;
      const word* c1 = cur + (top - __ldg(desc + pos + 4 + k) + oj) * WORDS + ow;
#pragma unroll
      for (int t = 0; t < OUT_WORDS; ++t) acc[t] = T::vmax3(acc[t], c0[t * STEP], c1[t * STEP]);
    }
    if (k < ns) {
      const word* c0 = cur + (top - __ldg(desc + pos + 3 + k) + oj) * WORDS + ow;
#pragma unroll
      for (int t = 0; t < OUT_WORDS; ++t) acc[t] = T::vmax(acc[t], c0[t * STEP]);
    }
    prev = cur;
    plo = lo;
    phi = hi;
    pos += 3 + ns;
  }

  typename T::pixel* dst = out + blockIdx.z * plane;
  const int gc = x0 + ow * T::PX;
  if (gc < W) {
#pragma unroll
    for (int t = 0; t < OUT_WORDS; ++t) {
      const int gy = y0 + oj + t * (THREADS / WORDS);
      if (gy < H) T::store(dst + size_t(gy) * W, gc, W, acc[t]);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, const void* desc, int N, int H, int W, int top, int bot,
           int left, int right, void* stream) {
  const int pad = (left + T::PX - 1) / T::PX * T::PX;
  const int rw = (pad + WORDS * T::PX + right + T::PX - 1) / T::PX;
  const size_t rows = TH + top + bot;
  const size_t smem = (rows * rw + 1 + 2 * rows * WORDS) * sizeof(typename T::word);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  if (smem > size_t(optin)) return int(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(dilate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  const int tile_w = WORDS * T::PX;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + TH - 1) / TH, N);
  dilate_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename T::pixel*>(x), static_cast<typename T::pixel*>(out),
      static_cast<const int*>(desc), H, W, top, bot, pad, rw);
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
  if (dtype == 0) return launch<U8>(x, out, desc, N, H, W, top, bot, left, right, stream);
  if (dtype == 1) return launch<F32>(x, out, desc, N, H, W, top, bot, left, right, stream);
  return int(cudaErrorInvalidValue);
}
