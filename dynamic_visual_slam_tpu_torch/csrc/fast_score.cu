// FAST-9/16 corner score of every pixel of every pyramid level of a batch of
// frames, in ONE launch (kernel B1 of the port; kernel B3 is the same kernel
// on a table of one level and one frame).
//
// Replaces: dynamic_visual_slam_tpu/ops/fields.py `_score_atlas_rows` (the
// Pallas kernel reached through `fast_score_atlas_batch`), whose body is
// ops/fast.py `_score_block`; and ops/fast.py `corner_score_pallas` (B3).
//
// What it computes: for each pixel p of each (frame, level) image,
//   score(p) = max( max_k min_{i in arc k} (v_i - p),  max_k min_{i in arc k} (p - v_i) )
// over the 16 circular 9-arcs of the radius-3 Bresenham circle, with the
// image border scored against REFLECT_101 pixels (== jnp.pad(mode="reflect")
// of 3 px, as in ops/fast.corner_score).  The result equals the plain PyTorch
// version dynamic_visual_slam_tpu_torch/ops/fast.corner_score on any finite
// float32 input (up to the sign of a zero score), by two exact rewrites:
//   * rounding is monotone, so min_i fl(v_i - p) = fl(min_i v_i - p) and
//     likewise for max: the arc reductions run on the circle values and
//     only two subtractions are left a pixel,
//       score = max( fl(M - p), fl(p - N) ),
//       M = max_k min_{arc k} v,  N = min_k max_{arc k} v;
//   * min and max are exact and associative, so the reductions may be
//     regrouped freely.  They take OpenCV's cornerScore<16> form: for even
//     k one 8-window a = min(v[k+1..k+8]) serves arcs k and k+1, and their
//     larger minimum is min(a, max(v[k], v[k+9])).  Eight 2-windows and
//     eight 4-windows at the odd starts (16), eight max(v[k], v[k+9]) (8),
//     each 8-window's last step fused with its min against that max into
//     one three-input min (8), and the max over the eight as three
//     three-input steps and one two-input step (4): 36 instructions a
//     polarity (`arc_extreme`).  The packed branch issues them as such, with
//     Hopper's three-input DPX `__vimin3_s16x2` / `__vimax3_s16x2` (11 a
//     polarity); the f32 branch has no three-input min/max and spends two
//     fminf/fmaxf on each, 47 a polarity, 95 a pixel with the score's max.
//     No regrouping of this form takes fewer: each 2- and 4-window feeds
//     two 8-windows, and each of the eight arc pairs needs its
//     max(v[k], v[k+9]) and one step more.
//
// What bounds it on the H100: its min/max instructions.  f32 min/max, the
// 16-bit SIMD min/max of two and of three inputs, and 32-bit logic all
// issue at half the f32 add rate (scripts/issue_rates.py measures the
// rates and shows each form is one SASS instruction; chip_smoke.py counts
// the bound at them), against 8 bytes of device memory a pixel (one f32
// read, one f32 written).  At 720p, B = 24, 8 levels (68.5 M px) the packed
// branch needs 73 min/max a pair of pixels (22 of them three-input), 2.5 G
// in all, about 0.15 ms, against 0.55 GB, about 0.16 ms.  Everything else a
// pixel costs (staging, the byte check, addresses, stores) competes for
// the same issue slots, so the design keeps it to a few instructions a
// staged value.
//
// Design: a persistent grid (as many 256-thread blocks as fit on the SMs)
// walks a by-value table of every level and frame, 64x32 output tiles, in
// one launch; tile ids are 32-bit and located with a float reciprocal.  A
// tile and its 3-px halo (38x70 values, 1.30 loads a pixel) are loaded into
// registers while the previous tile is scored: thread t takes column t % 64
// at every fourth row, so an interior tile needs one pointer and no
// REFLECT_101 arithmetic.  The values are staged once, into two shared
// buffers (one barrier a tile): as floats and as 16-bit halves of vertical
// pairs (rows r, r + 1).  Each thread scores a strip of 8 pixels down one
// column from registers.  `__syncthreads_and` decides per tile whether every
// staged value is an integer in [0, 255] (every level of the main path is).
// Then the packed branch scores two pixels with each min/max: 72 a pair,
// the score max(M - c, c - N) formed on the packed words (a bias of 256 a
// half keeps one 32-bit subtraction exact for both, then one max.s16x2),
// and one permute and one subtraction a pixel back to the exact float.
// Any other tile takes the f32 branch.  Both equal corner_score bit for
// bit.  No tensor cores: the work is min/max, not products.  The TPU
// workarounds (bf16 atlas, 8x128-aligned DMA tiles, 16-row reflect halo per
// level block of a level-major atlas) are gone: levels are read in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kTileX = 64;
constexpr int kTileY = 32;
constexpr int kHalo = 3;
constexpr int kStrip = 8;                       // pixels a thread, down a column
constexpr int kThreads = kTileX * (kTileY / kStrip);   // 256
constexpr int kRows = kTileY + 2 * kHalo;       // 38 staged rows
constexpr int kCols = kTileX + 2 * kHalo;       // 70 staged columns
constexpr int kMainLoads = (kRows + 3) / 4;     // 10: staged columns 0..63
constexpr int kLoads = kMainLoads + 1;          // + one of the 6 x 38 tail values

struct FastTable {
  const float* in[kMaxLevels];
  float* out[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tiles_per_frame[kMaxLevels];
  float inv_tiles_x[kMaxLevels];                // 1 / tiles_x, rounded
  float inv_tiles_per_frame[kMaxLevels];
  int tile_start[kMaxLevels + 1];
  int n_levels;
};

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  // only halo pixels of out-of-image outputs can fall outside after one
  // reflection; clamp them to stay in bounds (their scores are discarded)
  return min(max(i, 0), n - 1);
}

// a / b for 0 <= a < 2^24, 0 < b: the float quotient is within one of the
// true one, and one correction step makes it exact.
__device__ __forceinline__ int div_small(int a, int b, float inv_b) {
  int q = __float2int_rz(__fmul_rn(__int2float_rn(a), inv_b));
  const int r = a - q * b;
  q += r >= b ? 1 : 0;
  q -= r < 0 ? 1 : 0;
  return q;
}

// Two pixels' values as one packed u16x2 word; min/max of both halves in
// one instruction (Hopper's 16-bit SIMD min/max, VIMNMX.S16x2 in SASS).
__device__ __forceinline__ unsigned min_s16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("min.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned max_s16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

constexpr float kMagic = 8388608.0f;   // 2^23: ulp 1, so v + 2^23 = rint(v)
constexpr unsigned kMagicBits = 0x4B000000u;
constexpr unsigned kBias = 0x01000100u;         // 256 in each 16-bit half

// A packed score word holds (score + 256) in each half, in [1, 511]; the
// half (0: low, 1: high) back to the exact float score.
__device__ __forceinline__ float unpack_score(unsigned w, int half) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, kMagicBits, half ? 0x7632 : 0x7610)),
                   kMagic + 256.0f);
}

// min/max of two and of three values: f32 (two fminf for three), and
// packed pairs (the three-input form is Hopper's DPX VIMNMX3.S16x2).
struct FMin {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
  __device__ float operator()(float a, float b, float c) const { return fminf(fminf(a, b), c); }
};
struct FMax {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
  __device__ float operator()(float a, float b, float c) const { return fmaxf(fmaxf(a, b), c); }
};
struct PMin {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return min_s16x2(a, b); }
  __device__ unsigned operator()(unsigned a, unsigned b, unsigned c) const {
    return __vimin3_s16x2(a, b, c);
  }
};
struct PMax {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return max_s16x2(a, b); }
  __device__ unsigned operator()(unsigned a, unsigned b, unsigned c) const {
    return __vimax3_s16x2(a, b, c);
  }
};

// (lo, hi) = (min, max): max over the 16 circular 9-arcs of the arc
// minimum; (max, min): min over the arcs of the arc maximum.  OpenCV's
// cornerScore<16> form: the 8-window at each odd start 2i+1 is
// lo(q[i], q[i+2]) of 4-windows q, and its min with max(v[2i], v[2i+9]) is
// one three-input step, as is the max over the eight.  On packed pairs:
// 25 two-input and 11 three-input instructions (each 2- and 4-window
// serves two 8-windows, each 8-window one step); on floats, where a
// three-input step is two, 47.
template <typename T, typename Lo, typename Hi>
__device__ __forceinline__ T arc_extreme(const T (&v)[16], Lo lo, Hi hi) {
  T p[8], q[8], e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = lo(v[2 * i + 1], v[(2 * i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = lo(p[i], p[(i + 1) & 7]);     // v[2i+1 .. 2i+4]
#pragma unroll
  for (int i = 0; i < 8; ++i)                                      // arcs 2i, 2i+1
    e[i] = lo(q[i], q[(i + 2) & 7], hi(v[2 * i], v[(2 * i + 9) & 15]));
  return hi(hi(e[0], e[1], e[2]), hi(e[3], e[4], e[5]), hi(e[6], e[7]));
}

__device__ __forceinline__ float score(float m_bright, float n_dark, float c) {
  return fmaxf(__fsub_rn(m_bright, c), __fsub_rn(c, n_dark));
}

// One tile of the table: its level image and output, its size and origin.
struct Tile {
  const float* img;
  float* out;
  int h, w, y0, x0;
};

// Tile ``id`` of the table; ``lvl`` only moves forward, as ids do.
__device__ __forceinline__ Tile locate(const FastTable& t, int id, int& lvl) {
  while (lvl + 1 < t.n_levels && id >= t.tile_start[lvl + 1]) ++lvl;
  const int local = id - t.tile_start[lvl];
  const int frame = div_small(local, t.tiles_per_frame[lvl], t.inv_tiles_per_frame[lvl]);
  const int tile_id = local - frame * t.tiles_per_frame[lvl];
  const int ty = div_small(tile_id, t.tiles_x[lvl], t.inv_tiles_x[lvl]);
  Tile s;
  s.h = t.h[lvl];
  s.w = t.w[lvl];
  s.img = t.in[lvl] + static_cast<size_t>(frame) * s.h * s.w;
  s.out = t.out[lvl] + static_cast<size_t>(frame) * s.h * s.w;
  s.y0 = ty * kTileY;
  s.x0 = (tile_id - ty * t.tiles_x[lvl]) * kTileX;
  return s;
}

// Staged block (kRows x kCols, the tile and its 3-px halo): thread t loads
// staged column t % 64 at rows t / 64 + 4k (k < 10, row < 38), and threads
// t < 228 one value each of the 6 tail columns 64..69 (row t / 6).  The
// loads go into registers and stay in flight until ``stage`` stores them.
__device__ __forceinline__ void fetch(const Tile& s, float (&pre)[kLoads]) {
  const int c = threadIdx.x % kTileX;
  const int r0 = threadIdx.x / kTileX;
  const int tr = threadIdx.x / 6;
  const int tc = kTileX + threadIdx.x - 6 * tr;
  const bool tail = threadIdx.x < 6 * kRows;
  if (s.y0 >= kHalo && s.y0 + kRows - kHalo <= s.h && s.x0 >= kHalo &&
      s.x0 + kCols - kHalo <= s.w) {
    // no reflection: one pointer down the column
    const float* p = s.img + (s.y0 - kHalo + r0) * s.w + (s.x0 - kHalo + c);
#pragma unroll
    for (int k = 0; k < kMainLoads; ++k)
      if (r0 + 4 * k < kRows) pre[k] = __ldg(p + 4 * k * s.w);
    if (tail) pre[kMainLoads] = __ldg(s.img + (s.y0 - kHalo + tr) * s.w + (s.x0 - kHalo + tc));
  } else {
    const int x = reflect101(s.x0 - kHalo + c, s.w);
#pragma unroll
    for (int k = 0; k < kMainLoads; ++k)
      if (r0 + 4 * k < kRows)
        pre[k] = __ldg(s.img + reflect101(s.y0 - kHalo + r0 + 4 * k, s.h) * s.w + x);
    if (tail)
      pre[kMainLoads] = __ldg(s.img + reflect101(s.y0 - kHalo + tr, s.h) * s.w +
                              reflect101(s.x0 - kHalo + tc, s.w));
  }
}

// Store the fetched values: as floats into ``tile``, and as 16-bit halves
// into ``pair`` (pair[r][c] = (row r, row r + 1) of column c as u16x2, low
// half first).  Returns whether every value this thread staged is an
// integer in [0, 255]; only then are its halves the values.
__device__ __forceinline__ bool stage(const float (&pre)[kLoads], float (*tile)[kCols],
                                      unsigned (*pair)[kCols]) {
  unsigned short* half = reinterpret_cast<unsigned short*>(&pair[0][0]);
  bool bytes = true;
  auto put = [&](int r, int c, float v) {
    tile[r][c] = v;
    // v + 2^23 rounds v to an integer; it is v's byte iff the difference of
    // the bits is at most 255 and the rounding was exact
    const unsigned bits = __float_as_uint(__fadd_rn(v, kMagic));
    bytes &= (bits - kMagicBits <= 255u) & (__fsub_rn(__uint_as_float(bits), kMagic) == v);
    const unsigned short b = static_cast<unsigned short>(bits);
    if (r < kRows - 1) half[2 * (r * kCols + c)] = b;
    if (r > 0) half[2 * ((r - 1) * kCols + c) + 1] = b;
  };
  const int c = threadIdx.x % kTileX;
  const int r0 = threadIdx.x / kTileX;
#pragma unroll
  for (int k = 0; k < kMainLoads; ++k)
    if (r0 + 4 * k < kRows) put(r0 + 4 * k, c, pre[k]);
  if (threadIdx.x < 6 * kRows) {
    const int tr = threadIdx.x / 6;
    put(tr, kTileX + threadIdx.x - 6 * tr, pre[kMainLoads]);
  }
  return bytes;
}

__global__ void __launch_bounds__(kThreads, 2)
fast_score_kernel(const FastTable t) {
  // two buffers: a tile is staged while no thread still reads the buffer,
  // so one barrier a tile suffices
  __shared__ float tile[2][kRows][kCols];
  __shared__ unsigned pair[2][kRows - 1][kCols];

  // circle offsets in OpenCV order (index 0 at 12 o'clock, clockwise)
  constexpr int kDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int n_tiles = t.tile_start[t.n_levels];
  const int lx = threadIdx.x % kTileX;
  const int ly0 = (threadIdx.x / kTileX) * kStrip;
  int lvl = 0;
  int id = blockIdx.x;
  if (id >= n_tiles) return;
  Tile cur = locate(t, id, lvl);
  float pre[kLoads];
  fetch(cur, pre);
  for (int buf = 0; id < n_tiles; id += gridDim.x, buf ^= 1) {
    // every staged value an integer in [0, 255]: the packed branch
    const bool packed = __syncthreads_and(stage(pre, tile[buf], pair[buf]));
    // the next tile's loads fly while this one is scored
    const Tile s = cur;
    if (id + gridDim.x < n_tiles) {
      cur = locate(t, id + gridDim.x, lvl);
      fetch(cur, pre);
    }

    const int x = s.x0 + lx;
    if (x >= s.w || s.y0 + ly0 >= s.h) continue;
    float* out_col = s.out + x;
    if (packed) {
      // two halves of the strip, two vertical pairs of pixels (r, r + 1)
      // each; a half's window is pair rows r0 .. r0 + 8, columns lx .. lx + 6
      // (entries no pixel reads are never loaded)
#pragma unroll 1
      for (int r0 = ly0; r0 < ly0 + kStrip; r0 += kStrip / 2) {
        if (s.y0 + r0 >= s.h) break;
        unsigned win[kStrip / 2 + 2 * kHalo - 1][2 * kHalo + 1];
#pragma unroll
        for (int r = 0; r < kStrip / 2 + 2 * kHalo - 1; ++r)
#pragma unroll
          for (int c = 0; c < 2 * kHalo + 1; ++c) win[r][c] = pair[buf][r0 + r][lx + c];
#pragma unroll
        for (int p = 0; p < kStrip / 2; p += 2) {
          const int y = s.y0 + r0 + p;
          if (y >= s.h) break;
          unsigned v[16];
#pragma unroll
          for (int k = 0; k < 16; ++k) v[k] = win[p + kHalo + kDY[k]][kHalo + kDX[k]];
          const unsigned m = arc_extreme(v, PMin(), PMax());
          const unsigned n = arc_extreme(v, PMax(), PMin());
          // max(M - c, c - N) + 256 in each half: the bias keeps both
          // differences in [1, 511], so one 32-bit subtraction serves both
          // halves without a borrow crossing between them
          const unsigned c = win[p + kHalo][kHalo];
          const unsigned sc = max_s16x2((m | kBias) - c, (c | kBias) - n);
          out_col[y * s.w] = unpack_score(sc, 0);
          if (y + 1 < s.h) out_col[(y + 1) * s.w] = unpack_score(sc, 1);
        }
      }
    } else {
      // the strip's window: rows ly0 .. ly0 + 13, columns lx .. lx + 6
      float win[kStrip + 2 * kHalo][2 * kHalo + 1];
#pragma unroll
      for (int r = 0; r < kStrip + 2 * kHalo; ++r)
#pragma unroll
        for (int c = 0; c < 2 * kHalo + 1; ++c) win[r][c] = tile[buf][ly0 + r][lx + c];
#pragma unroll
      for (int p = 0; p < kStrip; ++p) {
        const int y = s.y0 + ly0 + p;
        if (y >= s.h) break;
        float v[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = win[p + kHalo + kDY[k]][kHalo + kDX[k]];
        out_col[y * s.w] = score(
            arc_extreme(v, FMin(), FMax()), arc_extreme(v, FMax(), FMin()),
            win[p + kHalo][kHalo]);
      }
    }
  }
}

}  // namespace

// in_ptrs/out_ptrs: n_levels device pointers to contiguous (batch, h, w)
// float32 tensors.  Returns cudaGetLastError() after the launch.
extern "C" int fast_score_levels(const void* in_ptrs, const void* out_ptrs,
                                 const void* hs, const void* ws, int n_levels,
                                 int batch, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || batch < 1) return cudaErrorInvalidValue;
  const float* const* in = static_cast<const float* const*>(in_ptrs);
  float* const* out = static_cast<float* const*>(out_ptrs);
  const int* h = static_cast<const int*>(hs);
  const int* w = static_cast<const int*>(ws);
  FastTable t = {};
  t.n_levels = n_levels;
  long long tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (h[l] < 4 || w[l] < 4) return cudaErrorInvalidValue;
    t.in[l] = in[l];
    t.out[l] = out[l];
    t.h[l] = h[l];
    t.w[l] = w[l];
    t.tiles_x[l] = (w[l] + kTileX - 1) / kTileX;
    t.tiles_per_frame[l] = t.tiles_x[l] * ((h[l] + kTileY - 1) / kTileY);
    t.inv_tiles_x[l] = 1.0f / static_cast<float>(t.tiles_x[l]);
    t.inv_tiles_per_frame[l] = 1.0f / static_cast<float>(t.tiles_per_frame[l]);
    t.tile_start[l] = static_cast<int>(tiles);
    tiles += static_cast<long long>(t.tiles_per_frame[l]) * batch;
    // tile ids (and a frame's pixel offsets) stay in 32-bit ints, ids
    // below 2^24 for div_small
    if (tiles >= (1 << 24) || static_cast<long long>(h[l]) * w[l] >= (1ll << 31))
      return cudaErrorInvalidValue;
  }
  t.tile_start[n_levels] = static_cast<int>(tiles);
  const int blocks = persistent_blocks(fast_score_kernel, kThreads, tiles);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  fast_score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
