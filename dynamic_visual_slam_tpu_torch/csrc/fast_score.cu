// FAST-9/16 corner score of every pixel of every pyramid level of a batch of
// frames, in ONE launch (kernel B1 of the port).
//
// Replaces: dynamic_visual_slam_tpu/ops/fields.py `_score_atlas_rows` (the
// Pallas kernel reached through `fast_score_atlas_batch`), whose body is
// ops/fast.py `_score_block`.
//
// What it computes: for each pixel p of each (frame, level) image,
//   score(p) = max( max_k min_{i in arc k} (v_i - p),  max_k min_{i in arc k} (p - v_i) )
// over the 16 circular 9-arcs of the radius-3 Bresenham circle, with the
// image border scored against REFLECT_101 pixels (== jnp.pad(mode="reflect")
// of 3 px, as in ops/fast.corner_score).  min, max and the differences of
// integer-valued floats are exact, so the result is bit-identical to the
// plain PyTorch version dynamic_visual_slam_tpu_torch/ops/fast.corner_score.
//
// What bounds it on the H100: per pixel ~16 subtractions + 2 x 64 min/max
// for the log-step 9-window reductions + 2 x 15 for the max over arcs,
// ~175 f32 operations, against 8 bytes of device memory (one f32 read, one
// f32 written).  At 720p, B=24, 8 levels (68.5 M px) that is ~12 G operations
// (~0.36 ms at one f32 instruction per lane per clock: 132 SMs x 128 lanes x
// 1.98 GHz = 33.5e12/s, half the 67 TFLOP/s that counts an FMA as two)
// versus 0.55 GB (~0.16 ms at 3.35 TB/s): the ALU side bounds it.
//
// Design: one block per 32x16 output tile of one (level, frame) image; the
// block index walks a by-value table of levels (prefix sums of tile counts),
// so all B x 8 levels are one grid and one launch.  The tile and its 3-px
// halo are staged once in shared memory (each input pixel is read from
// device memory about 1.5 times instead of 17), and each thread scores two
// pixels entirely in registers with the same log-step min/max tree as the
// TPU kernel.  No tensor cores: the work is min/max, not products.
// The TPU workarounds (bf16 atlas, 8x128-aligned DMA tiles, 16-row reflect
// halo per level block of a level-major atlas) are gone: levels are read in
// place and the reflect border is an index computation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kTileX = 32;
constexpr int kTileY = 16;
constexpr int kHalo = 3;
constexpr int kThreads = 256;

struct FastTable {
  const float* in[kMaxLevels];
  float* out[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tiles_per_frame[kMaxLevels];
  long long block_start[kMaxLevels + 1];
  int n_levels;
};

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  // only halo pixels of out-of-image outputs can fall outside after one
  // reflection; clamp them to stay in bounds (their scores are discarded)
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
fast_score_kernel(const FastTable t) {
  __shared__ float tile[kTileY + 2 * kHalo][kTileX + 2 * kHalo + 1];

  const long long b = blockIdx.x;
  int lvl = 0;
  while (lvl + 1 < t.n_levels && b >= t.block_start[lvl + 1]) ++lvl;
  const long long local = b - t.block_start[lvl];
  const int frame = static_cast<int>(local / t.tiles_per_frame[lvl]);
  const int tile_id = static_cast<int>(local % t.tiles_per_frame[lvl]);
  const int y0 = (tile_id / t.tiles_x[lvl]) * kTileY;
  const int x0 = (tile_id % t.tiles_x[lvl]) * kTileX;
  const int H = t.h[lvl];
  const int W = t.w[lvl];
  const float* img = t.in[lvl] + static_cast<size_t>(frame) * H * W;
  float* out = t.out[lvl] + static_cast<size_t>(frame) * H * W;

  constexpr int kRows = kTileY + 2 * kHalo;
  constexpr int kCols = kTileX + 2 * kHalo;
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols;
    const int c = i - r * kCols;
    const int y = reflect101(y0 + r - kHalo, H);
    const int x = reflect101(x0 + c - kHalo, W);
    tile[r][c] = __ldg(img + static_cast<size_t>(y) * W + x);
  }
  __syncthreads();

  const int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int lx = threadIdx.x % kTileX;
  for (int ly = threadIdx.x / kTileX; ly < kTileY; ly += kThreads / kTileX) {
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y >= H || x >= W) continue;
    const float c = tile[ly + kHalo][lx + kHalo];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = tile[ly + kHalo + DY[k]][lx + kHalo + DX[k]] - c;

    float p[16], q[16], o[16];
    // bright: max over arcs of the arc minimum of (v - p)
#pragma unroll
    for (int k = 0; k < 16; ++k) p[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) q[k] = fminf(p[k], p[(k + 2) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) o[k] = fminf(q[k], q[(k + 4) & 15]);
    float bright = fminf(o[0], d[8]);
#pragma unroll
    for (int k = 1; k < 16; ++k) bright = fmaxf(bright, fminf(o[k], d[(k + 8) & 15]));
    // dark: max_k min(p - v) = -(min over arcs of the arc maximum of (v - p))
#pragma unroll
    for (int k = 0; k < 16; ++k) p[k] = fmaxf(d[k], d[(k + 1) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) q[k] = fmaxf(p[k], p[(k + 2) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) o[k] = fmaxf(q[k], q[(k + 4) & 15]);
    float dark_neg = fmaxf(o[0], d[8]);
#pragma unroll
    for (int k = 1; k < 16; ++k) dark_neg = fminf(dark_neg, fmaxf(o[k], d[(k + 8) & 15]));
    out[static_cast<size_t>(y) * W + x] = fmaxf(bright, -dark_neg);
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
  long long blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (h[l] < 4 || w[l] < 4) return cudaErrorInvalidValue;
    t.in[l] = in[l];
    t.out[l] = out[l];
    t.h[l] = h[l];
    t.w[l] = w[l];
    t.tiles_x[l] = (w[l] + kTileX - 1) / kTileX;
    t.tiles_per_frame[l] = t.tiles_x[l] * ((h[l] + kTileY - 1) / kTileY);
    t.block_start[l] = blocks;
    blocks += static_cast<long long>(t.tiles_per_frame[l]) * batch;
  }
  t.block_start[n_levels] = blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fast_score_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
