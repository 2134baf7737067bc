// Intensity-centroid moments + rotated-BRIEF descriptor bits per keypoint
// (kernel B2 of the port).
//
// Replaces: dynamic_visual_slam_tpu/ops/descriptors.py
// `descriptors_moments_pallas` (Pallas kernel `_kernel_with_moments`).
//
// What it computes, per keypoint k at (level, frame, y, x):
//   m10 = sum u*I, m01 = sum v*I over the radius-15 disc |u| <= umax[|v|]
//         of the RAW level (frontend/orb.ic_umax);
//   c = m10 / sqrt(n2), s = m01 / sqrt(n2), n2 = m10^2 + m01^2  (c=1, s=0
//         when n2 == 0);
//   512 samples of the BLURRED level at (y + rint(px*s + py*c),
//         x + rint(px*c - py*s)) for the orb_pattern offsets (px, py);
//   bit i = sample[i] < sample[256 + i].
// Inputs are the per-level images reflect-padded by 19 px (SAMPLE_PAD), so a
// keypoint's samples never leave its own padded image.  Pixel values are
// integers <= 255, so every partial sum of the moments is an integer below
// 2^24 and exact in f32 in any order; the angle arithmetic is written with
// explicit round-to-nearest intrinsics (and the file is built with
// -fmad=false) so that each product, sum, sqrt and quotient is rounded once,
// exactly as the plain PyTorch version ops/descriptors.descriptors_moments_plain
// rounds them.  Sample indices use __float2int_rn (round half to even, as
// torch.round / jnp.round), never roundf.
//
// What bounds it on the H100: per keypoint it needs ~3.8 KB of raw disc and
// 2 KB of blurred samples and writes 264 bytes; at 720p, B=24 (24,576
// keypoints) that is ~0.15 GB, ~45 us at 3.35 TB/s.  The work per keypoint is
// small and its loads are scattered, so in practice it is bound by load
// latency, not by bandwidth or arithmetic.
//
// Design: one warp per keypoint, four warps per block.  The warp stages the
// 31x31 raw disc window and the 39x39 blurred window (+-19 px covers the
// largest rotated offset, 18.4 px) in shared memory with lane-strided loads,
// then lane v sums row v-15 of the disc (row sum and first moment) and the
// moments are combined with warp shuffles; each lane then computes 16 of the
// 512 rotated samples from shared memory and writes 8 bits.  The TPU
// workarounds (bf16 atlases, (8,128)-aligned patch DMAs with residual
// offsets, one-hot matmul sampling instead of gathers) are gone: a gather is
// a plain indexed load here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kWarps = 4;
constexpr int kPad = 19;             // SAMPLE_PAD of the padded level images
constexpr int kHalfPatch = 15;       // IC disc radius
constexpr int kBlurW = 2 * kPad + 1;         // 39
constexpr int kRawW = 2 * kHalfPatch + 1;    // 31

struct DescTable {
  const float* blur[kMaxLevels];
  const float* raw[kMaxLevels];
  int hp[kMaxLevels];
  int wp[kMaxLevels];
  int umax[kHalfPatch + 1];
  int n_levels;
};

__global__ void __launch_bounds__(kWarps * 32)
orb_desc_moments_kernel(const DescTable t, const int* __restrict__ kp_level,
                        const int* __restrict__ kp_frame,
                        const int* __restrict__ kp_y,
                        const int* __restrict__ kp_x,
                        const float* __restrict__ pattern,  // px[512], py[512]
                        int n_kp, uint8_t* __restrict__ bits,
                        float* __restrict__ m10_out,
                        float* __restrict__ m01_out) {
  __shared__ float s_blur[kWarps][kBlurW][kBlurW];
  __shared__ float s_raw[kWarps][kRawW][kRawW];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= n_kp) return;   // whole warp leaves together; only __syncwarp below

  const int lvl = min(max(kp_level[k], 0), t.n_levels - 1);
  const int hp = t.hp[lvl];
  const int wp = t.wp[lvl];
  // keypoint (y, x) in level coordinates sits at (y + 19, x + 19) of the
  // padded image; clamp so a bad coordinate cannot read out of bounds
  const int y = min(max(kp_y[k], 0), hp - kBlurW);
  const int x = min(max(kp_x[k], 0), wp - kBlurW);
  const size_t frame_off = static_cast<size_t>(kp_frame[k]) * hp * wp;
  const float* blur = t.blur[lvl] + frame_off;
  const float* raw = t.raw[lvl] + frame_off;

  for (int i = lane; i < kBlurW * kBlurW; i += 32) {
    const int r = i / kBlurW;
    const int c = i - r * kBlurW;
    s_blur[warp][r][c] = __ldg(blur + static_cast<size_t>(y + r) * wp + x + c);
  }
  const int off = kPad - kHalfPatch;   // raw disc window starts 4 px in
  for (int i = lane; i < kRawW * kRawW; i += 32) {
    const int r = i / kRawW;
    const int c = i - r * kRawW;
    s_raw[warp][r][c] =
        __ldg(raw + static_cast<size_t>(y + off + r) * wp + x + off + c);
  }
  __syncwarp();

  // --- IC moments: lane v sums disc row dy = v - 15 ---
  float m10 = 0.0f, m01 = 0.0f;
  if (lane < kRawW) {
    const int dy = lane - kHalfPatch;
    const int u = t.umax[dy < 0 ? -dy : dy];
    float row_sum = 0.0f, row_moment = 0.0f;
    for (int dx = -u; dx <= u; ++dx) {
      const float v = s_raw[warp][lane][dx + kHalfPatch];
      row_sum = __fadd_rn(row_sum, v);
      row_moment = __fadd_rn(row_moment, __fmul_rn(static_cast<float>(dx), v));
    }
    m01 = __fmul_rn(static_cast<float>(dy), row_sum);
    m10 = row_moment;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(0xffffffffu, m10, o));
    m01 = __fadd_rn(m01, __shfl_xor_sync(0xffffffffu, m01, o));
  }

  // --- orientation: c = m10/|m|, s = m01/|m| (n2 > 0 guard) ---
  const float n2 = __fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01));
  float cs = 1.0f, sn = 0.0f;
  if (n2 > 0.0f) {
    const float nrm = __fsqrt_rn(n2);
    cs = __fdiv_rn(m10, nrm);
    sn = __fdiv_rn(m01, nrm);
  }

  // --- 512 rotated samples → 256 bits; lane handles bits 8*lane .. +7 ---
  uint8_t* out = bits + static_cast<size_t>(k) * 256 + lane * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = h * 256 + lane * 8 + j;
      const float px = __ldg(pattern + i);
      const float py = __ldg(pattern + 512 + i);
      const float fc = __fsub_rn(__fmul_rn(px, cs), __fmul_rn(py, sn));
      const float fr = __fadd_rn(__fmul_rn(px, sn), __fmul_rn(py, cs));
      const int col = min(max(__float2int_rn(fc) + kPad, 0), kBlurW - 1);
      const int row = min(max(__float2int_rn(fr) + kPad, 0), kBlurW - 1);
      s2[h] = s_blur[warp][row][col];
    }
    out[j] = s2[0] < s2[1] ? 1 : 0;
  }
  if (lane == 0) {
    m10_out[k] = m10;
    m01_out[k] = m01;
  }
}

}  // namespace

// blur_ptrs/raw_ptrs: n_levels device pointers to contiguous (batch, hp, wp)
// float32 padded level images; hps/wps: their padded sizes; umax: 16 ints.
// Keypoint arrays are int32 (n_kp,), pattern is float32 (1024,) on device.
// Returns cudaGetLastError() after the launch.
extern "C" int orb_desc_moments(const void* blur_ptrs, const void* raw_ptrs,
                                const void* hps, const void* wps,
                                const void* umax, int n_levels,
                                const void* kp_level, const void* kp_frame,
                                const void* kp_y, const void* kp_x, int n_kp,
                                const void* pattern, void* bits, void* m10,
                                void* m01, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_kp < 0) return cudaErrorInvalidValue;
  if (n_kp == 0) return cudaSuccess;
  DescTable t = {};
  t.n_levels = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    t.blur[l] = static_cast<const float* const*>(blur_ptrs)[l];
    t.raw[l] = static_cast<const float* const*>(raw_ptrs)[l];
    t.hp[l] = static_cast<const int*>(hps)[l];
    t.wp[l] = static_cast<const int*>(wps)[l];
    if (t.hp[l] < kBlurW || t.wp[l] < kBlurW) return cudaErrorInvalidValue;
  }
  for (int i = 0; i <= kHalfPatch; ++i) t.umax[i] = static_cast<const int*>(umax)[i];
  const unsigned blocks = static_cast<unsigned>((n_kp + kWarps - 1) / kWarps);
  orb_desc_moments_kernel<<<blocks, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const int*>(kp_level), static_cast<const int*>(kp_frame),
      static_cast<const int*>(kp_y), static_cast<const int*>(kp_x),
      static_cast<const float*>(pattern), n_kp, static_cast<uint8_t*>(bits),
      static_cast<float*>(m10), static_cast<float*>(m01));
  return static_cast<int>(cudaGetLastError());
}
