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
//         x + rint(px*c - py*s)) for the orb_pattern offsets (px, py),
//         clamped to the padded image;
//   bit i = sample[i] < sample[256 + i].
// Inputs are the per-level images reflect-padded by 19 px (SAMPLE_PAD), so a
// keypoint's samples never leave its own padded image.  Pixel values are
// integers <= 255, so every partial sum of the moments is an integer below
// 2^24 and exact in f32 in any order; the angle arithmetic is written with
// explicit round-to-nearest intrinsics (and the file is built with
// -fmad=false) so that each product, sum, sqrt and quotient is rounded once,
// exactly as the plain PyTorch version ops/descriptors.descriptors_moments_plain
// rounds them.  Sample indices use __float2int_rn (round half to even, as
// torch.round / jnp.round), never roundf.  Bits, m10 and m01 equal the plain
// version's.
//
// What bounds it on the H100: per keypoint it needs the 749 raw disc pixels
// and 512 blurred samples (5.0 KB) and writes 264 bytes, against a few
// thousand instructions: at 720p, B = 24 (24,576 keypoint slots) 0.13 GB,
// 39 us at 3.35 TB/s, so device memory bounds it.  Within a keypoint the
// work is a chain of two dependent rounds of loads (the disc, then the
// samples the moments point to), so the design keeps many keypoints in
// flight and every load of a round issued at once.  The card moves 32-byte
// sectors: a disc row spans 4 to 5 and the samples about 220, some 12 KB a
// keypoint, more than the bound counts.
//
// Design: persistent warps, one keypoint at a time, no shared memory.  Each
// lane keeps its 16 pattern points (bits 8*lane .. 8*lane + 7, both points of
// each pair) in 32 registers, loaded once; a warp walks keypoints with a
// grid-wide stride.  Moments: lane j owns disc column dx = j - 15 and runs
// over the 31 rows with the loads unrolled (all in flight at once), each row
// one coalesced load of at most 31 floats masked to |dx| <= umax[|dy|]; the
// column sum and sum of dy*I stay in registers, and m10 = sum dx*colsum and
// m01 are reduced with __shfl_xor_sync.  Samples are gathered straight from
// the blurred level (the reach is at most 18 px, so L1 serves a keypoint's
// 512 samples), and each lane writes its 8 bits in one 8-byte store.
// Occupancy is set by registers alone.  The TPU workarounds (bf16 atlases,
// (8,128)-aligned patch DMAs with residual offsets, one-hot matmul sampling
// instead of gathers) are gone: a gather is a plain indexed load here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kWarps = 4;            // warps a block
constexpr int kPad = 19;             // SAMPLE_PAD of the padded level images
constexpr int kHalfPatch = 15;       // IC disc radius
constexpr int kDisc = 2 * kHalfPatch + 1;    // 31 rows and columns
constexpr int kBits = 8;             // descriptor bits a lane

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
  const int lane = threadIdx.x % 32;
  // this lane's pattern pairs: first points i, second points 256 + i
  float ax[kBits], ay[kBits], bx[kBits], by[kBits];
#pragma unroll
  for (int j = 0; j < kBits; ++j) {
    const int i = lane * kBits + j;
    ax[j] = __ldg(pattern + i);
    ay[j] = __ldg(pattern + 512 + i);
    bx[j] = __ldg(pattern + 256 + i);
    by[j] = __ldg(pattern + 512 + 256 + i);
  }
  // rows of the disc in this lane's column dx = lane - 15 (lane 31: none)
  const int dx = lane - kHalfPatch;
  unsigned rows = 0;
#pragma unroll
  for (int r = 0; r < kDisc; ++r) {
    const int ady = r < kHalfPatch ? kHalfPatch - r : r - kHalfPatch;
    if (lane < kDisc && abs(dx) <= t.umax[ady]) rows |= 1u << r;
  }

  const int warps = gridDim.x * kWarps;
  for (int k = blockIdx.x * kWarps + threadIdx.x / 32; k < n_kp; k += warps) {
    const int lvl = min(max(__ldg(kp_level + k), 0), t.n_levels - 1);
    const int hp = t.hp[lvl];
    const int wp = t.wp[lvl];
    // keypoint (y, x) in level coordinates sits at (y + 19, x + 19) of the
    // padded image; clamp so a bad coordinate cannot read out of bounds
    const int y = min(max(__ldg(kp_y + k), 0), hp - 2 * kPad - 1);
    const int x = min(max(__ldg(kp_x + k), 0), wp - 2 * kPad - 1);
    const size_t frame_off = static_cast<size_t>(__ldg(kp_frame + k)) * hp * wp;
    const float* blur = t.blur[lvl] + frame_off;
    const float* raw = t.raw[lvl] + frame_off;

    // --- IC moments: lane owns column dx, rows dy = -15 .. 15 ---
    const float* col = raw + static_cast<size_t>(y + kPad - kHalfPatch) * wp +
                       (x + kPad + dx);
    float v[kDisc];
#pragma unroll
    for (int r = 0; r < kDisc; ++r)
      v[r] = (rows >> r) & 1u ? __ldg(col + static_cast<size_t>(r) * wp) : 0.0f;
    float colsum = 0.0f, colmom = 0.0f;
#pragma unroll
    for (int r = 0; r < kDisc; ++r) {
      colsum = __fadd_rn(colsum, v[r]);
      colmom = __fadd_rn(colmom, __fmul_rn(static_cast<float>(r - kHalfPatch), v[r]));
    }
    float m10 = __fmul_rn(static_cast<float>(dx), colsum);
    float m01 = colmom;
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

    // --- 16 rotated samples → 8 bits, clamped to the padded image ---
    const int cy = y + kPad;
    const int cx = x + kPad;
    auto sample = [&](float px, float py) {
      const float fc = __fsub_rn(__fmul_rn(px, cs), __fmul_rn(py, sn));
      const float fr = __fadd_rn(__fmul_rn(px, sn), __fmul_rn(py, cs));
      const int r = min(max(cy + __float2int_rn(fr), 0), hp - 1);
      const int c = min(max(cx + __float2int_rn(fc), 0), wp - 1);
      return __ldg(blur + static_cast<size_t>(r) * wp + c);
    };
    unsigned long long word = 0;
#pragma unroll
    for (int j = 0; j < kBits; ++j)
      word |= static_cast<unsigned long long>(sample(ax[j], ay[j]) < sample(bx[j], by[j]))
              << (8 * j);
    reinterpret_cast<unsigned long long*>(bits + static_cast<size_t>(k) * 256)[lane] = word;
    if (lane == 0) {
      m10_out[k] = m10;
      m01_out[k] = m01;
    }
  }
}

}  // namespace

// blur_ptrs/raw_ptrs: n_levels device pointers to contiguous (batch, hp, wp)
// float32 padded level images; hps/wps: their padded sizes; umax: 16 ints.
// Keypoint arrays are int32 (n_kp,), pattern is float32 (1024,) on device;
// bits must be 8-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int orb_desc_moments(const void* blur_ptrs, const void* raw_ptrs,
                                const void* hps, const void* wps,
                                const void* umax, int n_levels,
                                const void* kp_level, const void* kp_frame,
                                const void* kp_y, const void* kp_x, int n_kp,
                                const void* pattern, void* bits, void* m10,
                                void* m01, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_kp < 0) return cudaErrorInvalidValue;
  if (n_kp == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(bits) % 8 != 0) return cudaErrorMisalignedAddress;
  DescTable t = {};
  t.n_levels = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    t.blur[l] = static_cast<const float* const*>(blur_ptrs)[l];
    t.raw[l] = static_cast<const float* const*>(raw_ptrs)[l];
    t.hp[l] = static_cast<const int*>(hps)[l];
    t.wp[l] = static_cast<const int*>(wps)[l];
    if (t.hp[l] < 2 * kPad + 1 || t.wp[l] < 2 * kPad + 1) return cudaErrorInvalidValue;
  }
  for (int i = 0; i <= kHalfPatch; ++i) t.umax[i] = static_cast<const int*>(umax)[i];
  // persistent grid: as many blocks as fit on the SMs, at most one a keypoint
  const int blocks = persistent_blocks(orb_desc_moments_kernel, kWarps * 32,
                                       (static_cast<long long>(n_kp) + kWarps - 1) / kWarps);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  orb_desc_moments_kernel<<<blocks, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const int*>(kp_level), static_cast<const int*>(kp_frame),
      static_cast<const int*>(kp_y), static_cast<const int*>(kp_x),
      static_cast<const float*>(pattern), n_kp, static_cast<uint8_t*>(bits),
      static_cast<float*>(m10), static_cast<float*>(m01));
  return static_cast<int>(cudaGetLastError());
}
