// PnP RANSAC, one problem a block: the body of frontend/ransac.py's
// pnp_ransac (the tracker's frame-to-frame and anchored PnP, the loop and
// relocalization checks) as one launch.
//
// Replaces: no Pallas kernel.  The JAX package's frontend/ransac.py
// pnp_ransac is plain jnp, which XLA fuses into a few programs; the port's
// plain version (ransac.pnp_ransac_plain) is a fixed chain of some 4,400
// tiny PyTorch operations a call, whatever its batch, each launched from
// the host.  That chain, not the device, set every path's pace: the card
// idled 93 to 96 % of each benchmark cell.  This kernel exists to run it
// as one launch.
//
// What it computes, per problem (leading dims flattened to B problems):
//   the valid points compacted in stable order (containers.stable_partition);
//   n_hyp DLT poses from the drawn 6-point samples (_dlt_pose: the 12 x 12
//   Gram, 8 normalised squarings, two inverse-iteration Gauss-Jordan solves,
//   the depth-sign flip, svd3x3, Procrustes), then the prior and identity
//   when a prior is given; each hypothesis's inliers over the K slots
//   (reprojection error < threshold and mask); the first best; two
//   Gauss-Newton passes of refine_iters steps on the best's inliers, then on
//   the refined pose's; the final inliers and the keep rule.
//
// Rounding: the same formulas in the same order as the plain version run
// by PyTorch on this card, so that the results are the plain version's bit
// for bit.  The file is built with -fmad=false, so a product and a sum round
// apart unless written as __fmaf_rn, which stands where PyTorch's CUDA
// kernels fuse (measured against the card's PyTorch):
//   - cuBLAS's small float32 products are one FMA chain over k from k = 0
//     (x R^T, the 12 x 12 Gram and squarings, the 3 x 3 products, the
//     Jacobian's 2 x 3 by 3 x 3); a product with one column (matrix times
//     vector, and the depths) sums two chains over the halves of k;
//   - a reduction along a tensor's fastest dimension (n values) runs on
//     lanes of width w = the largest power of two <= n (at most 32; n/4
//     with vector loads of 4 for n > 128), lane l taking values l, l + w,
//     ... into four accumulators added in order, then a halving tree; the
//     2-norm accumulates x * x as one FMA; a reduction along another
//     dimension (a column's norm) runs in one thread, four accumulators;
//   - linalg.cross is a * b - c * d as fma(a, b, -(c * d));
//   - dividing by a Python scalar multiplies by its reciprocal, rounded from
//     double to float (inv_fx, inv_fy from the wrapper; 1/3, 1/6, 1/48).
// The Gauss-Newton normal equations are summed in float64 and rounded once
// to float32 (as the plain version does, so the order of the float64 sum
// does not show).  Every clamp lets NaN through, as torch.clamp does.
// Measured bit-equal on the card at the tracker's and verify_loop's shapes,
// degenerate inputs included.  One exception: with a single hypothesis in
// the whole call (B x n_hyp = 1) cuBLAS runs the DLT's products unbatched,
// in another order, and the pose can differ in its last bits; no caller
// draws fewer than 192.  A sample index outside [0, K) traps, as the
// plain version's gather asserts.
//
// What bounds it on the H100: neither bytes nor operations.  A problem
// reads its K points (20 bytes each) a few dozen times from L1 and does
// about 10 MFLOP (194 DLT solves of ~20 kFLOP, 194 x K reprojections,
// 20 Gauss-Newton steps over K points), 2 us of the card's float32 rate at
// B = 24; the chain of dependent steps inside one block (8 squarings and 24
// pivots a DLT, 20 block-wide reductions and 6 x 6 solves) sets its time.
// Design: one block of 512 threads a problem.  Each warp solves one DLT at
// a time with its 12 x 12 matrices in shared memory (a lane owns 4 or 5
// entries); scoring keeps a thread's points in registers and walks the
// hypotheses, counting inliers by warp ballot into shared counters; each
// Gauss-Newton step reduces the 28 float64 entries of [J|r]'s Gram over the
// block, then one warp solves the damped 6 x 6 and one lane updates the
// pose.  Points, the compaction order and the hypotheses stay in device
// memory (L1/L2-resident); beside the fixed 46 KB, shared memory holds two
// bit masks of K bits and a counter a hypothesis, so only K beyond some
// 700,000 or n_hyp beyond 46,000 (which the wrapper refuses) would not fit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kN = 12;                 // DLT unknowns
constexpr int kMat = kN * kN;
constexpr int kAug = kN * (kN + 1);
constexpr int kG = 28;                 // upper triangle of the 7 x 7 Gram

struct Params {
  const float* xyz;          // (B, K, 3)
  const float* uv;           // (B, K, 2)
  const uint8_t* mask;       // (B, K)
  const int64_t* samples;    // (B, n_hyp, 6)
  const float* prior_q;      // (B, 4) or null
  const float* prior_t;      // (B, 3) or null
  int* perm;                 // scratch (B, K)
  float* hyp;                // scratch (B, n_hyp + 2, 12): R row-major, t
  float* q_out;              // (B, 4)
  float* t_out;              // (B, 3)
  uint8_t* inl_out;          // (B, K)
  int64_t* n_out;            // (B,)
  uint8_t* valid_out;        // (B,)
  int K, n_hyp, refine_iters, min_inliers;
  float fx, fy, cx, cy, inv_fx, inv_fy, threshold;
};

// ---------------------------------------------------------------------------
// elementwise helpers, in PyTorch's rounding

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}

__device__ __forceinline__ float clamp_pm1(float v) {
  return isnan(v) ? v : (v < -1.f ? -1.f : (v > 1.f ? 1.f : v));
}

__device__ __forceinline__ float sign_of(float v) {
  return (float)(0.f < v) - (float)(v < 0.f);
}

// a * b - c * d as linalg.cross's kernel contracts it
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return __fmaf_rn(a, b, -(c * d));
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = cross_term(a[1], b[2], a[2], b[1]);
  o[1] = cross_term(a[2], b[0], a[0], b[2]);
  o[2] = cross_term(a[0], b[1], a[1], b[0]);
}

// cuBLAS's dot of a small product: one FMA chain over k = 0 .. n-1
__device__ __forceinline__ float dot_chain(const float* a, int sa,
                                           const float* b, int sb, int n) {
  float acc = a[0] * b[0];
  for (int k = 1; k < n; ++k) acc = __fmaf_rn(a[k * sa], b[k * sb], acc);
  return acc;
}

// cuBLAS's product with one column: two chains over the halves of k
__device__ __forceinline__ float dot_halves(const float* a, int sa,
                                            const float* b, int sb, int n) {
  const int h = (n + 1) / 2;
  return dot_chain(a, sa, b, sb, h) +
         dot_chain(a + h * sa, sa, b + h * sb, sb, n - h);
}

// PyTorch's reduction of N values: W lanes (values l, l + W, ... into four
// accumulators, added in order), then a halving tree.  W = 1 is one thread.
// SQ: the 2-norm's accumulate (acc + x * x, one FMA), before the sqrt.
template <int N, int W, bool SQ>
__device__ __forceinline__ float torch_reduce(const float* x, int stride) {
  float lane[W];
#pragma unroll
  for (int l = 0; l < W; ++l) {
    float slot[4] = {0.f, 0.f, 0.f, 0.f};
    int idx = l;
    while (idx + 3 * W < N) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = x[(idx + i * W) * stride];
        slot[i] = SQ ? __fmaf_rn(v, v, slot[i]) : slot[i] + v;
      }
      idx += 4 * W;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (idx < N) {
        const float v = x[idx * stride];
        slot[i] = SQ ? __fmaf_rn(v, v, slot[i]) : slot[i] + v;
      }
      idx += W;
    }
    lane[l] = ((slot[0] + slot[1]) + slot[2]) + slot[3];
  }
#pragma unroll
  for (int off = W / 2; off >= 1; off /= 2) {
#pragma unroll
    for (int l = 0; l < off; ++l) lane[l] = lane[l] + lane[l + off];
  }
  return lane[0];
}

// the lane width of a fastest-dimension reduction of n <= 128 values
template <int N>
struct RowW {
  static constexpr int v = N >= 32 ? 32 : N >= 16 ? 16 : N >= 8 ? 8
                           : N >= 4 ? 4 : N >= 2 ? 2 : 1;
};

template <int N>
__device__ __forceinline__ float row_sum(const float* x, int stride) {
  return torch_reduce<N, RowW<N>::v, false>(x, stride);
}

template <int N>
__device__ __forceinline__ float row_norm(const float* x, int stride) {
  return sqrtf(torch_reduce<N, RowW<N>::v, true>(x, stride));
}

// a column's 2-norm (the reduced dimension is not the fastest)
__device__ __forceinline__ float col_norm3(const float* x, int stride) {
  return sqrtf(torch_reduce<3, 1, true>(x, stride));
}

// torch.argmax: the first NaN, else the first largest
template <int N>
__device__ __forceinline__ int argmax_first(const float* v) {
  int best = 0;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    const bool take = isnan(v[best]) ? false
                      : (isnan(v[i]) || v[i] > v[best]);
    if (take) best = i;
  }
  return best;
}

__device__ __forceinline__ float det3(const float* m) {
  return (m[0] * (m[4] * m[8] - m[5] * m[7])
          - m[1] * (m[3] * m[8] - m[5] * m[6]))
         + m[2] * (m[3] * m[7] - m[4] * m[6]);
}

// o = a @ b for 3 x 3 row-major (cuBLAS's chain)
__device__ __forceinline__ void mm3(const float* a, const float* b,
                                    float* o) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) o[i * 3 + j] = dot_chain(a + i * 3, 1, b + j, 3, 3);
}

// ---------------------------------------------------------------------------
// core/lie.py

__device__ __forceinline__ void quat_normalize(float* q) {
  const float n = clamp_min(row_norm<4>(q, 1), (float)1e-12);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
  const float s = q[0] < 0.f ? -1.f : 1.f;
  for (int i = 0; i < 4; ++i) q[i] = q[i] * s;
}

__device__ __forceinline__ void quat_mul(const float* a, const float* b,
                                         float* o) {
  o[0] = ((a[0] * b[0] - a[1] * b[1]) - a[2] * b[2]) - a[3] * b[3];
  o[1] = ((a[0] * b[1] + a[1] * b[0]) + a[2] * b[3]) - a[3] * b[2];
  o[2] = ((a[0] * b[2] - a[1] * b[3]) + a[2] * b[0]) + a[3] * b[1];
  o[3] = ((a[0] * b[3] + a[1] * b[2]) - a[2] * b[1]) + a[3] * b[0];
}

__device__ __forceinline__ void quat_to_mat(const float* q, float* m) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  m[0] = 1.f - 2.f * (yy + zz);
  m[1] = 2.f * (xy - wz);
  m[2] = 2.f * (xz + wy);
  m[3] = 2.f * (xy + wz);
  m[4] = 1.f - 2.f * (xx + zz);
  m[5] = 2.f * (yz - wx);
  m[6] = 2.f * (xz - wy);
  m[7] = 2.f * (yz + wx);
  m[8] = 1.f - 2.f * (xx + yy);
}

__device__ __forceinline__ void mat_to_quat(const float* m, float* q) {
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = (m00 + m11) + m22;
  const float cand[4][4] = {
      {1.f + tr, m21 - m12, m02 - m20, m10 - m01},
      {m21 - m12, ((1.f + m00) - m11) - m22, m01 + m10, m02 + m20},
      {m02 - m20, m01 + m10, ((1.f - m00) + m11) - m22, m12 + m21},
      {m10 - m01, m02 + m20, m12 + m21, ((1.f - m00) - m11) + m22}};
  const float piv[4] = {tr, m00, m11, m22};
  const int k = argmax_first<4>(piv);
  for (int i = 0; i < 4; ++i) q[i] = cand[k][i];
  quat_normalize(q);
}

// so3_exp of phi (3) → q (4)
__device__ __forceinline__ void so3_exp(const float* phi, float* q) {
  const float theta = row_norm<3>(phi, 1);
  const float half = 0.5f * theta;
  const float k = theta < (float)1e-8
                      ? 0.5f - (theta * theta) * (1.f / 48.f)
                      : sinf(half) / clamp_min(theta, (float)1e-20);
  q[0] = cosf(half);
  for (int i = 0; i < 3; ++i) q[1 + i] = k * phi[i];
  quat_normalize(q);
}

// quat_rotate(q, v) → o
__device__ __forceinline__ void quat_rotate(const float* q, const float* v,
                                            float* o) {
  float c[3], tt[3], c2[3];
  cross3(q + 1, v, c);
  for (int i = 0; i < 3; ++i) tt[i] = 2.f * c[i];
  cross3(q + 1, tt, c2);
  for (int i = 0; i < 3; ++i) o[i] = (v[i] + q[0] * tt[i]) + c2[i];
}

// ---------------------------------------------------------------------------
// ops/linalg_small.py: eigh3x3, svd3x3 (one thread)

__device__ void eigvec3(const float* a, float ev, float* out) {
  float m[9];
  for (int i = 0; i < 9; ++i)
    m[i] = a[i] - ev * ((i % 4 == 0) ? 1.f : 0.f);
  float c[3][3];
  cross3(m + 0, m + 3, c[0]);
  cross3(m + 0, m + 6, c[1]);
  cross3(m + 3, m + 6, c[2]);
  float norms[3];
  for (int k = 0; k < 3; ++k) {
    float sq[3];
    for (int i = 0; i < 3; ++i) sq[i] = c[k][i] * c[k][i];
    norms[k] = row_sum<3>(sq, 1);
  }
  const int best = argmax_first<3>(norms);
  const float nrm = row_norm<3>(c[best], 1);
  const float d = clamp_min(nrm, (float)1e-30);
  for (int i = 0; i < 3; ++i)
    out[i] = nrm > (float)1e-20 ? c[best][i] / d : (i == 0 ? 1.f : 0.f);
}

// symmetric a (3 x 3) → eigenvalues ascending, eigenvectors as columns
__device__ void eigh3(const float* a, float* vals, float* vecs) {
  const float q = row_sum<3>(a, 4) * (1.f / 3.f);
  float b[9], bb[9];
  for (int i = 0; i < 9; ++i) b[i] = a[i] - q * ((i % 4 == 0) ? 1.f : 0.f);
  for (int i = 0; i < 9; ++i) bb[i] = b[i] * b[i];
  const float p2 = row_sum<9>(bb, 1) * (1.f / 6.f);
  const float p = sqrtf(clamp_min(p2, (float)1e-30));
  const float detb = det3(b);
  const float pc = clamp_min(p, (float)1e-30);
  const float r = clamp_pm1(detb / (2.f * ((pc * pc) * pc)));
  const float phi = acosf(r) * (1.f / 3.f);
  const float e1 = q + (2.f * p) * cosf(phi);
  const float e3 = q + (2.f * p) * cosf(phi + (float)2.0943951023931953);
  const float e2 = ((3.f * q) - e1) - e3;
  vals[0] = e3;
  vals[1] = e2;
  vals[2] = e1;
  float v1[3], v2[3], v3[3];
  eigvec3(a, e3, v1);
  eigvec3(a, e1, v3);
  cross3(v3, v1, v2);
  const float n2 = clamp_min(row_norm<3>(v2, 1), (float)1e-30);
  for (int i = 0; i < 3; ++i) v2[i] = v2[i] / n2;
  for (int i = 0; i < 3; ++i) {
    vecs[i * 3 + 0] = v1[i];
    vecs[i * 3 + 1] = v2[i];
    vecs[i * 3 + 2] = v3[i];
  }
}

// m (3 x 3) → u, s (descending), vt
__device__ void svd3(const float* m, float* u, float* s, float* vt) {
  float mtm[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) mtm[i * 3 + j] = dot_chain(m + i, 3, m + j, 3, 3);
  float vals[3], vecs[9], v[9];
  eigh3(mtm, vals, vecs);
  for (int i = 0; i < 3; ++i) s[i] = sqrtf(clamp_min(vals[2 - i], 0.f));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) v[i * 3 + j] = vecs[i * 3 + (2 - j)];
  float ur[9];
  mm3(m, v, ur);
  float nrm[3];
  for (int j = 0; j < 3; ++j) nrm[j] = col_norm3(ur + j, 3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) u[i * 3 + j] = ur[i * 3 + j] / clamp_min(nrm[j], (float)1e-30);
  float c0[3] = {u[0], u[3], u[6]}, c1[3] = {u[1], u[4], u[7]}, u2[3];
  cross3(c0, c1, u2);
  if (!(nrm[2] > (float)1e-12))
    for (int i = 0; i < 3; ++i) u[i * 3 + 2] = u2[i];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) vt[i * 3 + j] = v[j * 3 + i];
}

// ---------------------------------------------------------------------------
// the DLT, one warp a hypothesis

struct WarpScratch {
  float m[kMat];       // AᵀA
  float b[kMat];       // the matrix being squared
  float t[kMat];       // its square
  float aug[kAug];     // A, then the Gauss-Jordan system
  float pt[6][6];      // a sample's x, y, z, xn0, xn1
  float v[kN], w[kN], c[kN];
};

// pivot-free Gauss-Jordan on aug (N x N+1) in shared memory, by one warp
template <int N>
__device__ void warp_gauss_jordan(float* aug, int lane) {
  constexpr int C = N + 1;
  constexpr int PER = (N * C + 31) / 32;
  for (int i = 0; i < N; ++i) {
    float piv = aug[i * C + i];
    if (fabsf(piv) < (float)1e-20) piv = (float)1e-20;
    float nv[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = lane + 32 * k;
      if (e < N * C) {
        const int r = e / C, j = e % C;
        const float row = aug[i * C + j] / piv;
        nv[k] = (r == i) ? row : aug[e] - aug[r * C + i] * row;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = lane + 32 * k;
      if (e < N * C) aug[e] = nv[k];
    }
    __syncwarp();
  }
}

// ‖b‖_F as linalg.matrix_norm sums 144 values: loads of 4, 32 lanes
__device__ __forceinline__ float warp_fro144(const float* b, int lane) {
  float slot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = lane; c < kMat / 4; c += 32)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = b[4 * c + i];
      slot[i] = __fmaf_rn(v, v, slot[i]);
    }
  float acc = ((slot[0] + slot[1]) + slot[2]) + slot[3];
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    acc = acc + __shfl_down_sync(kFull, acc, off);
  return sqrtf(__shfl_sync(kFull, acc, 0));
}

__device__ void dlt_hypothesis(const Params& p, int prob, int h,
                               WarpScratch& ws, int lane, float* out) {
  const int K = p.K;
  if (lane < 6) {
    const int64_t s = p.samples[((size_t)prob * p.n_hyp + h) * 6 + lane];
    if (s < 0 || s >= K) __trap();
    const int o = p.perm[(size_t)prob * K + s];
    const float* x = p.xyz + ((size_t)prob * K + o) * 3;
    const float* uv = p.uv + ((size_t)prob * K + o) * 2;
    ws.pt[lane][0] = x[0];
    ws.pt[lane][1] = x[1];
    ws.pt[lane][2] = x[2];
    ws.pt[lane][3] = (uv[0] - p.cx) * p.inv_fx;
    ws.pt[lane][4] = (uv[1] - p.cy) * p.inv_fy;
  }
  __syncwarp();
  // A (12 x 12): rows 0-5 [xh, 0, -xn0 xh], rows 6-11 [0, xh, -xn1 xh]
  for (int e = lane; e < kMat; e += 32) {
    const int r = e / kN, c = e % kN, j = r % 6, blk = c / 4, k = c % 4;
    const float xh = k < 3 ? ws.pt[j][k] : 1.f;
    float val;
    if (blk == 2)
      val = (-ws.pt[j][r < 6 ? 3 : 4]) * xh;
    else
      val = (blk == (r < 6 ? 0 : 1)) ? xh : 0.f;
    ws.aug[e] = val;
  }
  __syncwarp();
  for (int e = lane; e < kMat; e += 32) {
    const int i = e / kN, j = e % kN;
    ws.m[e] = dot_chain(ws.aug + i, kN, ws.aug + j, kN, kN);
  }
  __syncwarp();
  // smallest_eigvec: shifted power iteration by squaring
  const float shift = row_sum<kN>(ws.m, kN + 1);
  for (int e = lane; e < kMat; e += 32)
    ws.b[e] = shift * ((e / kN == e % kN) ? 1.f : 0.f) - ws.m[e];
  __syncwarp();
  float* cur = ws.b;
  float* nxt = ws.t;
  for (int sq = 0; sq < 8; ++sq) {
    const float nrm = clamp_min(warp_fro144(cur, lane), 1e-30f);
    for (int e = lane; e < kMat; e += 32) cur[e] = cur[e] / nrm;
    __syncwarp();
    for (int e = lane; e < kMat; e += 32) {
      const int i = e / kN, j = e % kN;
      nxt[e] = dot_chain(cur + i * kN, 1, cur + j, kN, kN);
    }
    __syncwarp();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (lane < kN) {
    ws.c[lane] = 1.f + (float)lane * (float)0.1;
    ws.v[lane] = cosf((float)lane);
  }
  __syncwarp();
  float w1 = 0.f, w2 = 0.f;
  if (lane < kN) {
    w1 = dot_halves(cur + lane * kN, 1, ws.c, 1, kN);
    w2 = dot_halves(cur + lane * kN, 1, ws.v, 1, kN);
  }
  __syncwarp();
  if (lane < kN) {
    ws.w[lane] = w1;
    ws.c[lane] = w2;
  }
  __syncwarp();
  if (lane < kN) {
    w1 = dot_halves(cur + lane * kN, 1, ws.w, 1, kN);   // B (B v0)
    w2 = dot_halves(cur + lane * kN, 1, ws.c, 1, kN);   // B (B cos)
  }
  __syncwarp();
  if (lane < kN) {
    ws.v[lane] = w1;
    ws.w[lane] = w2;
  }
  __syncwarp();
  const bool use_v = row_norm<kN>(ws.v, 1) > (float)1e-25;
  if (lane < kN) ws.c[lane] = use_v ? ws.v[lane] : ws.w[lane];
  __syncwarp();
  {
    const float n = clamp_min(row_norm<kN>(ws.c, 1), (float)1e-30);
    float vi = 0.f;
    if (lane < kN) vi = ws.c[lane] / n;
    __syncwarp();
    if (lane < kN) ws.v[lane] = vi;
    __syncwarp();
  }
  const float eps = (float)1e-7 * shift + (float)1e-30;
  for (int it = 0; it < 2; ++it) {
    for (int e = lane; e < kAug; e += 32) {
      const int r = e / (kN + 1), c = e % (kN + 1);
      ws.aug[e] = c == kN ? ws.v[r]
                          : ws.m[r * kN + c] + eps * (r == c ? 1.f : 0.f);
    }
    __syncwarp();
    warp_gauss_jordan<kN>(ws.aug, lane);
    if (lane < kN) ws.c[lane] = ws.aug[lane * (kN + 1) + kN];
    __syncwarp();
    const float n = clamp_min(row_norm<kN>(ws.c, 1), (float)1e-30);
    if (lane < kN) ws.v[lane] = ws.c[lane] / n;
    __syncwarp();
  }
  // p = v as 3 x 4; the rest in one lane
  if (lane == 0) {
    float pm[12];
    for (int i = 0; i < 12; ++i) pm[i] = ws.v[i];
    float depth[6];
    for (int j = 0; j < 6; ++j) {
      const float xh[4] = {ws.pt[j][0], ws.pt[j][1], ws.pt[j][2], 1.f};
      depth[j] = dot_halves(xh, 1, pm + 8, 1, 4);
    }
    const float mean = row_sum<6>(depth, 1) * (1.f / 6.f);
    const float sg = mean < 0.f ? -1.f : 1.f;
    for (int i = 0; i < 12; ++i) pm[i] = pm[i] * sg;
    float m[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) m[i * 3 + j] = pm[i * 4 + j];
    float u[9], s[3], vt[9], uvt[9];
    svd3(m, u, s, vt);
    mm3(u, vt, uvt);
    const float det = det3(uvt);
    float ud[9], r[9];
    for (int i = 0; i < 3; ++i) {
      ud[i * 3 + 0] = u[i * 3 + 0] * 1.f;
      ud[i * 3 + 1] = u[i * 3 + 1] * 1.f;
      ud[i * 3 + 2] = u[i * 3 + 2] * det;
    }
    mm3(ud, vt, r);
    const float scale = (row_sum<3>(s, 1) * (1.f / 3.f)) *
                        (det < 0.f ? -1.f : 1.f);
    const float den = clamp_min(fabsf(scale), (float)1e-12);
    const float sgn = sign_of(scale);
    for (int i = 0; i < 9; ++i) out[i] = r[i];
    for (int i = 0; i < 3; ++i) out[9 + i] = (pm[i * 4 + 3] / den) * sgn;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// reprojection (_reproj_errors) and one Gauss-Newton point

struct Point {
  float x, y, z, u, v;
  bool m;
};

__device__ __forceinline__ Point load_point(const Params& p, int prob,
                                            int k) {
  const size_t i = (size_t)prob * p.K + k;
  Point pt;
  pt.x = p.xyz[i * 3 + 0];
  pt.y = p.xyz[i * 3 + 1];
  pt.z = p.xyz[i * 3 + 2];
  pt.u = p.uv[i * 2 + 0];
  pt.v = p.uv[i * 2 + 1];
  pt.m = p.mask[i] != 0;
  return pt;
}

// xc = R X + t: X Rᵀ by cuBLAS's chain, then + t
__device__ __forceinline__ void transform(const float* r, const float* t,
                                          const Point& pt, float* xc) {
  const float x[3] = {pt.x, pt.y, pt.z};
  for (int j = 0; j < 3; ++j) xc[j] = dot_chain(x, 1, r + j * 3, 1, 3) + t[j];
}

__device__ __forceinline__ bool inlier(const Params& p, const float* r,
                                       const float* t, const Point& pt) {
  float xc[3];
  transform(r, t, pt, xc);
  const float z = clamp_min(xc[2], (float)1e-6);
  const float u = (p.fx * xc[0]) / z + p.cx;
  const float v = (p.fy * xc[1]) / z + p.cy;
  const float du = u - pt.u, dv = v - pt.v;
  const float err = xc[2] > (float)1e-6 ? sqrtf(du * du + dv * dv) : 1e9f;
  return pt.m && err < p.threshold;
}

// [J | r] of both rows of one point (_gauss_newton_refine)
__device__ __forceinline__ void jacobian(const Params& p, const float* r,
                                         const float* t, const Point& pt,
                                         float jr[2][7], bool& front) {
  float xc[3];
  transform(r, t, pt, xc);
  const float x0 = xc[0], x1 = xc[1], x2 = xc[2];
  const float z = clamp_min(x2, (float)1e-6);
  const float iz = 1.f / z;
  const float u = (p.fx * x0) * iz + p.cx;
  const float v = (p.fy * x1) * iz + p.cy;
  const float jp[2][3] = {{p.fx * iz, 0.f, ((-p.fx * x0) * iz) * iz},
                          {0.f, p.fy * iz, ((-p.fy * x1) * iz) * iz}};
  const float sk[9] = {0.f, x2, -x1, -x2, 0.f, x0, x1, -x0, 0.f};
  for (int a = 0; a < 2; ++a) {
    for (int j = 0; j < 3; ++j) jr[a][j] = dot_chain(jp[a], 1, sk + j, 3, 3);
    for (int j = 0; j < 3; ++j) jr[a][3 + j] = jp[a][j];
  }
  jr[0][6] = u - pt.u;
  jr[1][6] = v - pt.v;
  front = x2 > (float)1e-6;
}

struct BlockScratch {
  double red[kWarps][kG];
  float g[kG];
  float aug[6 * 7];
  float q[4], t[3];          // the pose being refined
  float q0[4], t0[3];        // the best hypothesis's
  int warp_tot[kWarps];
  int count, best, score_best, n_final;
};

__device__ __forceinline__ bool bit(const unsigned* w, int k) {
  return (w[k >> 5] >> (k & 31)) & 1u;
}

// one Gauss-Newton pass of p.refine_iters steps from bs.q, bs.t with 0/1
// weights w (bits)
__device__ void gauss_newton(const Params& p, int prob, const unsigned* wbits,
                             BlockScratch& bs, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  for (int it = 0; it < p.refine_iters; ++it) {
    float r[9];
    quat_to_mat(bs.q, r);
    const float t[3] = {bs.t[0], bs.t[1], bs.t[2]};
    double g[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) g[i] = 0.0;
    for (int k = tid; k < p.K; k += kThreads) {
      const Point pt = load_point(p, prob, k);
      float jr[2][7];
      bool front;
      jacobian(p, r, t, pt, jr, front);
      const double wk = (bit(wbits, k) ? 1.0 : 0.0) * (front ? 1.0 : 0.0);
      int idx = 0;
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        const double a0 = (double)jr[0][i] * wk, a1 = (double)jr[1][i] * wk;
#pragma unroll
        for (int j = i; j < 7; ++j) {
          g[idx] += a0 * (double)jr[0][j];
          g[idx] += a1 * (double)jr[1][j];
          ++idx;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      double v = g[i];
#pragma unroll
      for (int off = 16; off >= 1; off /= 2) v += __shfl_down_sync(kFull, v, off);
      if (lane == 0) bs.red[warp][i] = v;
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < kG) {
        double v = 0.0;
        for (int w = 0; w < kWarps; ++w) v += bs.red[w][lane];
        bs.g[lane] = (float)v;
      }
      __syncwarp();
      // the damped 6 x 6 system [H + 1e-6 I | b] from the 7 x 7 Gram
      for (int e = lane; e < 42; e += 32) {
        const int i = e / 7, j = e % 7;
        const int a = i < j ? i : j, b = i < j ? j : i;
        const int idx = a * 7 - a * (a - 1) / 2 + (b - a);
        const float gv = bs.g[idx];
        bs.aug[e] = j == 6 ? gv : gv + (float)1e-6 * (i == j ? 1.f : 0.f);
      }
      __syncwarp();
      warp_gauss_jordan<6>(bs.aug, lane);
      if (lane == 0) {
        float dx[6];
        for (int i = 0; i < 6; ++i) dx[i] = -bs.aug[i * 7 + 6];
        float dq[4], qn[4], tr[3];
        so3_exp(dx, dq);
        quat_mul(dq, bs.q, qn);
        quat_normalize(qn);
        quat_rotate(dq, bs.t, tr);
        for (int i = 0; i < 3; ++i) bs.t[i] = tr[i] + dx[3 + i];
        for (int i = 0; i < 4; ++i) bs.q[i] = qn[i];
      }
    }
    __syncthreads();
  }
}

// inlier bits of pose (r, t) over the K slots into w; → their count
__device__ int inlier_bits(const Params& p, int prob, const float* r,
                           const float* t, unsigned* w, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  int n = 0;
  for (int base = warp * 32; base < p.K; base += kThreads) {
    const int k = base + lane;
    bool in = false;
    if (k < p.K) in = inlier(p, r, t, load_point(p, prob, k));
    const unsigned bal = __ballot_sync(kFull, in);
    if (lane == 0) w[base >> 5] = bal;
    n += __popc(bal);
  }
  return n;   // this warp's share (lane 0's)
}

__global__ void __launch_bounds__(kThreads)
pnp_ransac_kernel(const Params p) {
  extern __shared__ unsigned dyn[];
  __shared__ WarpScratch ws[kWarps];
  __shared__ BlockScratch bs;
  const int prob = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.K;
  const int n_words = (K + 31) / 32;
  const int n_tot = p.n_hyp + (p.prior_q ? 2 : 0);
  unsigned* w_best = dyn;
  unsigned* w_cur = dyn + n_words;
  int* scores = reinterpret_cast<int*>(dyn + 2 * n_words);
  float* hyp = p.hyp + (size_t)prob * (p.n_hyp + 2) * 12;

  // --- 1. count and compact the mask in stable order ----------------------
  const int chunk = (K + kThreads - 1) / kThreads;
  const int lo = min(K, tid * chunk), hi = min(K, lo + chunk);
  const uint8_t* mk = p.mask + (size_t)prob * K;
  int c = 0;
  for (int i = lo; i < hi; ++i) c += mk[i] != 0;
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) bs.warp_tot[warp] = incl;
  for (int h = tid; h < n_tot; h += kThreads) scores[h] = 0;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = bs.warp_tot[w];
      bs.warp_tot[w] = run;
      run += v;
    }
    bs.count = run;
  }
  __syncthreads();
  {
    const int count = bs.count;
    int* perm = p.perm + (size_t)prob * K;
    int rank = bs.warp_tot[warp] + incl - c;
    for (int i = lo; i < hi; ++i) {
      if (mk[i]) perm[rank++] = i;
      else perm[count + (i - rank)] = i;
    }
  }
  __syncthreads();

  // --- 2. hypotheses: the DLT a warp each, then prior and identity --------
  for (int h = warp; h < p.n_hyp; h += kWarps)
    dlt_hypothesis(p, prob, h, ws[warp], lane, hyp + (size_t)h * 12);
  if (p.prior_q && tid == 0) {
    float* hp = hyp + (size_t)p.n_hyp * 12;
    quat_to_mat(p.prior_q + (size_t)prob * 4, hp);
    for (int i = 0; i < 3; ++i) hp[9 + i] = p.prior_t[(size_t)prob * 3 + i];
    float* eye = hp + 12;
    for (int i = 0; i < 9; ++i) eye[i] = (i % 4 == 0) ? 1.f : 0.f;
    for (int i = 0; i < 3; ++i) eye[9 + i] = 0.f;
  }
  __syncthreads();

  // --- 3. score: a thread's points against every hypothesis ---------------
  for (int base = 0; base < K; base += kThreads) {
    const int k = base + tid;
    Point pt{0.f, 0.f, 0.f, 0.f, 0.f, false};
    if (k < K) pt = load_point(p, prob, k);
    for (int h = 0; h < n_tot; ++h) {
      const float* hp = hyp + (size_t)h * 12;
      const bool in = k < K && inlier(p, hp, hp + 9, pt);
      const unsigned bal = __ballot_sync(kFull, in);
      if (lane == 0 && bal) atomicAdd(&scores[h], __popc(bal));
    }
  }
  __syncthreads();
  if (warp == 0) {
    int bv = -1, bi = 0;
    for (int h = lane; h < n_tot; h += 32)
      if (scores[h] > bv) { bv = scores[h]; bi = h; }
#pragma unroll
    for (int off = 16; off >= 1; off /= 2) {
      const int ov = __shfl_down_sync(kFull, bv, off);
      const int oi = __shfl_down_sync(kFull, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) {
      bs.best = bi;
      bs.score_best = bv;
      const float* hp = hyp + (size_t)bi * 12;
      mat_to_quat(hp, bs.q0);
      for (int i = 0; i < 3; ++i) bs.t0[i] = hp[9 + i];
      for (int i = 0; i < 4; ++i) bs.q[i] = bs.q0[i];
      for (int i = 0; i < 3; ++i) bs.t[i] = bs.t0[i];
    }
  }
  __syncthreads();

  // --- 4. two Gauss-Newton passes -------------------------------------------
  {
    const float* hp = hyp + (size_t)bs.best * 12;
    inlier_bits(p, prob, hp, hp + 9, w_best, tid);
  }
  __syncthreads();
  gauss_newton(p, prob, w_best, bs, tid);
  {
    float r[9];
    quat_to_mat(bs.q, r);
    inlier_bits(p, prob, r, bs.t, w_cur, tid);
  }
  __syncthreads();
  gauss_newton(p, prob, w_cur, bs, tid);

  // --- 5. final inliers, the keep rule, valid -------------------------------
  {
    float r[9];
    quat_to_mat(bs.q, r);
    const float t[3] = {bs.t[0], bs.t[1], bs.t[2]};
    __syncthreads();
    const int n = inlier_bits(p, prob, r, t, w_cur, tid);
    if (lane == 0) bs.warp_tot[warp] = n;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int w = 0; w < kWarps; ++w) n += bs.warp_tot[w];
    bs.n_final = n;
  }
  __syncthreads();
  const bool keep = bs.n_final >= bs.score_best;
  for (int k = tid; k < K; k += kThreads)
    p.inl_out[(size_t)prob * K + k] = bit(keep ? w_cur : w_best, k);
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) p.q_out[prob * 4 + i] = keep ? bs.q[i] : bs.q0[i];
    for (int i = 0; i < 3; ++i) p.t_out[prob * 3 + i] = keep ? bs.t[i] : bs.t0[i];
    const int n = bs.n_final > bs.score_best ? bs.n_final : bs.score_best;
    p.n_out[prob] = n;
    p.valid_out[prob] = bs.count >= p.min_inliers && n >= p.min_inliers;
  }
}

}  // namespace

// One launch solves B problems.  Pointers are device pointers (prior_q and
// prior_t null without a prior); perm (B*K int32) and hyp (B*(n_hyp+2)*12
// float32) are scratch the caller allocates.  dyn_smem: 4 * (2 * ceil(K/32)
// + n_hyp + 2) bytes.  Returns cudaGetLastError() after the launch.
extern "C" int pnp_ransac(const void* xyz, const void* uv, const void* mask,
                          const void* samples, const void* prior_q,
                          const void* prior_t, void* perm, void* hyp,
                          void* q_out, void* t_out, void* inl_out,
                          void* n_out, void* valid_out, int B, int K,
                          int n_hyp, int refine_iters, int min_inliers,
                          float fx, float fy, float cx, float cy,
                          float inv_fx, float inv_fy, float threshold,
                          int dyn_smem, void* stream) {
  // above the default 48 KB of a block (the static part is ~46 KB)
  if (dyn_smem > 2048)
    cudaFuncSetAttribute(pnp_ransac_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         dyn_smem);
  Params p;
  p.xyz = static_cast<const float*>(xyz);
  p.uv = static_cast<const float*>(uv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.samples = static_cast<const int64_t*>(samples);
  p.prior_q = static_cast<const float*>(prior_q);
  p.prior_t = static_cast<const float*>(prior_t);
  p.perm = static_cast<int*>(perm);
  p.hyp = static_cast<float*>(hyp);
  p.q_out = static_cast<float*>(q_out);
  p.t_out = static_cast<float*>(t_out);
  p.inl_out = static_cast<uint8_t*>(inl_out);
  p.n_out = static_cast<int64_t*>(n_out);
  p.valid_out = static_cast<uint8_t*>(valid_out);
  p.K = K;
  p.n_hyp = n_hyp;
  p.refine_iters = refine_iters;
  p.min_inliers = min_inliers;
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.inv_fx = inv_fx;
  p.inv_fy = inv_fy;
  p.threshold = threshold;
  if (B > 0)
    pnp_ransac_kernel<<<B, kThreads, dyn_smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
