// ORB keypoint detection, every level of every frame of a batch, in two
// launches (kernel D1 of the port): from kernel B1's FAST score maps to the
// batch's keypoint slots.
//
// Replaces: no Pallas kernel.  The JAX package's frontend/orb.py
// detect_level is plain jnp, which XLA fuses into a few programs a level;
// the port's plain version (ops/detect.detect_levels_plain: detect_level a
// level, then the concatenation and padding of frontend/orb.detect_batch)
// is some 1,400 tiny PyTorch operations a call at 8 levels, whatever the
// batch, each launched from the host.  That chain, not the device, set the
// pace of extraction.  This kernel exists to run it as two launches.
//
// What it computes, per frame and level (score map S, H x W; quota q):
//   peaks: S(p) > min_th and no 3x3 neighbour inside the image above S(p)
//     (maxpool_same with -inf padding, S >= its window's max);
//   per 35-px cell anchored at (0, 0), the ragged edge included: if some
//     peak of the cell is above ini_th, keep its peaks above ini_th, else
//     all its peaks (FAST 20 -> 7 fallback); the kept peaks equal to the
//     cell's best kept score gain 1e6 (float32 add);
//   per cell the top 8 by the packed key (trunc(score) + 1) * 2048 +
//     (2047 - in-cell index), 0 for slots the cell cannot fill;
//   per level the stable top min(q, 8 x cells) of the candidates in (cell
//     row, cell column, rank) order by the key's score part (K = key >> 11,
//     0 for an empty slot, which the plain version holds as -inf), ties to
//     the lower candidate index; slots beyond that, up to q, repeat
//     candidate 0's position with response -1;
//   each slot's level pixel (y, x), uv = (x, y) * float32(scale^level),
//   response (K - 1, less 1e6 above 5e5; -1 for an empty slot), octave,
//   mask = response > 0; the levels' slots concatenated in a frame's row of
//   n_out slots, the tail past the quotas zero.
// Every value is an integer or a float32 holding one (scores <= 255 plus
// 1e6 stay below 2^24) or one float32 product, so the result equals the
// plain version bit for bit on any finite scores below 48,575 (where the
// packed key stays below 2^31, as the plain version's int32 key needs).
//
// What bounds it on the H100: device memory.  The cell pass reads each
// score once (4 bytes a pixel; a pixel above min_th reads its 8
// neighbours from L1) and does a few comparisons a pixel; the selection
// touches 32 bytes a cell and 28 a slot.  At 720p, B = 24, 8 levels
// (68.5 M px) that is 0.27 GB, about 0.08 ms.
//
// Design.  Cell pass: a warp a cell, 8 cells a block.  Lane l takes the
// cell's pixels l, l + 32, ... (39 of them, kept in registers with a peak
// and a keep bit each); two warp max-reductions give the cell's strongest
// peak and best kept score; each lane keeps a sorted top 8 of its packed
// keys, and 8 rounds of __reduce_max_sync merge them (keys are distinct,
// so exactly one lane pops a round).  Selection pass: a block of 1024
// threads a (frame, level).  The threshold score T and the count above it
// come from two 1024-bin histograms of K (a radix select over K's 20
// bits); two block scans over contiguous runs of candidates then compact
// the selected ones in candidate order (every key above T, and the first
// k - above ones equal to T) into shared memory, and each selected one's
// slot is its rank: the selected with a higher K, plus those with an equal
// K and a lower index.  No atomics on device memory, no host read.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kCell = 35;
constexpr int kCellPx = kCell * kCell;
constexpr int kPerCell = 8;
constexpr int kLanePx = (kCellPx + 31) / 32;   // 39 pixels a lane
constexpr int kMaxLevels = 16;
constexpr int kCellWarps = 8;                  // cells a block, cell pass
constexpr int kSelectThreads = 1024;           // one histogram bin a thread
constexpr unsigned kFull = 0xffffffffu;

struct Level {
  const float* score;   // (B, h, w)
  int h, w, hc, wc;     // hc x wc cells
  int cell0;            // first cell (frame-major) in the whole call
  int cand0;            // first candidate: cand0 + f * hc * wc * 8 + j
  int quota;
  int slot0;            // first slot of the level in a frame's row
  float scale;          // float32(scale_factor ** level)
};

struct Params {
  Level lv[kMaxLevels];
  int n_levels, batch, n_out, n_slots, n_cells;
  float ini_th, min_th;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One warp a cell: its 8 candidate keys into cand.
__global__ void __launch_bounds__(kCellWarps * 32)
orb_detect_cells_kernel(const __grid_constant__ Params p, int* __restrict__ cand) {
  const int lane = threadIdx.x & 31;
  const int gid = blockIdx.x * kCellWarps + (threadIdx.x >> 5);
  if (gid >= p.n_cells) return;   // warp-uniform
  int l = 0;
  while (l + 1 < p.n_levels && gid >= p.lv[l + 1].cell0) ++l;
  const Level& L = p.lv[l];
  const int local = gid - L.cell0;
  const int per_frame = L.hc * L.wc;
  const int f = local / per_frame;
  const int c = local - f * per_frame;
  const int cr = c / L.wc;
  const int y0 = cr * kCell, x0 = (c - cr * L.wc) * kCell;
  const int h = L.h, w = L.w;
  const float* s = L.score + static_cast<size_t>(f) * h * w;

  float v[kLanePx];
  uint64_t peak = 0;
  float peak_max = -INFINITY;
#pragma unroll
  for (int i = 0; i < kLanePx; ++i) {
    const int q = lane + 32 * i;
    const int y = y0 + q / kCell, x = x0 + q % kCell;
    float sv = -INFINITY;
    bool is_peak = false;
    if (q < kCellPx && y < h && x < w) {
      sv = __ldg(s + static_cast<size_t>(y) * w + x);
      if (sv > p.min_th) {
        is_peak = true;
        for (int dy = -1; dy <= 1; ++dy) {
          const int yy = y + dy;
          if (yy < 0 || yy >= h) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            const int xx = x + dx;
            if (xx < 0 || xx >= w || (dy == 0 && dx == 0)) continue;
            if (__ldg(s + static_cast<size_t>(yy) * w + xx) > sv) is_peak = false;
          }
        }
      }
    }
    v[i] = sv;
    if (is_peak) {
      peak |= 1ull << i;
      peak_max = fmaxf(peak_max, sv);
    }
  }
  const bool strong = warp_max(peak_max) > p.ini_th;
  uint64_t keep = 0;
  float keep_max = -INFINITY;
#pragma unroll
  for (int i = 0; i < kLanePx; ++i) {
    if (((peak >> i) & 1) && (v[i] > p.ini_th || !strong)) {
      keep |= 1ull << i;
      keep_max = fmaxf(keep_max, v[i]);
    }
  }
  const float best = warp_max(keep_max);
  int top[kPerCell];
#pragma unroll
  for (int j = 0; j < kPerCell; ++j) top[j] = 0;
#pragma unroll
  for (int i = 0; i < kLanePx; ++i) {
    const float boosted = v[i] >= best ? v[i] + 1e6f : v[i];
    if (!((keep >> i) & 1) || !(boosted > 0.0f)) continue;
    const int key = (static_cast<int>(boosted) + 1) * 2048 + (2047 - (lane + 32 * i));
    // insert into the descending top 8
#pragma unroll
    for (int j = kPerCell - 1; j > 0; --j)
      top[j] = key > top[j - 1] ? top[j - 1] : (key > top[j] ? key : top[j]);
    top[0] = max(top[0], key);
  }
  int mine = 0;
#pragma unroll
  for (int r = 0; r < kPerCell; ++r) {
    const int m = __reduce_max_sync(kFull, top[0]);
    if (lane == r) mine = m;
    if (m > 0 && top[0] == m) {
#pragma unroll
      for (int j = 0; j < kPerCell - 1; ++j) top[j] = top[j + 1];
      top[kPerCell - 1] = 0;
    }
  }
  if (lane < kPerCell)
    cand[static_cast<size_t>(L.cand0) + static_cast<size_t>(local) * kPerCell + lane] = mine;
}

// Exclusive sum of v over the block's threads in order (every thread calls).
__device__ int block_exclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += warp_sums[i];
  __syncthreads();
  return before + x - v;
}

// One digit of a radix select, highest first: among the candidates whose K
// has (K >> match_shift) == match, the digit d = (K >> shift) & 1023 with
// count(digit > d) < need <= count(digit >= d).  res = {d, count(digit > d)}.
__device__ void select_digit(const int* __restrict__ c, int n, int shift, int match_shift,
                             int match, int need, int* hist, int* warp_sums, int* res) {
  const int t = threadIdx.x;
  hist[t] = 0;
  __syncthreads();
  for (int j = t; j < n; j += kSelectThreads) {
    const int k = __ldg(c + j) >> 11;
    if ((k >> match_shift) == match) atomicAdd(&hist[(k >> shift) & 1023], 1);
  }
  __syncthreads();
  const int d = kSelectThreads - 1 - t;
  const int here = hist[d];
  const int above = block_exclusive_sum(here, warp_sums);
  if (above < need && above + here >= need) {
    res[0] = d;
    res[1] = above;
  }
  __syncthreads();
}

__device__ __forceinline__ void write_slot(float* uv, float* resp, int* ys, int* xs, int* octave,
                                           bool* mask, size_t o, int y, int x, float r,
                                           int level, float scale) {
  ys[o] = y;
  xs[o] = x;
  resp[o] = r;
  octave[o] = level;
  mask[o] = r > 0.0f;
  uv[2 * o] = static_cast<float>(x) * scale;
  uv[2 * o + 1] = static_cast<float>(y) * scale;
}

// One block a (frame, level): the level's slots of the frame's row.
__global__ void __launch_bounds__(kSelectThreads)
orb_detect_select_kernel(const __grid_constant__ Params p, const int* __restrict__ cand, float* __restrict__ uv,
                         float* __restrict__ resp, int* __restrict__ ys, int* __restrict__ xs,
                         int* __restrict__ octave, bool* __restrict__ mask) {
  extern __shared__ int sel[];   // keys, then candidate indices, k each
  __shared__ int hist[kSelectThreads];
  __shared__ int warp_sums[kSelectThreads / 32];
  __shared__ int res[2];
  const int t = threadIdx.x;
  const int l = blockIdx.x / p.batch;
  const int f = blockIdx.x - l * p.batch;
  const Level& L = p.lv[l];
  const size_t row = static_cast<size_t>(f) * p.n_out;
  if (l == 0)
    for (int i = p.n_slots + t; i < p.n_out; i += kSelectThreads)
      write_slot(uv, resp, ys, xs, octave, mask, row + i, 0, 0, 0.0f, 0, 0.0f);
  if (L.quota <= 0) return;   // block-uniform
  const int n = L.hc * L.wc * kPerCell;
  const int k = min(L.quota, n);
  const int* c = cand + L.cand0 + static_cast<size_t>(f) * n;
  const size_t out = row + L.slot0;
  if (k < L.quota) {
    // the plain version's padding gathers candidate 0
    const int m0 = __ldg(c);
    const int i0 = m0 > 0 ? 2047 - (m0 & 2047) : 0;
    for (int r = k + t; r < L.quota; r += kSelectThreads)
      write_slot(uv, resp, ys, xs, octave, mask, out + r, i0 / kCell, i0 % kCell, -1.0f, l,
                 L.scale);
  }

  // the threshold T = K of the k-th candidate, and how many lie above it
  select_digit(c, n, 10, 20, 0, k, hist, warp_sums, res);
  const int hi = res[0], above_hi = res[1];
  select_digit(c, n, 0, 10, hi, k - above_hi, hist, warp_sums, res);
  const int thr = (hi << 10) | res[0];
  const int need_eq = k - above_hi - res[1];

  // compact the selected candidates in candidate order
  const int run = (n + kSelectThreads - 1) / kSelectThreads;
  const int j0 = min(n, t * run), j1 = min(n, j0 + run);
  int n_eq = 0;
  for (int j = j0; j < j1; ++j) n_eq += (__ldg(c + j) >> 11) == thr;
  const int eq_before = block_exclusive_sum(n_eq, warp_sums);
  int n_sel = 0;
  for (int j = j0, e = eq_before; j < j1; ++j) {
    const int kj = __ldg(c + j) >> 11;
    n_sel += kj > thr || (kj == thr && e++ < need_eq);
  }
  int pos = block_exclusive_sum(n_sel, warp_sums);
  int* s_key = sel;
  int* s_idx = sel + k;
  for (int j = j0, e = eq_before; j < j1; ++j) {
    const int m = __ldg(c + j);
    const int kj = m >> 11;
    if (kj > thr || (kj == thr && e++ < need_eq)) {
      s_key[pos] = m;
      s_idx[pos] = j;
      ++pos;
    }
  }
  __syncthreads();

  // each selected candidate's slot is its rank
  for (int i = t; i < k; i += kSelectThreads) {
    const int m = s_key[i];
    const int ki = m >> 11;
    int rank = 0;
    for (int u = 0; u < k; ++u) {
      const int ku = s_key[u] >> 11;
      rank += ku > ki || (ku == ki && u < i);
    }
    const int idx = m > 0 ? 2047 - (m & 2047) : 0;
    const int cell = s_idx[i] / kPerCell;
    const int cr = cell / L.wc;
    const int y = cr * kCell + idx / kCell;
    const int x = (cell - cr * L.wc) * kCell + idx % kCell;
    const float val = m > 0 ? static_cast<float>(ki - 1) : -INFINITY;
    const float r = isfinite(val) ? (val > 5e5f ? val - 1e6f : val) : -1.0f;
    write_slot(uv, resp, ys, xs, octave, mask, out + rank, y, x, r, l, L.scale);
  }
}

}  // namespace

// scores: n_levels device pointers to (batch, h, w) float32 maps; quotas
// and scales a level; cand: int32 scratch of batch * sum(ceil(h / 35) *
// ceil(w / 35) * 8) candidates; outputs (batch, n_out[, 2]) with n_out >=
// sum(quotas).  Returns the launch's cudaError_t.
extern "C" int orb_detect(const void* score_ptrs, const void* hs, const void* ws,
                          const void* quotas, const void* scales, int n_levels, int batch,
                          float ini_th, float min_th, int n_out, void* cand, void* uv,
                          void* resp, void* ys, void* xs, void* octave, void* mask,
                          void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || batch < 1) return cudaErrorInvalidValue;
  const float* const* score = static_cast<const float* const*>(score_ptrs);
  const int* h = static_cast<const int*>(hs);
  const int* w = static_cast<const int*>(ws);
  const int* q = static_cast<const int*>(quotas);
  const float* sc = static_cast<const float*>(scales);
  Params p = {};
  p.n_levels = n_levels;
  p.batch = batch;
  p.n_out = n_out;
  p.ini_th = ini_th;
  p.min_th = min_th;
  long long cells = 0, slots = 0;
  int max_k = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (h[l] < 1 || w[l] < 1 || q[l] < 0) return cudaErrorInvalidValue;
    Level& L = p.lv[l];
    L.score = score[l];
    L.h = h[l];
    L.w = w[l];
    L.hc = (h[l] + kCell - 1) / kCell;
    L.wc = (w[l] + kCell - 1) / kCell;
    L.cell0 = static_cast<int>(cells);
    L.cand0 = static_cast<int>(cells * kPerCell);
    L.quota = q[l];
    L.slot0 = static_cast<int>(slots);
    L.scale = sc[l];
    cells += static_cast<long long>(L.hc) * L.wc * batch;
    slots += q[l];
    max_k = std::max(max_k, std::min(q[l], L.hc * L.wc * kPerCell));
    if (cells * kPerCell >= (1ll << 31) || static_cast<long long>(h[l]) * w[l] * batch >= (1ll << 31))
      return cudaErrorInvalidValue;
  }
  if (slots > n_out) return cudaErrorInvalidValue;
  p.n_slots = static_cast<int>(slots);
  p.n_cells = static_cast<int>(cells);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cell_blocks = static_cast<int>((cells + kCellWarps - 1) / kCellWarps);
  orb_detect_cells_kernel<<<cell_blocks, kCellWarps * 32, 0, s>>>(p, static_cast<int*>(cand));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * sizeof(int) * static_cast<size_t>(max_k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(orb_detect_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  orb_detect_select_kernel<<<batch * n_levels, kSelectThreads, smem, s>>>(
      p, static_cast<const int*>(cand), static_cast<float*>(uv), static_cast<float*>(resp),
      static_cast<int*>(ys), static_cast<int*>(xs), static_cast<int*>(octave),
      static_cast<bool*>(mask));
  return static_cast<int>(cudaGetLastError());
}
