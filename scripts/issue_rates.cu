// Instruction-rate probe for kernel B1's bound (scripts/issue_rates.py):
// long independent chains of one instruction class.  Each thread runs 8
// chains; every step is one instruction of the class.  The two-input forms
// are volatile inline PTX so that no compiler pass merges or drops a step;
// the three-input DPX forms are the CUDA intrinsics, and the script checks
// their count in the SASS.

#include <cuda_runtime.h>

namespace {

enum ProbeOp {
  kFmin = 0,       // min.f32
  kFadd = 1,       // add.f32
  kMinS16x2 = 2,   // min.s16x2
  kLop3 = 3,       // lop3.b32, a three-input xor
  kMin3S16x2 = 4,  // __vimin3_s16x2
  kMax3S16x2 = 5,  // __vimax3_s16x2
};

template <int kOp>
__global__ void __launch_bounds__(256) probe_kernel(float* out, int iters, float seed) {
  float f[8];
  unsigned u[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j] = seed + static_cast<float>(threadIdx.x * 8 + j);
    u[j] = __float_as_uint(f[j]);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int rep = 0; rep < 16; ++rep) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (kOp == kFmin)
          asm volatile("min.f32 %0, %0, %1;" : "+f"(f[j]) : "f"(f[(j + 1) & 7]));
        else if (kOp == kFadd)
          asm volatile("add.f32 %0, %0, %1;" : "+f"(f[j]) : "f"(f[(j + 1) & 7]));
        else if (kOp == kMinS16x2)
          asm volatile("min.s16x2 %0, %0, %1;" : "+r"(u[j]) : "r"(u[(j + 1) & 7]));
        else if (kOp == kLop3)
          asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                       : "+r"(u[j]) : "r"(u[(j + 1) & 7]), "r"(u[(j + 2) & 7]));
        else if (kOp == kMin3S16x2)
          u[j] = __vimin3_s16x2(u[j], u[(j + 1) & 7], u[(j + 2 + rep % 6) & 7]);
        else
          u[j] = __vimax3_s16x2(u[j], u[(j + 1) & 7], u[(j + 2 + rep % 6) & 7]);
      }
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc += f[j] + __uint_as_float(u[j] & 0x3fffffffu);
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace

// One launch: blocks x 256 threads x iters x 128 instructions of class op
// (ProbeOp).  out: blocks * 256 floats.  Returns cudaGetLastError().
extern "C" int issue_rate_probe(int op, int blocks, int iters, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (op) {
    case kFmin: probe_kernel<kFmin><<<blocks, 256, 0, s>>>(o, iters, 1.0f); break;
    case kFadd: probe_kernel<kFadd><<<blocks, 256, 0, s>>>(o, iters, 1.0f); break;
    case kMinS16x2: probe_kernel<kMinS16x2><<<blocks, 256, 0, s>>>(o, iters, 1.0f); break;
    case kLop3: probe_kernel<kLop3><<<blocks, 256, 0, s>>>(o, iters, 1.0f); break;
    case kMin3S16x2: probe_kernel<kMin3S16x2><<<blocks, 256, 0, s>>>(o, iters, 1.0f); break;
    case kMax3S16x2: probe_kernel<kMax3S16x2><<<blocks, 256, 0, s>>>(o, iters, 1.0f); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
