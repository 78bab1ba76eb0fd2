// K2: norm assembly (paper Eq. 5) over fp32 [d_out] vectors.
//
// Replaces the TPU kernel repro/kernels/norm_assembly.py:37
// assemble_norm_pallas (_assembly_kernel):
//
//   w_norm = sqrt(max(base_sq + two_s*cross + s2*ba_sq, 0))
//
// Bound on the H100: 16 bytes a row (three reads, one write) and a few
// operations; at d_out <= 18944 that is under 0.1 us of memory time, so
// the kernel is bound by its launch. Design: one thread per row, nothing
// else.
//
// Numerics, as the reference pins them: two_s = 2s and s2 = s^2 are
// formed in fp64 by the caller and rounded to fp32; the adds run in the
// order (base + two_s*cross) + s2*ba with round-to-nearest intrinsics, so
// nvcc cannot contract them into FMAs; the max propagates NaN (fmaxf
// would turn NaN into 0); the sqrt is the correctly rounded __fsqrt_rn
// (the library is built without --use_fast_math).
#include "common.cuh"

namespace {

__global__ void assemble_norm_kernel(const float* __restrict__ base_sq,
                                     const float* __restrict__ cross,
                                     const float* __restrict__ ba_sq,
                                     float* __restrict__ out, int n,
                                     float two_s, float s2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = __fadd_rn(base_sq[i], __fmul_rn(two_s, cross[i]));
  acc = __fadd_rn(acc, __fmul_rn(s2, ba_sq[i]));
  const float clamped = (acc != acc) ? acc : (acc > 0.0f ? acc : 0.0f);
  out[i] = __fsqrt_rn(clamped);
}

}  // namespace

extern "C" int assemble_norm(const void* base_sq, const void* cross,
                             const void* ba_sq, void* out, int n, float two_s,
                             float s2, void* stream) {
  constexpr int kThreads = 256;
  const int blocks = (n + kThreads - 1) / kThreads;
  assemble_norm_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base_sq), static_cast<const float*>(cross),
      static_cast<const float*>(ba_sq), static_cast<float*>(out), n, two_s,
      s2);
  return static_cast<int>(cudaGetLastError());
}
