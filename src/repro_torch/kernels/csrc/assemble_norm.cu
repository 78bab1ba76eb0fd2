// K2: norm assembly (paper Eq. 5) over fp32 [d_out] vectors.
//
// Replaces the TPU kernel repro/kernels/norm_assembly.py:37
// assemble_norm_pallas (_assembly_kernel):
//
//   w_norm = sqrt(max(base_sq + two_s*cross + s2*ba_sq, 0))
//
// The main paths no longer launch this kernel: their counterpart of
// assemble_norm_pallas is the epilogue of K1 (norm_terms.cu), which sums
// ba_sq = rowsum((B·G) ⊙ B) and assembles the norm with the same
// assemble_norm_elem (common.cuh), so a norm costs no launch of its own.
// This kernel stays as the standalone wrapper's, held bitwise against its
// plain version.
//
// Bound on the H100: 16 bytes a row (three reads, one write) and a few
// operations; at d_out <= 18944 that is under 0.1 us of memory time, so
// the kernel is bound by its launch. Design: one thread per row, nothing
// else.
//
// Numerics, as the reference pins them: two_s = 2s and s2 = s^2 are
// formed in fp64 by the caller and rounded to fp32; assemble_norm_elem
// keeps the order (base + two_s*cross) + s2*ba, the NaN-propagating max
// and the correctly rounded sqrt.
#include "common.cuh"

namespace {

__global__ void assemble_norm_kernel(const float* __restrict__ base_sq,
                                     const float* __restrict__ cross,
                                     const float* __restrict__ ba_sq,
                                     float* __restrict__ out, int n,
                                     float two_s, float s2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = assemble_norm_elem(base_sq[i], cross[i], ba_sq[i], two_s, s2);
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
