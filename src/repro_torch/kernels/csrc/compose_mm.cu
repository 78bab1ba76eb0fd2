// K6: the matmul-fused stable DoRA compose, forward only.
//
// Replaces the TPU kernel repro/kernels/dora_compose.py:211
// compose_mm_fwd_pallas (_mm_fwd_kernel):
//
//   delta = gm1 ⊙ base + (gm1 + 1) ⊙ (s · (h · Bᵀ))
//
// for base [M, N], h = x·Aᵀ [M, r], B [N, r] in the activation dtype and
// gm1 = g - 1 fp32 [N]. The [M, N] up-projection y_lora is never written.
//
// Bound on the H100: at prefill on qwen2-7b w_gate (M = 4096, N = 18944,
// r = 384, bf16) the function moves ~328 MB (base in, delta out, h and B
// once) for 60 GFLOP: max(98 us of bytes, 60 us of bf16 tensor-core
// operations), so it is bound by memory — if the product ran on the
// tensor cores.
//
// Design: a GEMM tile with the compose as its epilogue. Each block owns a
// 64 x 64 tile of delta and walks r in 16-deep chunks (r is taken as
// given: no padding to 128 as on the TPU; ragged edges load zeros). The
// product is fp32 FMA on CUDA cores (no TF32), the simple first version:
// it is bound by CUDA-core operations, well above the memory bound, until
// a later change moves it to mma.sync / wgmma with TMA. The epilogue reads
// base and gm1 once per element and applies compose_elem's pinned,
// FMA-free order to the fp32 lora value.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(tile::THREADS)
    compose_mm_fwd_kernel(const T* __restrict__ base, const T* __restrict__ h,
                          const T* __restrict__ B,
                          const float* __restrict__ gm1, T* __restrict__ out,
                          int m, int n, int r, float s) {
  using namespace tile;
  __shared__ __align__(16) float sX[BK][BM + 4];
  __shared__ __align__(16) float sY[BK][BN + 4];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
  tile_product_nt<T, false>(h, m, m0, B, n, n0, r, acc, sX, sY, nullptr);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col >= n) continue;
      const size_t idx = static_cast<size_t>(row) * n + col;
      out[idx] = from_f32<T>(
          compose_elem(gm1[col], to_f32(base[idx]), acc[i][j], s));
    }
  }
}

}  // namespace

extern "C" int compose_mm_fwd(const void* base, const void* h, const void* B,
                              const void* gm1, void* out, int m, int n, int r,
                              float s, int dtype, void* stream) {
  const dim3 grid((n + tile::BN - 1) / tile::BN,
                  (m + tile::BM - 1) / tile::BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dtype, T,
                 compose_mm_fwd_kernel<T><<<grid, tile::THREADS, 0, st>>>(
                     static_cast<const T*>(base), static_cast<const T*>(h),
                     static_cast<const T*>(B), static_cast<const float*>(gm1),
                     static_cast<T*>(out), m, n, r, s));
  return static_cast<int>(cudaGetLastError());
}
