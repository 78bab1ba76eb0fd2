// K7: the matmul-fused stable DoRA compose backward.
//
// Replaces the TPU kernel repro/kernels/dora_compose.py:239
// compose_mm_bwd_pallas (_mm_bwd_kernel). In one pass over dY:
//
//   d_base = gm1 ⊙ dY                      [M, N], dY's dtype
//   d_h    = (gs ⊙ dY) · B                 [M, r], fp32, summed over N
//
// for dY [M, N], B [N, r] in the activation dtype and gm1 = g - 1,
// gs = g·s fp32 [N]. d_B and d_g come outside the kernel, from the cross
// product T = dYᵀ·h (repro/kernels/ops.py:204-220).
//
// Bound on the H100: at qwen2-7b w_gate training rows (M = 4096,
// N = 18944, r = 384, bf16) the function reads dY (155 MB) and writes
// d_base (155 MB), with B and d_h small beside them: 0.095 ms at
// 3.35 TB/s, against 60 GFLOP that bf16 tensor cores would do in
// 0.060 ms — bound by memory, if the product ran on the tensor cores.
//
// Design: the TPU grid carries the d_h tile across its sequential d_out
// axis. On Hopper blocks run in no order, so each block owns one
// [64 rows x 64 rank columns] tile of d_h and walks all of N itself, in
// 16-deep chunks: the sum over N never crosses blocks, so there are no
// atomics and no second pass, and d_h is deterministic (paper §3.2's
// choice). Tiling the rank as well gives ceil(M/64)·ceil(r/64) blocks
// (384 at 4096 x 384), enough to fill the 132 SMs where one block per row
// tile would give 64. The dY chunk is scaled by gs while it is staged to
// shared memory (one __fmul_rn, the plain version's rounding); the blocks
// of the first rank tile also write d_base = gm1·dY from the same load,
// so every d_base element is written exactly once. The product is fp32
// FMA on CUDA cores (no TF32), as in K6: the simple first version, bound
// by CUDA-core operations until a later change moves it to the tensor
// cores. dY is read once per rank tile (six times at r = 384); the
// re-reads of one row tile's blocks mostly come from L2.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(tile::THREADS)
    compose_mm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ B,
                          const float* __restrict__ gm1,
                          const float* __restrict__ gs,
                          T* __restrict__ d_base, float* __restrict__ d_h,
                          int m, int n, int r) {
  using namespace tile;
  __shared__ __align__(16) float sX[BK][BM + 4];   // gs·dY chunk, k-major
  __shared__ __align__(16) float sY[BK][BN + 4];   // B chunk [k][rank col]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const bool write_d_base = blockIdx.x == 0;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    // Consecutive threads read consecutive columns of one dY row.
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int row = e / BK, k = e % BK;
      const int gr = m0 + row, gk = k0 + k;
      float v = 0.0f;
      if (gr < m && gk < n) {
        const size_t idx = static_cast<size_t>(gr) * n + gk;
        const float d = to_f32(dy[idx]);
        v = __fmul_rn(gs[gk], d);
        if (write_d_base) d_base[idx] = from_f32<T>(__fmul_rn(gm1[gk], d));
      }
      sX[k][row] = v;
    }
    // Consecutive threads read consecutive rank columns of one B row.
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, c = e % BN;
      const int gk = k0 + k, gc = c0 + c;
      sY[k][c] = (gk < n && gc < r)
                     ? to_f32(B[static_cast<size_t>(gk) * r + gc])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sX[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&sY[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx * TN + j;
      if (col < r) d_h[static_cast<size_t>(row) * r + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int compose_mm_bwd(const void* dy, const void* B, const void* gm1,
                              const void* gs, void* d_base, void* d_h, int m,
                              int n, int r, int dtype, void* stream) {
  const dim3 grid((r + tile::BN - 1) / tile::BN,
                  (m + tile::BM - 1) / tile::BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dtype, T,
                 compose_mm_bwd_kernel<T><<<grid, tile::THREADS, 0, st>>>(
                     static_cast<const T*>(dy), static_cast<const T*>(B),
                     static_cast<const float*>(gm1),
                     static_cast<const float*>(gs), static_cast<T*>(d_base),
                     static_cast<float*>(d_h), m, n, r));
  return static_cast<int>(cudaGetLastError());
}
