// K1: the two d_in-dependent factored-norm terms in one pass over W.
//
// Replaces the TPU kernel repro/kernels/factored_norm.py:49
// norm_terms_pallas (_norm_terms_kernel). For W [d_out, d_in],
// A [r, d_in], B [d_out, r]:
//
//   base_sq[j] = sum_k W[j,k]^2
//   cross[j]   = sum_l B[j,l] * U[j,l],   U = W · Aᵀ
//
// Bound on the H100: U is 2·d_out·d_in·r operations against a read of W
// once. For qwen2-7b w_gate (W [18944, 3584], r = 384, bf16) that is
// 52 GFLOP against 136 MB: max(41 us of bytes, 53 us of bf16 tensor-core
// operations), so the kernel is bound by operations.
//
// Design: the TPU grid (d_out tiles parallel x d_in chunks sequential)
// becomes one block per 64-row tile of d_out with the d_in walk as a loop
// inside the block, so no sum crosses blocks: no atomics, and the result
// is deterministic. The U tile [64, 64] lives in registers (4 x 4 per
// thread) and never reaches memory; the block walks the rank in 64-wide
// tiles, folds each U tile into the per-row cross partial with B, and
// takes base_sq from the W tiles staged for the first rank tile. The
// products are fp32 FMAs on CUDA cores (no TF32): this first version is
// right and simple, and leaves the tensor cores (mma.sync / wgmma) to a
// later change. FMA accumulation is accepted here because the reference's
// MXU dot also accumulates in fp32 in an order of its own.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(tile::THREADS)
    norm_terms_kernel(const T* __restrict__ W, const T* __restrict__ A,
                      const T* __restrict__ B, float* __restrict__ base_sq,
                      float* __restrict__ cross, int d_out, int d_in, int r) {
  using namespace tile;
  __shared__ __align__(16) float sX[BK][BM + 4];
  __shared__ __align__(16) float sY[BK][BN + 4];
  __shared__ float s_base[BM];
  __shared__ float s_cross[BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * BM;
  if (tid < BM) {
    s_base[tid] = 0.0f;
    s_cross[tid] = 0.0f;
  }
  __syncthreads();

  float acc[TM][TN];
  for (int n0 = 0; n0 < r; n0 += BN) {
    if (n0 == 0)
      tile_product_nt<T, true>(W, d_out, row0, A, r, n0, d_in, acc, sX, sY,
                               s_base);
    else
      tile_product_nt<T, false>(W, d_out, row0, A, r, n0, d_in, acc, sX, sY,
                                s_base);
    // cross partial of this rank tile: each thread folds its 4 x 4 U block
    // with B, then the 16 threads sharing a row (one half-warp) reduce by
    // shuffles, and lane tx == 0 — the row's only writer — adds the sum.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + ty * TM + i;
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx * TN + j;
        if (gr < d_out && gn < r)
          p = fmaf(to_f32(B[static_cast<size_t>(gr) * r + gn]), acc[i][j], p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (tx == 0) s_cross[ty * TM + i] += p;
    }
  }
  __syncthreads();
  if (tid < BM && row0 + tid < d_out) {
    base_sq[row0 + tid] = s_base[tid];
    cross[row0 + tid] = s_cross[tid];
  }
}

}  // namespace

extern "C" int norm_terms(const void* W, const void* A, const void* B,
                          void* base_sq, void* cross, int d_out, int d_in,
                          int r, int dtype, void* stream) {
  const dim3 grid((d_out + tile::BM - 1) / tile::BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dtype, T,
                 norm_terms_kernel<T><<<grid, tile::THREADS, 0, st>>>(
                     static_cast<const T*>(W), static_cast<const T*>(A),
                     static_cast<const T*>(B), static_cast<float*>(base_sq),
                     static_cast<float*>(cross), d_out, d_in, r));
  return static_cast<int>(cudaGetLastError());
}

// The error text for a code an entry point returned (defined once, here,
// for the whole library).
extern "C" const char* runtime_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
