// Shared pieces of the port's hand-written Hopper kernels: dtype
// conversion, the pinned-order compose epilogue and norm assembly, and the
// FMA tile product that only the fp32/fp16 routes (and bf16 operands the
// tensor-core routes do not take) of the factored-norm kernel
// (norm_terms.cu) and the matmul-fused compose (compose_mm.cu) still run;
// their bf16 products are warpgroup MMAs (wgmma.cuh).
//
// Built with nvcc for sm_90a into one shared library with a plain C
// interface (see ../_build.py). Every entry point launches on the stream it
// is given and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element type codes shared with the Python wrappers (_build.DTYPE_CODE).
enum DTypeCode { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Stable DoRA compose of one element (paper §3.1), in the reference's
// pinned order: t = s*lora first, then gm1*base + (gm1 + 1)*t. The
// round-to-nearest intrinsics keep nvcc from contracting a*b + c into an
// FMA, which would round differently from the reference. compose_elem_t
// takes the rounded t = __fmul_rn(s, lora) itself, for the dual-output
// forward that also writes inner = base + t.
__device__ __forceinline__ float compose_elem_t(float gm1, float base,
                                                float t) {
  return __fadd_rn(__fmul_rn(gm1, base), __fmul_rn(__fadd_rn(gm1, 1.0f), t));
}

__device__ __forceinline__ float compose_elem(float gm1, float base,
                                              float lora, float s) {
  return compose_elem_t(gm1, base, __fmul_rn(s, lora));
}

// Norm assembly of one row (paper Eq. 5), in the reference's pinned order:
// sqrt(max((base_sq + two_s*cross) + s2*ba_sq, 0)). The round-to-nearest
// intrinsics keep nvcc from contracting the adds into FMAs; the max
// propagates NaN (fmaxf would turn NaN into 0); the sqrt is the correctly
// rounded __fsqrt_rn (the library is built without --use_fast_math). K2
// (assemble_norm.cu) and K1's epilogue (norm_terms.cu) both call it.
__device__ __forceinline__ float assemble_norm_elem(float base_sq,
                                                    float cross, float ba_sq,
                                                    float two_s, float s2) {
  float acc = __fadd_rn(base_sq, __fmul_rn(two_s, cross));
  acc = __fadd_rn(acc, __fmul_rn(s2, ba_sq));
  const float clamped = (acc != acc) ? acc : (acc > 0.0f ? acc : 0.0f);
  return __fsqrt_rn(clamped);
}

// VEC elements of T moved as one aligned vector (16 bytes when
// VEC = 16 / sizeof(T)) by the element-wise kernels.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Blocks for a grid-stride loop over `work` items of 256 threads: one
// block per 256 items, at most 16 blocks per SM of the H100's 132.
inline int stride_blocks(long long work) {
  long long blocks = (work + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

// Run `body` with T bound to the element type of `code`; an unknown code
// returns cudaErrorInvalidValue from the enclosing entry point.
#define DISPATCH_DTYPE(code, T, ...)                 \
  switch (code) {                                    \
    case DT_F32: {                                   \
      using T = float;                               \
      __VA_ARGS__;                                   \
      break;                                         \
    }                                                \
    case DT_BF16: {                                  \
      using T = __nv_bfloat16;                       \
      __VA_ARGS__;                                   \
      break;                                         \
    }                                                \
    case DT_F16: {                                   \
      using T = __half;                              \
      __VA_ARGS__;                                   \
      break;                                         \
    }                                                \
    default:                                         \
      return static_cast<int>(cudaErrorInvalidValue); \
  }

// ---------------------------------------------------------------------------
// FMA tile product C[BM, BN] = X[x0:x0+BM, :K] · Y[y0:y0+BN, :K]ᵀ for
// row-major X [x_rows, K] and Y [y_rows, K] (K contiguous in both, as W/A
// in the norm and h/B in the compose are). 256 threads as a 16 x 16 grid;
// thread (ty, tx) owns rows ty*TM.. and columns tx*TN.. of the tile. K is
// walked in BK-deep chunks staged through shared memory as fp32, so every
// product is an fp32 FMA of exactly converted inputs (no TF32). Ragged
// edges load zeros, which perturb no sum.
//
// With ROW_SQ, threads 0..BM-1 also accumulate sum_k X[row, k]^2 of their
// row into row_sq[tid], in k order, from the same staged X tile: one read
// of W serves both factored-norm terms.
// ---------------------------------------------------------------------------
namespace tile {
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = 256;
static_assert((BM / TM) * (BN / TN) == THREADS, "thread grid");
static_assert(TM == 4 && TN == 4, "float4 fragment loads");
}  // namespace tile

template <typename T, bool ROW_SQ>
__device__ __forceinline__ void tile_product_nt(
    const T* __restrict__ X, int x_rows, int x0, const T* __restrict__ Y,
    int y_rows, int y0, int K, float (&acc)[tile::TM][tile::TN],
    float (*sX)[tile::BM + 4], float (*sY)[tile::BN + 4], float* row_sq) {
  using namespace tile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage the X and Y chunks, transposed to k-major. Consecutive threads
    // read consecutive k of one row.
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      const int gr = x0 + r, gk = k0 + k;
      sX[k][r] = (gr < x_rows && gk < K)
                     ? to_f32(X[static_cast<size_t>(gr) * K + gk])
                     : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      const int gr = y0 + r, gk = k0 + k;
      sY[k][r] = (gr < y_rows && gk < K)
                     ? to_f32(Y[static_cast<size_t>(gr) * K + gk])
                     : 0.0f;
    }
    __syncthreads();
    if (ROW_SQ && tid < BM) {
      float sq = row_sq[tid];
#pragma unroll
      for (int k = 0; k < BK; ++k) sq = fmaf(sX[k][tid], sX[k][tid], sq);
      row_sq[tid] = sq;
    }
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
}
