// K5: the element-wise stable DoRA compose backward.
//
// Replaces the TPU kernel repro/kernels/dora_compose.py:136
// compose_bwd_pallas (_bwd_kernel):
//
//   d_base = gm1 ⊙ dY,    d_lora = gs ⊙ dY
//
// for dY [M, N] in the activation dtype and gm1 = g - 1, gs = g·s fp32
// [N] vectors broadcast over rows; both outputs in dY's dtype. The
// magnitude gradient d_g = Σ_rows dY ⊙ inner is a separate deterministic
// reduction in the caller (paper §3.2: a sum, not atomics).
//
// Bound on the H100: memory. One [M, N] read and two writes, two
// multiplies an element. At qwen2-7b w_gate training rows (4096 x 18944,
// bf16) the three passes are 466 MB: 0.139 ms at 3.35 TB/s.
// Design: K3's — rows flattened, 16-byte vectors per thread in a
// grid-stride loop, the tail masked by the loop bound, vector width 1
// when N or a pointer does not allow 16 bytes. Each product is one
// correctly rounded fp32 multiply (__fmul_rn), then one rounding to the
// output dtype, so both outputs are bitwise those of the plain version.
#include "common.cuh"

namespace {

template <typename T, int VEC>
__global__ void compose_bwd_kernel(const T* __restrict__ dy,
                                   const float* __restrict__ gm1,
                                   const float* __restrict__ gs,
                                   T* __restrict__ d_base,
                                   T* __restrict__ d_lora, long long n_packs,
                                   int packs_per_row) {
  using P = Pack<T, VEC>;
  const P* dp = reinterpret_cast<const P*>(dy);
  P* bp = reinterpret_cast<P*>(d_base);
  P* lp = reinterpret_cast<P*>(d_lora);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < n_packs; p += stride) {
    const int col0 = static_cast<int>(p % packs_per_row) * VEC;
    const P d = dp[p];
    P b, l;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float v = to_f32(d.v[e]);
      b.v[e] = from_f32<T>(__fmul_rn(gm1[col0 + e], v));
      l.v[e] = from_f32<T>(__fmul_rn(gs[col0 + e], v));
    }
    bp[p] = b;
    lp[p] = l;
  }
}

}  // namespace

// vec: elements per thread step, 16 / sizeof(T) or 1 (chosen by the
// wrapper from N and the pointers' alignment).
extern "C" int compose_bwd(const void* dy, const void* gm1, const void* gs,
                           void* d_base, void* d_lora, long long m, int n,
                           int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dtype, T, {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const long long elems = m * n;
    if (vec == kVec)
      compose_bwd_kernel<T, kVec><<<stride_blocks(elems / kVec), 256, 0, st>>>(
          static_cast<const T*>(dy), static_cast<const float*>(gm1),
          static_cast<const float*>(gs), static_cast<T*>(d_base),
          static_cast<T*>(d_lora), elems / kVec, n / kVec);
    else if (vec == 1)
      compose_bwd_kernel<T, 1><<<stride_blocks(elems), 256, 0, st>>>(
          static_cast<const T*>(dy), static_cast<const float*>(gm1),
          static_cast<const float*>(gs), static_cast<T*>(d_base),
          static_cast<T*>(d_lora), elems, n);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  });
  return static_cast<int>(cudaGetLastError());
}
