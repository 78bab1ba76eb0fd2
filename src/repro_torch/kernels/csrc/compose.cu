// K3 and K4: the element-wise stable DoRA compose forward, without and
// with the saved inner tensor.
//
// Replaces the TPU kernel repro/kernels/dora_compose.py:106
// compose_fwd_pallas: K3 is save_inner=False (_fwd_kernel), K4 is
// save_inner=True (_fwd_kernel_dual):
//
//   t     = s · lora
//   delta = gm1 ⊙ base + (gm1 + 1) ⊙ t
//   inner = base + t                      (K4 only)
//
// for base, lora [M, N] in the activation dtype and gm1 = g - 1 an fp32
// [N] vector broadcast over rows. inner is the residual the magnitude
// gradient reads in the backward (d_g = Σ_rows dY ⊙ inner).
//
// Bound on the H100: memory. K3 moves two [M, N] reads and one write, K4
// one write more, about 1.5 operations a byte, far below the card's ~295
// operations a byte. At qwen2-7b w_gate training rows (4096 x 18944,
// bf16) K4's four passes are 621 MB: 0.185 ms at 3.35 TB/s.
// Design: the rows are flattened and each thread moves 16 bytes of each
// tensor per step (8 bf16 or 4 fp32 values) with vector loads and
// stores, in a grid-stride loop; the tail is masked by the loop bound, so
// no rows are padded. A vector never crosses a row because the wrapper
// picks the vector width only when N is a multiple of it (else width 1).
// The epilogue is compose_elem_t's pinned, FMA-free order; inner adds the
// same rounded t with __fadd_rn, so both outputs are bitwise those of the
// plain PyTorch version.
#include "common.cuh"

namespace {

template <typename T, int VEC, bool DUAL>
__global__ void compose_fwd_kernel(const T* __restrict__ base,
                                   const T* __restrict__ lora,
                                   const float* __restrict__ gm1,
                                   T* __restrict__ out, T* __restrict__ inner,
                                   long long n_packs, int packs_per_row,
                                   float s) {
  using P = Pack<T, VEC>;
  const P* bp = reinterpret_cast<const P*>(base);
  const P* lp = reinterpret_cast<const P*>(lora);
  P* op = reinterpret_cast<P*>(out);
  P* ip = reinterpret_cast<P*>(inner);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < n_packs; p += stride) {
    const int col0 = static_cast<int>(p % packs_per_row) * VEC;
    const P b = bp[p];
    const P l = lp[p];
    P o, q;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float bf = to_f32(b.v[e]);
      const float t = __fmul_rn(s, to_f32(l.v[e]));
      o.v[e] = from_f32<T>(compose_elem_t(gm1[col0 + e], bf, t));
      if (DUAL) q.v[e] = from_f32<T>(__fadd_rn(bf, t));
    }
    op[p] = o;
    if (DUAL) ip[p] = q;
  }
}

template <bool DUAL>
int launch(const void* base, const void* lora, const void* gm1, void* out,
           void* inner, long long m, int n, float s, int vec, int dtype,
           cudaStream_t st) {
  DISPATCH_DTYPE(dtype, T, {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const long long elems = m * n;
    if (vec == kVec)
      compose_fwd_kernel<T, kVec, DUAL>
          <<<stride_blocks(elems / kVec), 256, 0, st>>>(
              static_cast<const T*>(base), static_cast<const T*>(lora),
              static_cast<const float*>(gm1), static_cast<T*>(out),
              static_cast<T*>(inner), elems / kVec, n / kVec, s);
    else if (vec == 1)
      compose_fwd_kernel<T, 1, DUAL><<<stride_blocks(elems), 256, 0, st>>>(
          static_cast<const T*>(base), static_cast<const T*>(lora),
          static_cast<const float*>(gm1), static_cast<T*>(out),
          static_cast<T*>(inner), elems, n, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: elements per thread step, 16 / sizeof(T) or 1 (chosen by the
// wrapper from N and the pointers' alignment).
extern "C" int compose_fwd(const void* base, const void* lora,
                           const void* gm1, void* out, long long m, int n,
                           float s, int vec, int dtype, void* stream) {
  return launch<false>(base, lora, gm1, out, nullptr, m, n, s, vec, dtype,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int compose_fwd_dual(const void* base, const void* lora,
                                const void* gm1, void* out, void* inner,
                                long long m, int n, float s, int vec,
                                int dtype, void* stream) {
  return launch<true>(base, lora, gm1, out, inner, m, n, s, vec, dtype,
                      static_cast<cudaStream_t>(stream));
}
