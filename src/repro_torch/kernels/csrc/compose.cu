// K3: the element-wise stable DoRA compose, forward only (no inner save).
//
// Replaces the TPU kernel repro/kernels/dora_compose.py:106
// compose_fwd_pallas with save_inner=False (_fwd_kernel):
//
//   delta = gm1 ⊙ base + (gm1 + 1) ⊙ (s · lora)
//
// for base, lora [M, N] in the activation dtype and gm1 = g - 1 an fp32
// [N] vector broadcast over rows.
//
// Bound on the H100: memory. Two [M, N] reads and one write, about 1.5
// operations a byte, far below the card's ~295 operations a byte.
// Design: the rows are flattened and each thread moves 16 bytes of each
// tensor per step (8 bf16 or 4 fp32 values) with vector loads and
// stores, in a grid-stride loop; the tail is masked by the loop bound, so
// no rows are padded. A vector never crosses a row because the wrapper
// picks the vector width only when N is a multiple of it (else width 1).
// The epilogue is compose_elem's pinned, FMA-free order.
#include "common.cuh"

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void compose_fwd_kernel(const T* __restrict__ base,
                                   const T* __restrict__ lora,
                                   const float* __restrict__ gm1,
                                   T* __restrict__ out, long long n_packs,
                                   int packs_per_row, float s) {
  using P = Pack<T, VEC>;
  const P* bp = reinterpret_cast<const P*>(base);
  const P* lp = reinterpret_cast<const P*>(lora);
  P* op = reinterpret_cast<P*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < n_packs; p += stride) {
    const int col0 = static_cast<int>(p % packs_per_row) * VEC;
    const P b = bp[p];
    const P l = lp[p];
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f32<T>(
          compose_elem(gm1[col0 + e], to_f32(b.v[e]), to_f32(l.v[e]), s));
    op[p] = o;
  }
}

template <typename T, int VEC>
void launch(const void* base, const void* lora, const void* gm1, void* out,
            long long m, int n, float s, cudaStream_t st) {
  constexpr int kThreads = 256;
  const long long n_packs = m * n / VEC;
  long long blocks = (n_packs + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
  if (blocks < 1) blocks = 1;
  compose_fwd_kernel<T, VEC><<<static_cast<int>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(base), static_cast<const T*>(lora),
      static_cast<const float*>(gm1), static_cast<T*>(out), n_packs, n / VEC,
      s);
}

}  // namespace

// vec: elements per thread step, 16 / sizeof(T) or 1 (chosen by the
// wrapper from N and the pointers' alignment).
extern "C" int compose_fwd(const void* base, const void* lora,
                           const void* gm1, void* out, long long m, int n,
                           float s, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dtype, T, {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    if (vec == kVec)
      launch<T, kVec>(base, lora, gm1, out, m, n, s, st);
    else if (vec == 1)
      launch<T, 1>(base, lora, gm1, out, m, n, s, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  });
  return static_cast<int>(cudaGetLastError());
}
