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
// Design, bf16 (the model's weights): U runs on the tensor cores as
// warpgroup MMAs (wgmma m64n192k16, bf16 operands read from shared
// memory, fp32 accumulators; a bf16 x bf16 product is exact in fp32, so U
// differs from the reference's fp32 dot only in the order of its sums).
// A block of two warpgroups owns a [128 rows x 192 rank columns] U tile
// over one contiguous range of d_in: W and A tiles of 64 k are staged by
// cp.async into 128-byte-swizzled shared memory in a 4-stage ring (two
// tiles ahead, one k-tile of wgmma in flight), each warpgroup holds its
// [64 x 192] piece of U in registers, and U never reaches memory. The
// epilogue folds U with B per row in fp32; the blocks of rank tile 0 also
// take base_sq from the staged W tiles while the tensor cores run. The
// TPU grid already folds sum_l B ⊙ U_c per d_in chunk
// (factored_norm.py:46); here the chunks are the wrapper's split of d_in
// (kernels/factored_norm.py norm_terms_split), so that row tiles x rank
// tiles x splits puts a block on each of the 132 SMs (4 blocks on wk/wv
// before the split; 164 KB of shared memory and 168 registers a thread
// leave one block per SM). Each block writes its partials to scratch,
// [splits, d_out] for base_sq and [splits x rank tiles, d_out] for cross,
// and a second small kernel sums them in a fixed order: no atomics, the
// result is deterministic.
//
// fp32 and fp16 operands keep the first version's code: one block per
// 64-row tile walking all of d_in, fp32 FMAs on CUDA cores from the
// 16 x 16-thread tile product of common.cuh. fp32 must not go through
// TF32 (about 1e-3 relative in the norm), and the card's fp32 route
// checks run K1 on fp32 weights.
//
// The epilogue (entry point norm_terms_assemble) is the main paths'
// counterpart of repro/kernels/norm_assembly.py:37 assemble_norm_pallas:
// given BG = B32 · (A32 · A32ᵀ) (fp32 [d_out, r], two torch.matmul calls
// in the wrapper, where the reference leaves them to XLA) it takes the
// Gram term ba_sq[j] = sum_l BG[j,l] * B[j,l] and writes
// w_norm[j] = assemble_norm_elem(base_sq[j], cross[j], ba_sq[j]) (the
// arithmetic of K2, common.cuh), so neither K2, nor the [d_out, r] product
// BG ⊙ B, nor its row sum is launched, and base_sq and cross never reach
// memory. An optional base_sq vector (the serving cache) replaces the
// summed base term. Bound on the H100: d_out·r·(4 + 2) bytes of BG and B
// at bf16 plus 12 bytes a row (two sums' partials read, the norm written):
// at w_gate (d_out 18944, r 384) 43.7 MB, 13 us; its operations are
// negligible. Design: a warp per row, because a row's r values are
// contiguous and one thread a row would read them uncoalesced. Lane l sums
// columns l, l + 32, ... in index order (each product rounded, then
// added), a __shfl_xor_sync tree of offsets 16, 8, 4, 2, 1 adds the 32
// lane sums in that fixed order, and lane 0 assembles; base_sq and cross
// are summed exactly as without the epilogue (same code, same order, same
// bits). No atomics: the same bits on every call. On the tensor-core route
// the epilogue replaces the partials' sum kernel (a warp a row instead of
// a thread); on the FMA route the block's 8 warps take its 64 rows after
// the tile loop.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

// K1's optional epilogue; w_norm == nullptr means none.
struct Assembly {
  const float* BG;       // fp32 [d_out, r]: B32 · (A32 · A32ᵀ)
  const float* base_sq;  // fp32 [d_out] override of the base term, or null
  float* w_norm;         // fp32 [d_out] output
  float two_s, s2;
};

// ba_sq of row `row` by the 32 lanes of a warp: lane l sums columns
// l, l + 32, ... in index order, then the xor tree combines the lanes; every
// lane ends with the same bits.
template <typename T>
__device__ __forceinline__ float gram_row_sum(const float* __restrict__ BG,
                                              const T* __restrict__ B,
                                              int row, int r, int lane) {
  const size_t off = static_cast<size_t>(row) * r;
  float p = 0.0f;
  for (int c = lane; c < r; c += 32)
    p = __fadd_rn(p, __fmul_rn(BG[off + c], to_f32(B[off + c])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, o));
  return p;
}

template <typename T>
__global__ void __launch_bounds__(tile::THREADS)
    norm_terms_kernel(const T* __restrict__ W, const T* __restrict__ A,
                      const T* __restrict__ B, float* __restrict__ base_sq,
                      float* __restrict__ cross, int d_out, int d_in, int r,
                      Assembly ep) {
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
  if (ep.w_norm != nullptr) {
    // The epilogue: warp w takes rows w, w + 8, ... of the tile.
    const int lane = tid % 32;
    for (int i = tid / 32; i < BM && row0 + i < d_out; i += THREADS / 32) {
      const int gr = row0 + i;
      const float ba = gram_row_sum(ep.BG, B, gr, r, lane);
      if (lane == 0)
        ep.w_norm[gr] = assemble_norm_elem(
            ep.base_sq != nullptr ? ep.base_sq[gr] : s_base[i], s_cross[i],
            ba, ep.two_s, ep.s2);
    }
  } else if (tid < BM && row0 + tid < d_out) {
    base_sq[row0 + tid] = s_base[tid];
    cross[row0 + tid] = s_cross[tid];
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (wgmma).
// ---------------------------------------------------------------------------
namespace k1 {
constexpr int BM = 128;       // rows of d_out per block: 64 per warpgroup
constexpr int BN = 192;       // rank columns per block (one wgmma's N)
constexpr int BK = 64;        // depth of one staged k-tile: 128-byte rows
constexpr int STAGES = 4;
constexpr int PREF = STAGES - 2;  // tiles loaded ahead; one wgmma in flight
constexpr int THREADS = 256;  // two warpgroups
constexpr int TILE_W = BM * BK * 2, TILE_A = BN * BK * 2;
constexpr int STAGE = TILE_W + TILE_A;
constexpr size_t SMEM = STAGES * STAGE + 1024;  // + 1 KB to align atoms
}  // namespace k1

using bf16 = __nv_bfloat16;
using namespace tc;

__global__ void __launch_bounds__(k1::THREADS, 1)
    norm_terms_mma_kernel(const bf16* __restrict__ W,
                          const bf16* __restrict__ A,
                          const bf16* __restrict__ B,
                          float* __restrict__ part_base,
                          float* __restrict__ part_cross, int d_out,
                          int d_in, int r, int split_k) {
  using namespace k1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  unsigned char* smem = smem_raw + pad;
  const uint32_t sbase = smem_addr(smem);
  const int rt = blockIdx.x, split = blockIdx.z;
  const int row0 = blockIdx.y * BM, n0 = rt * BN;
  const int k_begin = split * split_k;
  const int k_end = min(d_in, k_begin + split_k);
  const int n_k = (k_end - k_begin + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7;

  // One k-tile into stage `st`: W rows row0.. and A rows n0.., 64 k each,
  // K-major and swizzled, as 16-byte chunks (d_in % 8 == 0, so a chunk is
  // all in or all out; the rest are zeros).
  auto load = [&](int st, int k0) {
    unsigned char* sW = smem + st * STAGE;
    unsigned char* sA = sW + TILE_W;
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int c = tid + i * THREADS, row = c / 8, kc = c % 8;
      const int gr = row0 + row, gk = k0 + kc * 8;
      const bool ok = gr < d_out && gk < k_end;
      cp_async16(sW + swz128(row, kc),
                 ok ? W + static_cast<size_t>(gr) * d_in + gk : W, ok);
    }
#pragma unroll
    for (int i = 0; i < BN * 8 / THREADS; ++i) {
      const int c = tid + i * THREADS, row = c / 8, kc = c % 8;
      const int gr = n0 + row, gk = k0 + kc * 8;
      const bool ok = gr < r && gk < k_end;
      cp_async16(sA + swz128(row, kc),
                 ok ? A + static_cast<size_t>(gr) * d_in + gk : A, ok);
    }
  };

  float d[96];  // this warpgroup's U[64 x 192]
#pragma unroll
  for (int i = 0; i < 96; ++i) d[i] = 0.0f;
  float sq = 0.0f;  // base_sq partial: row tid / 2, k half tid % 2

  for (int s = 0; s < PREF; ++s) {
    if (s < n_k) load(s, k_begin + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<PREF - 1>();
    fence_async_smem();
    // Tile kt landed for every thread, and the wgmma of tile kt - 2 is
    // done, so its stage can be refilled.
    wgmma_wait<1>();
    __syncthreads();
    {
      const int nk = kt + PREF;
      if (nk < n_k) load(nk % STAGES, k_begin + nk * BK);
      cp_async_commit();
    }
    const int st = kt % STAGES;
    const uint32_t aW = sbase + st * STAGE + wg * 64 * 128;
    const uint32_t aA = sbase + st * STAGE + TILE_W;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n192k16<0>(d, desc128(aW + kk * 32, 16, 1024),
                          desc128(aA + kk * 32, 16, 1024));
    wgmma_commit();
    if (rt == 0) {
      // base_sq from the staged W tile while the tensor cores run: 32 k
      // per thread, in k order.
      const unsigned char* sW = smem + st * STAGE;
      const int row = tid / 2;
#pragma unroll
      for (int c = (tid % 2) * 4; c < (tid % 2) * 4 + 4; ++c) {
        const Pack<bf16, 8> p =
            *reinterpret_cast<const Pack<bf16, 8>*>(sW + swz128(row, c));
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = __bfloat162float(p.v[e]);
          sq = fmaf(x, x, sq);
        }
      }
    }
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // Fold U with B per row: each lane sums its 48 columns of two rows, the
  // 4 lanes of a quad by shuffles, in a fixed order; a warp owns 16 whole
  // rows of the tile.
  const int g = lane >> 2, q = lane & 3;
  const size_t n_rt = gridDim.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + wg * 64 + (warp & 3) * 16 + g + 8 * h;
    float p = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gn = n0 + 8 * j + 2 * q + e;
        if (gr < d_out && gn < r)
          p = fmaf(__bfloat162float(B[static_cast<size_t>(gr) * r + gn]),
                   d[4 * j + 2 * h + e], p);
      }
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if (q == 0 && gr < d_out)
      part_cross[(split * n_rt + rt) * d_out + gr] = p;
  }
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);
  if (rt == 0 && tid % 2 == 0 && row0 + tid / 2 < d_out)
    part_base[static_cast<size_t>(split) * d_out + row0 + tid / 2] = sq;
}

// base_sq[j] = sum over splits, cross[j] = sum over (split, rank tile),
// each in index order.
__global__ void norm_terms_sum_kernel(const float* __restrict__ part_base,
                                      const float* __restrict__ part_cross,
                                      float* __restrict__ base_sq,
                                      float* __restrict__ cross, int d_out,
                                      int splits, int n_rt) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d_out) return;
  float b = 0.0f, c = 0.0f;
  for (int s = 0; s < splits; ++s)
    b += part_base[static_cast<size_t>(s) * d_out + j];
  for (int p = 0; p < splits * n_rt; ++p)
    c += part_cross[static_cast<size_t>(p) * d_out + j];
  base_sq[j] = b;
  cross[j] = c;
}

// The same sums, a warp a row, ending in the epilogue: lane 0 sums
// base_sq (unless ep.base_sq replaces it) and cross as
// norm_terms_sum_kernel does and assembles the norm.
constexpr int kAssembleRows = 8;  // rows (warps) a block

__global__ void __launch_bounds__(32 * kAssembleRows)
    norm_terms_assemble_kernel(const float* __restrict__ part_base,
                               const float* __restrict__ part_cross,
                               const bf16* __restrict__ B, Assembly ep,
                               int d_out, int r, int splits, int n_rt) {
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * kAssembleRows + threadIdx.x / 32;
  if (j >= d_out) return;
  const float ba = gram_row_sum(ep.BG, B, j, r, lane);
  if (lane != 0) return;
  float b = 0.0f, c = 0.0f;
  if (ep.base_sq != nullptr) {
    b = ep.base_sq[j];
  } else {
    for (int s = 0; s < splits; ++s)
      b += part_base[static_cast<size_t>(s) * d_out + j];
  }
  for (int p = 0; p < splits * n_rt; ++p)
    c += part_cross[static_cast<size_t>(p) * d_out + j];
  ep.w_norm[j] = assemble_norm_elem(b, c, ba, ep.two_s, ep.s2);
}

int norm_terms_bf16(const bf16* W, const bf16* A, const bf16* B,
                    float* base_sq, float* cross, float* scratch, int d_out,
                    int d_in, int r, int split_k, const Assembly& ep,
                    cudaStream_t st) {
  using namespace k1;
  const int splits = (d_in + split_k - 1) / split_k;
  const int n_rt = (r + BN - 1) / BN;
  const int row_tiles = (d_out + BM - 1) / BM;
  if (split_k % BK != 0 || d_in % 8 != 0 || scratch == nullptr ||
      row_tiles > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      norm_terms_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part_base = scratch;
  float* part_cross = scratch + static_cast<size_t>(splits) * d_out;
  norm_terms_mma_kernel<<<dim3(n_rt, row_tiles, splits), THREADS, SMEM, st>>>(
      W, A, B, part_base, part_cross, d_out, d_in, r, split_k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ep.w_norm != nullptr)
    norm_terms_assemble_kernel<<<(d_out + kAssembleRows - 1) / kAssembleRows,
                                 32 * kAssembleRows, 0, st>>>(
        part_base, part_cross, B, ep, d_out, r, splits, n_rt);
  else
    norm_terms_sum_kernel<<<(d_out + 255) / 256, 256, 0, st>>>(
        part_base, part_cross, base_sq, cross, d_out, splits, n_rt);
  return static_cast<int>(cudaGetLastError());
}

int launch_norm_terms(const void* W, const void* A, const void* B,
                      void* base_sq, void* cross, void* scratch, int d_out,
                      int d_in, int r, int split_k, int dtype,
                      const Assembly& ep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16 && split_k > 0)
    return norm_terms_bf16(
        static_cast<const bf16*>(W), static_cast<const bf16*>(A),
        static_cast<const bf16*>(B), static_cast<float*>(base_sq),
        static_cast<float*>(cross), static_cast<float*>(scratch), d_out, d_in,
        r, split_k, ep, st);
  const dim3 grid((d_out + tile::BM - 1) / tile::BM);
  DISPATCH_DTYPE(dtype, T,
                 norm_terms_kernel<T><<<grid, tile::THREADS, 0, st>>>(
                     static_cast<const T*>(W), static_cast<const T*>(A),
                     static_cast<const T*>(B), static_cast<float*>(base_sq),
                     static_cast<float*>(cross), d_out, d_in, r, ep));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// split_k > 0 with bf16 operands takes the tensor-core kernel over d_in
// ranges of split_k (a multiple of 64), with `scratch` holding
// splits x (1 + ceil(r / 192)) x d_out floats; anything else runs the
// FMA kernel, which needs no scratch.
extern "C" int norm_terms(const void* W, const void* A, const void* B,
                          void* base_sq, void* cross, void* scratch,
                          int d_out, int d_in, int r, int split_k, int dtype,
                          void* stream) {
  return launch_norm_terms(W, A, B, base_sq, cross, scratch, d_out, d_in, r,
                           split_k, dtype, Assembly{}, stream);
}

// The same, ending in the epilogue: w_norm [d_out] from BG [d_out, r]
// (fp32) and, where base_sq is not null, that base term.
extern "C" int norm_terms_assemble(const void* W, const void* A,
                                   const void* B, const void* BG,
                                   const void* base_sq, void* w_norm,
                                   void* scratch, int d_out, int d_in, int r,
                                   int split_k, int dtype, float two_s,
                                   float s2, void* stream) {
  if (w_norm == nullptr || BG == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Assembly ep{static_cast<const float*>(BG),
                    static_cast<const float*>(base_sq),
                    static_cast<float*>(w_norm), two_s, s2};
  return launch_norm_terms(W, A, B, nullptr, nullptr, scratch, d_out, d_in,
                           r, split_k, dtype, ep, stream);
}

// The error text for a code an entry point returned (defined once, here,
// for the whole library).
extern "C" const char* runtime_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
