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
// 3.35 TB/s. The bf16 route below runs two bf16 products (hi and lo,
// 2 x 60 GFLOP: 0.120 ms at 989 TFLOP/s), so its bound is the
// operations, 0.12 ms.
//
// Design, bf16 (the training path): the product runs on the tensor cores
// as warpgroup MMAs (wgmma m64n192k16, operands read from shared memory,
// fp32 accumulators). Its operand t = gs ⊙ dY is fp32 in the reference
// (dora_compose.py:204), and rounding it to bf16 would cost about 2^-9
// relative in d_h, so t is split: hi = bf16(t), lo = bf16(t - hi), and
// d_h accumulates hi·B + lo·B (B is bf16, so both products are exact in
// fp32; what is left is |t - hi - lo| <= 2^-17 |t|). t keeps the plain
// version's __fmul_rn rounding, and d_base = bf16(gm1·dY) comes from the
// same staged dY, so d_base is bitwise the plain version's. A block of
// two warpgroups owns a [128 rows x 192 rank columns] d_h tile (dY is
// read twice at r = 384, the second time mostly from L2) over one
// contiguous range of N: dY and B tiles of 64 k are staged by cp.async
// into 128-byte-swizzled shared memory in a 4-stage ring (B row-major,
// read by wgmma as an MN-major operand), the 256 threads turn the dY tile
// into swizzled hi and lo tiles (and, in rank tile 0, write its d_base)
// while the previous tile's wgmma runs, and each warpgroup holds its
// [64 x 192] piece of d_h in registers. The wrapper splits N
// (kernels/dora_compose.py compose_mm_bwd_split) so that row tiles x rank
// tiles x splits puts a block on each of the 132 SMs (64 blocks at
// M = 4096 before the split; 225 KB of shared memory leave one block per
// SM); each split writes its [M, r] partial to scratch and a second
// kernel sums them in split order: no atomics, deterministic. Every
// d_base element is written once, by the rank-tile-0 block of its split.
//
// fp32 and fp16 dY keep the first version's code: each block owns one
// [64 rows x 64 rank columns] tile of d_h and walks all of N in 16-deep
// chunks with fp32 FMAs on CUDA cores (no TF32), the blocks of the first
// rank tile writing d_base.
#include "common.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (wgmma), t split into hi + lo.
// ---------------------------------------------------------------------------
namespace k7 {
constexpr int BM = 128;       // rows of dY per block: 64 per warpgroup
constexpr int BN = 192;       // rank columns per block (one wgmma's N)
constexpr int BK = 64;        // depth (columns of dY) of one staged tile
constexpr int STAGES = 4;
constexpr int PREF = STAGES - 2;  // tiles loaded ahead; one wgmma in flight
constexpr int THREADS = 256;  // two warpgroups
constexpr int TILE_D = BM * BK * 2;  // dY, K-major, swizzled
constexpr int TILE_B = BK * BN * 2;  // B, MN-major: 3 blocks of 64 columns
constexpr int STAGE = TILE_D + TILE_B;
constexpr int TILE_H = BM * BK * 2;  // one of hi / lo
// The ring, two (hi, lo) pairs, and 1 KB to align atoms: 230,400 bytes.
constexpr size_t SMEM = STAGES * STAGE + 2 * 2 * TILE_H + 1024;
}  // namespace k7

using bf16 = __nv_bfloat16;
using namespace tc;

__global__ void __launch_bounds__(k7::THREADS, 1)
    compose_mm_bwd_mma_kernel(const bf16* __restrict__ dy,
                              const bf16* __restrict__ B,
                              const float* __restrict__ gm1,
                              const float* __restrict__ gs,
                              bf16* __restrict__ d_base,
                              float* __restrict__ out, int m, int n, int r,
                              int split_n) {
  using namespace k7;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  unsigned char* smem = smem_raw + pad;
  const uint32_t sbase = smem_addr(smem);
  const int rt = blockIdx.x, split = blockIdx.z;
  const int m0 = blockIdx.y * BM, c0 = rt * BN;
  const int k_begin = split * split_n;
  const int k_end = min(n, k_begin + split_n);
  const int n_k = (k_end - k_begin + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7;

  // One k-tile into stage `st` as 16-byte chunks (n % 8 == 0 and
  // r % 8 == 0, so a chunk is all in or all out; the rest are zeros): dY
  // rows K-major; B rows (k) MN-major, 64 columns to a 128-byte row, the
  // three 64-column blocks 8 KB apart.
  auto load = [&](int st, int k0) {
    unsigned char* sD = smem + st * STAGE;
    unsigned char* sB = sD + TILE_D;
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int c = tid + i * THREADS, row = c / 8, kc = c % 8;
      const int gr = m0 + row, gk = k0 + kc * 8;
      const bool ok = gr < m && gk < k_end;
      cp_async16(sD + swz128(row, kc),
                 ok ? dy + static_cast<size_t>(gr) * n + gk : dy, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * (BN / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS, kr = c / (BN / 8), nc = c % (BN / 8);
      const int gk = k0 + kr, gc = c0 + nc * 8;
      const bool ok = gk < k_end && gc < r;
      cp_async16(sB + (nc / 8) * (BK * 128) + swz128(kr, nc % 8),
                 ok ? B + static_cast<size_t>(gk) * r + gc : B, ok);
    }
  };

  float d[96];  // this warpgroup's d_h[64 x 192]
#pragma unroll
  for (int i = 0; i < 96; ++i) d[i] = 0.0f;

  for (int s = 0; s < PREF; ++s) {
    if (s < n_k) load(s, k_begin + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<PREF - 1>();
    fence_async_smem();
    // Tile kt landed for every thread, and the wgmma of tile kt - 2 is
    // done, so its stage and its (hi, lo) pair can be refilled.
    wgmma_wait<1>();
    __syncthreads();
    {
      const int nk = kt + PREF;
      if (nk < n_k) load(nk % STAGES, k_begin + nk * BK);
      cp_async_commit();
    }
    const int st = kt % STAGES;
    const unsigned char* sD = smem + st * STAGE;
    unsigned char* sHi = smem + STAGES * STAGE + (kt % 2) * 2 * TILE_H;
    unsigned char* sLo = sHi + TILE_H;

    // t = gs·dY in fp32 (the plain version's rounding), split into bf16
    // hi + lo; d_base = bf16(gm1·dY) from the same values. Overlaps the
    // wgmma of tile kt - 1.
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int c = tid + i * THREADS, row = c / 8, kc = c % 8;
      const int gr = m0 + row, gk = k_begin + kt * BK + kc * 8;
      Pack<bf16, 8> hi, lo;
      if (gr < m && gk < k_end) {
        const Pack<bf16, 8> dv =
            *reinterpret_cast<const Pack<bf16, 8>*>(sD + swz128(row, kc));
        const float4 s0 = *reinterpret_cast<const float4*>(gs + gk);
        const float4 s1 = *reinterpret_cast<const float4*>(gs + gk + 4);
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = __fmul_rn(sv[e], __bfloat162float(dv.v[e]));
          hi.v[e] = __float2bfloat16_rn(t);
          lo.v[e] = __float2bfloat16_rn(
              __fsub_rn(t, __bfloat162float(hi.v[e])));
        }
        if (rt == 0) {
          const float4 g0 = *reinterpret_cast<const float4*>(gm1 + gk);
          const float4 g1 = *reinterpret_cast<const float4*>(gm1 + gk + 4);
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w,
                               g1.x, g1.y, g1.z, g1.w};
          Pack<bf16, 8> db;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            db.v[e] = __float2bfloat16_rn(
                __fmul_rn(gv[e], __bfloat162float(dv.v[e])));
          *reinterpret_cast<Pack<bf16, 8>*>(
              d_base + static_cast<size_t>(gr) * n + gk) = db;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          hi.v[e] = lo.v[e] = __float2bfloat16_rn(0.0f);
      }
      *reinterpret_cast<Pack<bf16, 8>*>(sHi + swz128(row, kc)) = hi;
      *reinterpret_cast<Pack<bf16, 8>*>(sLo + swz128(row, kc)) = lo;
    }
    fence_async_smem();
    __syncthreads();

    const uint32_t aHi = smem_addr(sHi) + wg * 64 * 128;
    const uint32_t aLo = smem_addr(sLo) + wg * 64 * 128;
    const uint32_t aB = sbase + st * STAGE + TILE_D;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = desc128(aB + kk * 16 * 128, BK * 128, 1024);
      wgmma_m64n192k16<1>(d, desc128(aHi + kk * 32, 16, 1024), db);
      wgmma_m64n192k16<1>(d, desc128(aLo + kk * 32, 16, 1024), db);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // This split's d_h tile: out is d_h itself for one split, else the
  // split's [M, r] slice of the scratch.
  float* o = out + static_cast<size_t>(split) * m * r;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + (warp & 3) * 16 + g + 8 * h;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * q;
      if (col < r)
        *reinterpret_cast<float2*>(o + static_cast<size_t>(row) * r + col) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// d_h[i] = sum over splits of part[s][i], in split order; four floats
// per thread (M·r % 4 == 0).
__global__ void compose_mm_bwd_sum_kernel(const float4* __restrict__ part,
                                  float4* __restrict__ d_h, long long count4,
                                  int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 a = part[i];
    for (int s = 1; s < splits; ++s) {
      const float4 b = part[s * count4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    d_h[i] = a;
  }
}

int compose_mm_bwd_bf16(const bf16* dy, const bf16* B, const float* gm1,
                        const float* gs, bf16* d_base, float* d_h,
                        float* scratch, int m, int n, int r, int split_n,
                        cudaStream_t st) {
  using namespace k7;
  const int splits = (n + split_n - 1) / split_n;
  const int row_tiles = (m + BM - 1) / BM;
  if (split_n % BK != 0 || n % 8 != 0 || r % 8 != 0 || row_tiles > 65535 ||
      splits > 65535 || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      compose_mm_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((r + BN - 1) / BN, row_tiles, splits);
  compose_mm_bwd_mma_kernel<<<grid, THREADS, SMEM, st>>>(
      dy, B, gm1, gs, d_base, splits > 1 ? scratch : d_h, m, n, r, split_n);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count4 = static_cast<long long>(m) * r / 4;
  compose_mm_bwd_sum_kernel<<<stride_blocks(count4), 256, 0, st>>>(
      reinterpret_cast<const float4*>(scratch),
      reinterpret_cast<float4*>(d_h), count4, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// split_n > 0 with bf16 operands takes the tensor-core kernel over N
// ranges of split_n (a multiple of 64), with `scratch` holding
// splits x M x r floats when there is more than one split; anything else
// runs the FMA kernel, which needs no scratch.
extern "C" int compose_mm_bwd(const void* dy, const void* B, const void* gm1,
                              const void* gs, void* d_base, void* d_h,
                              void* scratch, int m, int n, int r, int split_n,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16 && split_n > 0)
    return compose_mm_bwd_bf16(
        static_cast<const bf16*>(dy), static_cast<const bf16*>(B),
        static_cast<const float*>(gm1), static_cast<const float*>(gs),
        static_cast<bf16*>(d_base), static_cast<float*>(d_h),
        static_cast<float*>(scratch), m, n, r, split_n, st);
  const dim3 grid((r + tile::BN - 1) / tile::BN,
                  (m + tile::BM - 1) / tile::BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_DTYPE(dtype, T,
                 compose_mm_bwd_kernel<T><<<grid, tile::THREADS, 0, st>>>(
                     static_cast<const T*>(dy), static_cast<const T*>(B),
                     static_cast<const float*>(gm1),
                     static_cast<const float*>(gs), static_cast<T*>(d_base),
                     static_cast<float*>(d_h), m, n, r));
  return static_cast<int>(cudaGetLastError());
}
