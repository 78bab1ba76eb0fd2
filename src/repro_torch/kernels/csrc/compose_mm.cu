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
// operations), so it is bound by memory once the product runs on the
// tensor cores.
//
// Design, bf16 (every main path): a persistent grid, one block per SM
// (the wrapper's kernels/dora_compose.py compose_mm_fwd_blocks), walks
// output tiles of [128 rows x 192 columns] in row-major order, tile
// t = blockIdx.x + i·gridDim.x, so each tile is written by exactly one
// block and no sum crosses blocks: deterministic, no atomics. Its warps
// take three roles, each a sequential loop over the block's tiles:
// - a load warp (one thread) issues TMA copies: the tile's base
//   [128 x 192] as three 128-byte-swizzled boxes of 64 columns into one of
//   two 48 KB buffers, a tile ahead of its epilogue, then per 64-deep
//   k-tile the h [128 x 64] and B [192 x 64] boxes into a 3-stage ring
//   (40 KB a stage), running ahead across tile boundaries, so the next
//   tile's operands arrive during this tile's epilogue;
// - two consumer warpgroups run the product as warpgroup MMAs (wgmma
//   m64n192k16, K-major bf16 operands from shared memory, fp32
//   accumulators: a bf16 product is exact in fp32, so lora differs from
//   the reference's fp32 dot only in the order of its sums), each
//   holding its [64 x 192] piece of lora in registers; the epilogue reads
//   base from the swizzled buffer (the accumulator layout's column pairs
//   fall in 8 different 16-byte chunks of 8 rows: no bank conflict),
//   applies compose_elem's pinned, FMA-free order and writes delta in
//   place;
// - a store warp (one thread) sends the delta buffer back with TMA stores
//   (whole 128-byte rows, not 4-byte column pairs), waits until they have
//   read it, and frees the buffer for the base of the tile after next.
// r = 384 is 6 k-tiles a tile, so a block's fixed cost (pipeline fill,
// epilogue) is paid once per block, not once per tile. Ragged edges need
// no code: TMA loads zeros past the edge of M, N and r (r, N multiples of
// 8, so rows are 16-byte aligned), and stores nothing there. h (3 MB) and
// B (14.5 MB) stay in the 50 MB L2 (their copies ask L2 to keep them,
// base's and delta's to drop them first); only base and delta stream from
// HBM.
//
// What still holds it back: each tile reads 240 KB of h and B tiles from
// L2 for its 96 KB of HBM traffic (about 760 MB from L2 per call at
// w_gate), so the product is fed by L2 rather than bound by the tensor
// cores. The next step is less operand traffic a tile: h kept resident
// across a block's column tiles, or B multicast to a 2-block cluster.
//
// fp32 and fp16 operands, and bf16 operands the tensor-core route does
// not take (unaligned, N or r not a multiple of 8), keep the first
// version's code: each block owns a 64 x 64 tile and walks r in 16-deep
// chunks with fp32 FMAs on CUDA cores (no TF32: the card's fp32 checks
// run K6 in fp32), with the same epilogue.
#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (wgmma), fed and drained by TMA.
// ---------------------------------------------------------------------------
namespace k6 {
constexpr int BM = 128;        // rows of a tile: 64 per consumer warpgroup
constexpr int BN = 192;        // columns of a tile (one wgmma's N)
constexpr int BK = 64;         // depth of one staged k-tile: 128-byte rows
constexpr int STAGES = 3;      // the h/B ring
constexpr int CONSUMERS = 256;  // two warpgroups
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int LOAD_WARP = CONSUMER_WARPS, STORE_WARP = CONSUMER_WARPS + 1;
constexpr int THREADS = CONSUMERS + 64;
constexpr int TILE_H = BM * BK * 2;   // 16 KB
constexpr int TILE_B = BN * BK * 2;   // 24 KB
constexpr int STAGE = TILE_H + TILE_B;
constexpr int BOX = BM * 64 * 2;      // one 64-column box of base / delta
constexpr int TILE_O = (BN / 64) * BOX;  // 48 KB
constexpr int OFF_O = STAGES * STAGE;    // two base / delta buffers
constexpr int OFF_BAR = OFF_O + 2 * TILE_O;
constexpr int BARS = 2 * STAGES + 3 * 2;
// The ring, the two buffers, the barriers and 1 KB to align atoms:
// 222,304 bytes.
constexpr size_t SMEM = OFF_BAR + BARS * 8 + 1024;
}  // namespace k6

using bf16 = __nv_bfloat16;
using namespace tc;

__global__ void __launch_bounds__(k6::THREADS, 1)
    compose_mm_fwd_mma_kernel(const __grid_constant__ CUtensorMap map_h,
                              const __grid_constant__ CUtensorMap map_b,
                              const __grid_constant__ CUtensorMap map_base,
                              const __grid_constant__ CUtensorMap map_out,
                              const float* __restrict__ gm1, int m, int n,
                              int r, float s) {
  using namespace k6;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  unsigned char* smem = smem_raw + pad;
  const uint32_t sbase = smem_addr(smem);
  // full/empty: the h/B ring; base_full: a base tile landed; out_ready:
  // its delta is written; base_free: the TMA store has read it.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* base_full = empty + STAGES;
  uint64_t* out_ready = base_full + 2;
  uint64_t* base_free = out_ready + 2;
  const int n_ct = (n + BN - 1) / BN;
  const int tiles = ((m + BM - 1) / BM) * n_ct;
  const int nk = (r + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(base_full + i, 1);
      mbar_init(out_ready + i, CONSUMERS);
      mbar_init(base_free + i, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // Tile i of this block is t = blockIdx.x + i·gridDim.x; its base and
  // delta use buffer i % 2, whose barriers complete once per two tiles.
  if (warp == LOAD_WARP) {
    if (lane != 0) return;
    int it = 0;  // k-tiles issued so far, across tiles
    for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
      const int m0 = (t / n_ct) * BM, n0 = (t % n_ct) * BN, buf = i & 1;
      unsigned char* ob = smem + OFF_O + buf * TILE_O;
      mbar_wait(base_free + buf, ((i >> 1) & 1) ^ 1);
      mbar_expect_tx(base_full + buf, TILE_O);
      for (int c = 0; c < BN / 64; ++c)
        tma_load_2d(ob + c * BOX, &map_base, base_full + buf, n0 + 64 * c,
                    m0, L2_EVICT_FIRST);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % STAGES;
        mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + st, STAGE);
        tma_load_2d(smem + st * STAGE, &map_h, full + st, kt * BK, m0,
                    L2_EVICT_LAST);
        tma_load_2d(smem + st * STAGE + TILE_H, &map_b, full + st, kt * BK,
                    n0, L2_EVICT_LAST);
      }
    }
    return;
  }
  if (warp == STORE_WARP) {
    if (lane != 0) return;
    for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
      const int m0 = (t / n_ct) * BM, n0 = (t % n_ct) * BN, buf = i & 1;
      const unsigned char* ob = smem + OFF_O + buf * TILE_O;
      mbar_wait(out_ready + buf, (i >> 1) & 1);
      for (int c = 0; c < BN / 64; ++c)
        if (n0 + 64 * c < n)
          tma_store_2d(&map_out, ob + c * BOX, n0 + 64 * c, m0,
                       L2_EVICT_FIRST);
      bulk_commit();
      bulk_wait<0, true>();
      mbar_arrive(base_free + buf);
    }
    bulk_wait<0, false>();
    return;
  }

  // Consumers: warpgroup wg owns rows 64·wg.. of each tile.
  const int wg = warp >> 2;
  const int g = lane >> 2, q = lane & 3;
  const int row_w = wg * 64 + (warp & 3) * 16 + g;  // and row_w + 8
  int it = 0;
  for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
    const int n0 = (t % n_ct) * BN, buf = i & 1;
    float d[96];
#pragma unroll
    for (int x = 0; x < 96; ++x) d[x] = 0.0f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % STAGES;
      mbar_wait(full + st, (it / STAGES) & 1);
      const uint32_t aH = sbase + st * STAGE + wg * 64 * 128;
      const uint32_t aB = sbase + st * STAGE + TILE_H;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n192k16<0>(d, desc128(aH + kk * 32, 16, 1024),
                            desc128(aB + kk * 32, 16, 1024));
      wgmma_commit();
      // The wgmma of the previous k-tile is done: free its stage.
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % STAGES);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + (it - 1) % STAGES);

    // delta = compose(gm1, base, lora) in place of base. Row row_w + 8h
    // has swizzle phase g, so column pair 8j + 2q sits in chunk
    // (j % 8) ^ g of box j / 8.
    mbar_wait(base_full + buf, (i >> 1) & 1);
    unsigned char* ob = smem + OFF_O + buf * TILE_O;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      const float2 gv = col < n ? __ldg(reinterpret_cast<const float2*>(
                                      gm1 + col))
                                : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            ob + (j / 8) * BOX + (row_w + 8 * h) * 128 +
            (((j % 8) ^ g) << 4) + 4 * q);
        const float2 b = __bfloat1622float2(*p);
        *p = __floats2bfloat162_rn(
            compose_elem(gv.x, b.x, d[4 * j + 2 * h], s),
            compose_elem(gv.y, b.y, d[4 * j + 2 * h + 1], s));
      }
    }
    // Every consumer's writes, made visible to the TMA store.
    fence_async_smem();
    mbar_arrive(out_ready + buf);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library links nothing beyond the runtime.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major bf16 [rows, cols] tensor read and written in boxes of
// [box_rows, 64] with the 128-byte swizzle; zeros past its edges.
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int compose_mm_fwd_bf16(const bf16* base, const bf16* h, const bf16* B,
                        const float* gm1, bf16* out, int m, int n, int r,
                        float s, int blocks, cudaStream_t st) {
  using namespace k6;
  CUtensorMap mh, mb, mbase, mout;
  if (n % 8 != 0 || r % 8 != 0 ||
      !tensor_map(&mh, h, m, r, BM) || !tensor_map(&mb, B, n, r, BN) ||
      !tensor_map(&mbase, base, m, n, BM) || !tensor_map(&mout, out, m, n,
                                                         BM))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      compose_mm_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  compose_mm_fwd_mma_kernel<<<blocks, THREADS, SMEM, st>>>(
      mh, mb, mbase, mout, gm1, m, n, r, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks > 0 with bf16 operands takes the persistent tensor-core kernel on
// a grid of that many blocks; anything else runs the FMA kernel.
extern "C" int compose_mm_fwd(const void* base, const void* h, const void* B,
                              const void* gm1, void* out, int m, int n, int r,
                              float s, int blocks, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16 && blocks > 0)
    return compose_mm_fwd_bf16(
        static_cast<const bf16*>(base), static_cast<const bf16*>(h),
        static_cast<const bf16*>(B), static_cast<const float*>(gm1),
        static_cast<bf16*>(out), m, n, r, s, blocks, st);
  const dim3 grid((n + tile::BN - 1) / tile::BN,
                  (m + tile::BM - 1) / tile::BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_DTYPE(dtype, T,
                 compose_mm_fwd_kernel<T><<<grid, tile::THREADS, 0, st>>>(
                     static_cast<const T*>(base), static_cast<const T*>(h),
                     static_cast<const T*>(B), static_cast<const float*>(gm1),
                     static_cast<T*>(out), m, n, r, s));
  return static_cast<int>(cudaGetLastError());
}
