// K8: the paged K/V gather of the block-paged decode cache.
//
// Replaces the TPU kernel repro/kernels/paged_gather.py:90 paged_gather
// (the scalar-prefetch pallas_call of _make_gather, :55):
//
//   out[e] = pool[pages[e]]   if 0 <= pages[e] < n_blocks
//          = 0                otherwise (-1 = unallocated)
//
// for a pool [n_blocks, block_bytes] of raw bytes and a flattened int32
// block table pages [n_entries] (B rows x max_blocks slots), giving
// out [n_entries, block_bytes], the logical [B, max_blocks * bs, Hkv, hd]
// view. A pure copy: bitwise the plain PyTorch version whatever the dtype.
//
// Bound on the H100: memory. Every output byte is written once and every
// allocated block read once, no arithmetic. At the qwen2-7b decode shape
// (8 slots x 128 blocks of 16 x 512 bf16, 16 KB each) that is 16.8 MB
// written and at most 16.8 MB read: about 0.01 ms at 3.35 TB/s.
// Design: one thread block per table entry reads its id once, then moves
// the block with 16-byte vector loads and stores (a block of 16 KB is four
// 16-byte moves per thread of 256); an id outside [0, n_blocks) writes
// zeros and reads nothing of the pool. Offsets are 64-bit. When the block
// size or a base pointer is not a multiple of 16 bytes, the same loop runs
// over single bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void paged_gather_kernel(const V* __restrict__ pool,
                                    const int* __restrict__ pages,
                                    V* __restrict__ out, long long n_blocks,
                                    long long vecs_per_block) {
  const long long e = blockIdx.x;
  const long long id = pages[e];
  V* dst = out + e * vecs_per_block;
  if (id < 0 || id >= n_blocks) {
    const V zero{};
    for (long long i = threadIdx.x; i < vecs_per_block; i += kThreads)
      dst[i] = zero;
    return;
  }
  const V* src = pool + id * vecs_per_block;
  for (long long i = threadIdx.x; i < vecs_per_block; i += kThreads)
    dst[i] = src[i];
}

}  // namespace

extern "C" int paged_gather(const void* pool, const void* pages, void* out,
                            long long n_blocks, long long n_entries,
                            long long block_bytes, void* stream) {
  if (n_entries <= 0 || block_bytes <= 0) return 0;
  if (n_entries > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = block_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int* table = static_cast<const int*>(pages);
  if (vec) {
    paged_gather_kernel<uint4><<<static_cast<unsigned>(n_entries), kThreads,
                                 0, s>>>(
        static_cast<const uint4*>(pool), table, static_cast<uint4*>(out),
        n_blocks, block_bytes / 16);
  } else {
    paged_gather_kernel<unsigned char>
        <<<static_cast<unsigned>(n_entries), kThreads, 0, s>>>(
            static_cast<const unsigned char*>(pool), table,
            static_cast<unsigned char*>(out), n_blocks, block_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
