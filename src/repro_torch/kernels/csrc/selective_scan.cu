// K9: the Mamba-1 selective scan.
//
// Replaces the TPU kernel repro/kernels/selective_scan.py:60
// selective_scan_pallas (_scan_kernel :37, pallas_call :71):
//
//   h_t[i, d] = exp(dt_t[d] * A_t[i, d]) * h_{t-1}[i, d] + dtx_t[d] * B_t[i]
//   y_t[d]    = sum_i h_t[i, d] * C_t[i]
//
// in the Pallas function's layout, all fp32: dt, dtx [B, S, di];
// Bm, Cm [B, S, n]; A_t [n, di]; h0_t [B, n, di] -> y [B, S, di] and the
// final state h_f [B, n, di]. The discretized terms exp(dt * A) and
// dtx * B are formed in registers and never written to memory.
//
// Bound on the H100: both memory and the special-function units, about
// equally. At the falcon-mamba-7b prefill shape [4, 960, 8192], n = 16,
// the kernel must read dt and dtx and write y (377 MB) plus B, C, A, h0 and
// h_f (6 MB): 0.114 ms at 3.35 TB/s; and it takes B*S*di*n = 503 M
// exponentials on the SFUs (16 per clock per SM, 132 SMs, 1.98 GHz):
// 0.120 ms. The recurrence is sequential in S, so only B*di = 32,768
// independent chains exist; one thread per chain leaves 8 warps an SM,
// too few to keep both the SFUs and the memory busy.
//
// Design: the TPU grid's sequential chunk axis and the VMEM scratch that
// carries h become one loop over S inside the block.
//  - L lanes (L = 1, 2 or 4, adjacent in a warp) share one (batch row,
//    channel) pair; lane g holds states g*kS .. g*kS + kS - 1 (kS = 16 / L)
//    and their entries of A in registers: 8 * L warps an SM at the prefill
//    shape (L = 4 fits 6 blocks, 24 warps, an SM without spilling, so it
//    takes a second wave). A block of 128 threads holds 128 / L
//    consecutive channels of one batch row. The wrapper picks L
//    (selective_scan.py: LANES, the fastest of chip_smoke.py's sweep);
//    more lanes mean more warps but more loads of B and C and more
//    shuffles for each exp.
//  - Each exp is one SFU op: A is scaled by log2(e) once, and
//    exp(dt * A) = ex2.approx.ftz(dt * A'), so the FMA pipes carry only
//    the recurrence. A token's exps do not depend on h, so they issue
//    ahead of the FMA chain.
//  - Loads run a chunk ahead: chunks of kChunk tokens of dt, dtx (a
//    [kChunk x 128 / L] tile, 16-byte copies coalesced along di) and of
//    B, C (rows of n) are staged in shared memory by cp.async in a ring of
//    kStages, so two chunks are in flight while one is scanned. The L
//    lanes of a channel read the same dt word: a broadcast.
//  - y: each lane sums its own states (in state order), then the L lanes'
//    partial sums of L consecutive tokens are reduced with
//    __shfl_xor_sync in a fixed tree, ((p0 + p1) + (p2 + p3)) for L = 4,
//    scattered so that lane g ends with token g's sum (L - 1 shuffles for
//    L tokens). No atomics: deterministic. The sums land in a y tile in
//    shared memory (double-buffered), and leave as whole coalesced rows
//    of 16-byte stores after the chunk.
// The kernel holds kMaxState = 16 states (the full-width configs' n); an
// n < 16 runs with the states at i >= n held at zero (A = 0, B = C = 0).
// The edge of di is masked, and copies past it or past S load zeros; S
// needs no multiple (the last chunk keeps h for its missing tokens). When
// di is not a multiple of 4 (or n, for B and C) or a pointer is not
// 16-byte aligned, the same pipeline copies 4 bytes at a time. nvcc
// contracts a*h + b into one FMA, so results differ from the plain
// version by rounding, not bitwise.
//
// Training forward: given hc, the kernel also writes the state at every
// boundary of tc steps (tc a multiple of kChunk), hc [B, ceil(S / tc), n,
// di] with hc[:, k] = h before step k * tc (hc[:, 0] = h0): where the
// backward (selective_scan_bwd.cu) restarts its recompute. That is a
// separate instantiation (kStates), so the serving kernel, without hc, is
// compiled and computes exactly as before.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 128;
constexpr int kChunk = 16;      // tokens a ring stage holds
constexpr int kStages = 3;      // the chunk being scanned and two ahead
constexpr int kMaxState = 16;
constexpr float kLog2e = 1.4426950408889634f;

// L adjacent lanes hold one channel: lane g holds its states
// g*kS .. g*kS + kS - 1.
template <int L>
struct Plan {
  static constexpr int kL = L;
  static constexpr int kS = kMaxState / L;   // states a lane holds
  static constexpr int kC = kThreads / L;    // channels a block holds
  // A y-tile row, padded so the L rows one warp writes fall in different
  // banks.
  static constexpr int kYRow = kC + 32 / L;
  // Floats of one ring stage: dt and dtx tiles [kChunk][kC], then the B
  // and C rows [kChunk][kMaxState].
  static constexpr int kStage = 2 * kChunk * kC + 2 * kChunk * kMaxState;
  static constexpr int kSmemBytes =
      4 * (kStages * kStage + 2 * kChunk * kYRow);
  // Blocks an SM holds: one wave at the prefill shape for L <= 2. At L = 4
  // a wave needs 8, but 8 or 7 cap a thread at 64 or 72 registers, and
  // the kernel spills at both; 6 leave it 85. The training forward's
  // chunk-state stores spill at 85 (measured on the H100): 5, 102.
  static constexpr int kMinBlocks = L == 4 ? 6 : 2 * L;
  static constexpr int kMinBlocksStates = L == 4 ? 5 : kMinBlocks;
};

// Copy 4 bytes from global to shared memory asynchronously; with `valid`
// false the source is not read and the 4 bytes are zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 2^x in one SFU op (inputs below 2^-126 and results below it flush to 0).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage chunk [t0, t0 + kChunk) of this block's channels into ring stage
// `st`; tokens past S and channels past di load zeros.
template <typename P>
__device__ __forceinline__ void load_chunk(
    float* st, const float* __restrict__ dt, const float* __restrict__ dtx,
    const float* __restrict__ bm, const float* __restrict__ cm,
    long long b, int t0, int seq, int di, int d0, int n, bool vec_dt,
    bool vec_bc) {
  float* s_dt = st;
  float* s_dx = st + kChunk * P::kC;
  float* s_b = st + 2 * kChunk * P::kC;
  float* s_c = s_b + kChunk * kMaxState;
  const int len = min(kChunk, seq - t0);
  const long long tok = b * seq + t0;
  if (vec_dt) {                    // di % 4 == 0: a vector is all in or out
    constexpr int kRow = P::kC / 4;
    for (int e = threadIdx.x; e < kChunk * kRow; e += kThreads) {
      const int tt = e / kRow, d = d0 + 4 * (e % kRow);
      const bool ok = tt < len && d < di;
      const long long at = ok ? (tok + tt) * di + d : 0;
      cp_async16(s_dt + 4 * e, dt + at, ok);
      cp_async16(s_dx + 4 * e, dtx + at, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kChunk * P::kC; e += kThreads) {
      const int tt = e / P::kC, d = d0 + e % P::kC;
      const bool ok = tt < len && d < di;
      const long long at = ok ? (tok + tt) * di + d : 0;
      cp_async4(s_dt + e, dt + at, ok);
      cp_async4(s_dx + e, dtx + at, ok);
    }
  }
  // States i >= n are never written here: they stay the zeros the kernel
  // put there first.
  if (vec_bc) {                    // n % 4 == 0
    const int row = n / 4;
    for (int e = threadIdx.x; e < kChunk * row; e += kThreads) {
      const int tt = e / row, i = 4 * (e % row);
      const bool ok = tt < len;
      const long long at = ok ? (tok + tt) * n + i : 0;
      cp_async16(s_b + tt * kMaxState + i, bm + at, ok);
      cp_async16(s_c + tt * kMaxState + i, cm + at, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kChunk * n; e += kThreads) {
      const int tt = e / n, i = e % n;
      const bool ok = tt < len;
      const long long at = ok ? (tok + tt) * n + i : 0;
      cp_async4(s_b + tt * kMaxState + i, bm + at, ok);
      cp_async4(s_c + tt * kMaxState + i, cm + at, ok);
    }
  }
}

// Sum v[u] (this lane's partial sum for token u of L) over the L lanes of
// a channel, in the tree ((p0 + p1) + (p2 + p3)): at the step of mask m a
// lane keeps the tokens whose bit m equals its own and sends the others
// to lane ^ m. Lane g ends with token g's sum in v[0].
template <int L>
__device__ __forceinline__ void reduce_scatter(float (&v)[L], int g) {
#pragma unroll
  for (int m = 1, k = L; m < L; m <<= 1, k >>= 1) {
    const bool up = g & m;
#pragma unroll
    for (int j = 0; j < k / 2; ++j) {
      const float lo = v[2 * j], hi = v[2 * j + 1];
      const float theirs = __shfl_xor_sync(0xffffffffu, up ? lo : hi, m);
      v[j] = (up ? hi : lo) + theirs;
    }
  }
}

// Scan one staged chunk: update h over its tokens (only the first `len`
// when kTail) and write each token's y into the y tile. The partial sums
// of L tokens are reduced together, so lane g writes token g's.
template <typename P, bool kTail>
__device__ __forceinline__ void scan_chunk(const float* st, float* s_y,
                                           const float (&a)[P::kS],
                                           float (&h)[P::kS], int c, int g,
                                           int len) {
  constexpr int kS = P::kS;
  const float* s_dt = st;
  const float* s_dx = st + kChunk * P::kC;
  const float* s_b = st + 2 * kChunk * P::kC + g * kS;
  const float* s_c = s_b + kChunk * kMaxState;
#pragma unroll
  for (int t0 = 0; t0 < kChunk; t0 += P::kL) {
    float v[P::kL];
#pragma unroll
    for (int u = 0; u < P::kL; ++u) {
      const int tt = t0 + u;
      const float dt = s_dt[tt * P::kC + c];
      const float dx = s_dx[tt * P::kC + c];
      float bb[kS], cc[kS];
#pragma unroll
      for (int j = 0; j < kS; j += 4) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(s_b + tt * kMaxState + j);
        const float4 c4 =
            *reinterpret_cast<const float4*>(s_c + tt * kMaxState + j);
        bb[j] = b4.x, bb[j + 1] = b4.y, bb[j + 2] = b4.z, bb[j + 3] = b4.w;
        cc[j] = c4.x, cc[j + 1] = c4.y, cc[j + 2] = c4.z, cc[j + 3] = c4.w;
      }
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const float hn = fmaf(exp2_sfu(dt * a[j]), h[j], dx * bb[j]);
        if (!kTail || tt < len) h[j] = hn;
        acc = fmaf(h[j], cc[j], acc);
      }
      v[u] = acc;
    }
    reduce_scatter<P::kL>(v, g);
    s_y[(t0 + g) * P::kYRow + c] = v[0];
  }
}

// Write the y tile of chunk [t0, t0 + kChunk) as whole rows; rows past S
// and channels past di are dropped.
template <typename P>
__device__ __forceinline__ void store_y(const float* s_y,
                                        float* __restrict__ y, long long b,
                                        int t0, int seq, int di, int d0,
                                        bool vec) {
  const int len = min(kChunk, seq - t0);
  const long long tok = b * seq + t0;
  if (vec) {
    constexpr int kRow = P::kC / 4;
    for (int e = threadIdx.x; e < kChunk * kRow; e += kThreads) {
      const int tt = e / kRow, cc = 4 * (e % kRow);
      if (tt < len && d0 + cc < di)
        *reinterpret_cast<float4*>(y + (tok + tt) * di + d0 + cc) =
            *reinterpret_cast<const float4*>(s_y + tt * P::kYRow + cc);
    }
  } else {
    for (int e = threadIdx.x; e < kChunk * P::kC; e += kThreads) {
      const int tt = e / P::kC, cc = e % P::kC;
      if (tt < len && d0 + cc < di)
        y[(tok + tt) * di + d0 + cc] = s_y[tt * P::kYRow + cc];
    }
  }
}

template <int L, bool kStates>
__global__ void __launch_bounds__(kThreads, kStates
                                                ? Plan<L>::kMinBlocksStates
                                                : Plan<L>::kMinBlocks)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ dtx,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_t,
                      const float* __restrict__ h0_t,
                      float* __restrict__ y, float* __restrict__ h_f,
                      float* __restrict__ hc, int per_state,
                      int seq, int di, int n, bool vec_dt, bool vec_bc) {
  using P = Plan<L>;
  constexpr int kS = P::kS;
  extern __shared__ __align__(16) float smem[];
  float* s_y0 = smem + kStages * P::kStage;
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * P::kC;
  const int c = threadIdx.x / L, g = threadIdx.x % L;
  const int d = d0 + c;
  const bool live = d < di;

  // States i >= n of every stage's B and C rows: zero, once.
  for (int e = threadIdx.x; e < kStages * 2 * kChunk * kMaxState;
       e += kThreads) {
    if (e % kMaxState >= n) {
      const int stage = e / (2 * kChunk * kMaxState);
      smem[stage * P::kStage + 2 * kChunk * P::kC +
           e % (2 * kChunk * kMaxState)] = 0.0f;
    }
  }

  float a[kS], h[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int i = g * kS + j;
    const bool ok = live && i < n;
    a[j] = ok ? a_t[static_cast<long long>(i) * di + d] * kLog2e : 0.0f;
    h[j] = ok ? h0_t[(b * n + i) * di + d] : 0.0f;
  }

  const int chunks = (seq + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks)
      load_chunk<P>(smem + s * P::kStage, dt, dtx, bm, cm, b, s * kChunk,
                    seq, di, d0, n, vec_dt, vec_bc);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<kStages - 2>();     // this thread's copies of chunk k
    // Every thread's copies of chunk k have landed, and every thread is
    // done with chunk k - 1: its ring stage and its y tile are free.
    __syncthreads();
    if (k > 0)
      store_y<P>(s_y0 + ((k - 1) & 1) * kChunk * P::kYRow, y, b,
                 (k - 1) * kChunk, seq, di, d0, vec_dt);
    const int next = k + kStages - 1;
    if (next < chunks)
      load_chunk<P>(smem + (next % kStages) * P::kStage, dt, dtx, bm, cm, b,
                    next * kChunk, seq, di, d0, n, vec_dt, vec_bc);
    cp_async_commit();
    if (kStates && k % per_state == 0) {
      // h before chunk k, which starts a stretch of per_state chunks: one
      // of hc's boundaries.
      const long long slot =
          b * ((chunks + per_state - 1) / per_state) + k / per_state;
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const int i = g * kS + j;
        if (live && i < n) hc[(slot * n + i) * di + d] = h[j];
      }
    }
    const float* st = smem + (k % kStages) * P::kStage;
    float* s_y = s_y0 + (k & 1) * kChunk * P::kYRow;
    const int len = min(kChunk, seq - k * kChunk);
    if (len == kChunk)
      scan_chunk<P, false>(st, s_y, a, h, c, g, len);
    else
      scan_chunk<P, true>(st, s_y, a, h, c, g, len);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (chunks > 0)
    store_y<P>(s_y0 + ((chunks - 1) & 1) * kChunk * P::kYRow, y, b,
               (chunks - 1) * kChunk, seq, di, d0, vec_dt);

#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int i = g * kS + j;
    if (live && i < n) h_f[(b * n + i) * di + d] = h[j];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int L, bool kStates>
int launch_as(const float* dt, const float* dtx, const float* bm,
              const float* cm, const float* a_t, const float* h0_t, float* y,
              float* h_f, float* hc, int per_state, int batch, int seq,
              int di, int n, cudaStream_t stream) {
  using P = Plan<L>;
  const cudaError_t attr = cudaFuncSetAttribute(
      selective_scan_kernel<L, kStates>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec_dt = di % 4 == 0 && aligned16(dt) && aligned16(dtx) &&
                      aligned16(y);
  const bool vec_bc = n % 4 == 0 && aligned16(bm) && aligned16(cm);
  const dim3 grid((di + P::kC - 1) / P::kC, batch);
  selective_scan_kernel<L, kStates>
      <<<grid, kThreads, P::kSmemBytes, stream>>>(
          dt, dtx, bm, cm, a_t, h0_t, y, h_f, hc, per_state, seq, di, n,
          vec_dt, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch(const float* dt, const float* dtx, const float* bm,
           const float* cm, const float* a_t, const float* h0_t, float* y,
           float* h_f, float* hc, int per_state, int batch, int seq, int di,
           int n, cudaStream_t stream) {
  return hc == nullptr
             ? launch_as<L, false>(dt, dtx, bm, cm, a_t, h0_t, y, h_f, hc,
                                   per_state, batch, seq, di, n, stream)
             : launch_as<L, true>(dt, dtx, bm, cm, a_t, h0_t, y, h_f, hc,
                                  per_state, batch, seq, di, n, stream);
}

}  // namespace

extern "C" int selective_scan(const void* dt, const void* dtx, const void* bm,
                              const void* cm, const void* a_t,
                              const void* h0_t, void* y, void* h_f, void* hc,
                              int tc, int batch, int seq, int di, int n,
                              int lanes, void* stream) {
  if (batch <= 0 || di <= 0) return 0;
  if (n < 1 || n > kMaxState || batch > 65535 || seq < 0 ||
      (hc != nullptr && (tc < kChunk || tc % kChunk != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f_dt = static_cast<const float*>(dt);
  const auto* f_dtx = static_cast<const float*>(dtx);
  const auto* f_bm = static_cast<const float*>(bm);
  const auto* f_cm = static_cast<const float*>(cm);
  const auto* f_a = static_cast<const float*>(a_t);
  const auto* f_h0 = static_cast<const float*>(h0_t);
  auto* f_y = static_cast<float*>(y);
  auto* f_hf = static_cast<float*>(h_f);
  auto* f_hc = static_cast<float*>(hc);
  const int per = hc != nullptr ? tc / kChunk : 1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1:
      return launch<1>(f_dt, f_dtx, f_bm, f_cm, f_a, f_h0, f_y, f_hf, f_hc,
                       per, batch, seq, di, n, s);
    case 2:
      return launch<2>(f_dt, f_dtx, f_bm, f_cm, f_a, f_h0, f_y, f_hf, f_hc,
                       per, batch, seq, di, n, s);
    case 4:
      return launch<4>(f_dt, f_dtx, f_bm, f_cm, f_a, f_h0, f_y, f_hf, f_hc,
                       per, batch, seq, di, n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
