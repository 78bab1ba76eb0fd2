// The backward of the Mamba-1 selective scan (K9, selective_scan.cu).
//
// Replaces no TPU kernel: the reference trains Mamba by jax.grad through
// its XLA scan (repro/models/mamba.py:50 _ssm_scan_fused) and has no
// backward pallas_call. It is added because the port's forward is a hand-
// written kernel that autograd cannot see through. With
//
//   a_t[i, d] = exp(dt_t[d] * A_t[i, d]),
//   h_t = a_t * h_{t-1} + dtx_t[d] * B_t[i],   y_t[d] = sum_i h_t[i, d] C_t[i]
//
// and dy = dL/dy, it runs the reverse recurrence of g_t = dL/dh_t,
//
//   g_t = a_{t+1} * g_{t+1} + dy_t[d] * C_t[i]
//
// and emits the gradients of the scan's differentiable inputs, all fp32:
//
//   d_dt_t[d]  = sum_i g_t * A * a_t * h_{t-1}      d_dtx_t[d] = sum_i g_t * B_t[i]
//   d_B_t[i]   = sum_d g_t * dtx_t[d]               d_C_t[i]   = sum_d h_t * dy_t[d]
//
// (the reference freezes A_log, and h0 is zeros in training: no d_A, no
// d_h0). Inputs in K9's layout: dt, dtx, dy [B, S, di]; Bm, Cm [B, S, n];
// A_t [n, di]; hc [B, ceil(S / kTc), n, di], the states K9's training
// forward kept at every kTc-step boundary (hc[:, k] = h before step
// k * kTc).
//
// Bound on the H100: memory. At the falcon-mamba-7b training shape
// [2, 2048, 8192], n = 16, it must read dt, dtx, dy (3 x 134 MB) and hc
// (67 MB) and write d_dt and d_dtx (2 x 134 MB): 0.74 GB, 0.22 ms at
// 3.35 TB/s; its B*S*di*n = 537 M exps take 0.128 ms on the SFUs.
//
// Design: K9's layout (selective_scan.cu) walked backwards.
//  - A block holds kC = 64 consecutive channels of one batch row, kL = 2
//    adjacent lanes a channel, lane g holding states g*8 .. g*8 + 7 and
//    their A in registers; exps are ex2.approx of dt * A*log2(e) (SFUs).
//  - The chunks of kTc = 32 steps are walked from last to first. For each
//    chunk the block stages its dt, dtx, dy tiles and B, C rows in shared
//    memory, recomputes h over the chunk from hc (K9's arithmetic) into
//    shared memory (kTc x 16 states x 64 channels, 128 KB), then walks the
//    chunk backwards carrying g and a_{t+1} in registers across chunks.
//  - Sums over a channel's states: the two lanes' partial sums added by
//    one xor shuffle (both lanes get the same bits). d_dt and d_dtx land
//    in shared tiles and leave as coalesced rows after the chunk.
//  - d_B and d_C sum over channels, so they cross blocks: within a warp a
//    fixed xor reduce-scatter over its 16 channels (masks 2, 4, 8, then
//    16), within the block the 4 warps' sums added in warp order, and the
//    block's partials written to [blocks along di, B, S, n]; a second
//    kernel adds the blocks in index order. No atomics anywhere: the same
//    inputs give the same bits (paper §3.2).
// One block of 192.5 KB of shared memory an SM, four warps: a simple
// kernel, latency-bound (its time is in PERF.md beside the bound).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxState = 16;
constexpr int kL = 2;                    // lanes a channel
constexpr int kS = kMaxState / kL;       // states a lane holds
constexpr int kC = kThreads / kL;        // channels a block holds
constexpr int kWarps = kThreads / 32;
constexpr int kTc = 32;                  // steps between hc's states
constexpr float kLog2e = 1.4426950408889634f;

// Floats of shared memory: h [kTc][kS][kThreads]; the dt, dtx, dy input
// tiles and the d_dt, d_dtx output tiles [kTc][kC]; B, C rows
// [kTc][kMaxState]; the warps' channel sums [kWarps][kTc][2][kMaxState].
constexpr int kH = kTc * kS * kThreads;
constexpr int kTile = kTc * kC;
constexpr int kRows = kTc * kMaxState;
constexpr int kPart = kWarps * kTc * 2 * kMaxState;
constexpr int kSmemBytes = 4 * (kH + 5 * kTile + 2 * kRows + kPart);

__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The sum of v over the 16 channels of a warp (lanes 2c + g, channel bits
// 1-4 of the lane), scattered: the step of mask m keeps the states whose
// bit matches the lane's own and sends the others to lane ^ m, halving v
// at masks 2, 4 and 8; mask 16 adds the last pair. Lane l ends with the
// sum of its lane-group's state (l >> 1) & 7, the same bits in l and l ^ 16.
__device__ __forceinline__ float channel_sum(float (&v)[kS], int lane) {
#pragma unroll
  for (int m = 2, k = kS; m <= 8; m <<= 1, k >>= 1) {
    const bool up = lane & m;
#pragma unroll
    for (int j = 0; j < k / 2; ++j) {
      const float lo = v[2 * j], hi = v[2 * j + 1];
      const float theirs = __shfl_xor_sync(0xffffffffu, up ? lo : hi, m);
      v[j] = (up ? hi : lo) + theirs;
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
}

__global__ void __launch_bounds__(kThreads, 1)
selective_scan_bwd_kernel(const float* __restrict__ dt,
                          const float* __restrict__ dtx,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ a_t,
                          const float* __restrict__ hc,
                          const float* __restrict__ dy,
                          float* __restrict__ d_dt,
                          float* __restrict__ d_dtx,
                          float* __restrict__ part_b,
                          float* __restrict__ part_c, int seq, int di,
                          int n, int n_states) {
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem;
  float* s_dt = s_h + kH;
  float* s_dx = s_dt + kTile;
  float* s_dy = s_dx + kTile;
  float* s_odt = s_dy + kTile;
  float* s_odx = s_odt + kTile;
  float* s_b = s_odx + kTile;
  float* s_c = s_b + kRows;
  float* s_part = s_c + kRows;

  const long long b = blockIdx.y;
  const long long batch = gridDim.y;
  const int d0 = blockIdx.x * kC;
  const int tid = threadIdx.x;
  const int c = tid / kL, g = tid % kL;
  const int d = d0 + c;
  const bool live = d < di;
  const int warp = tid / 32, lane = tid % 32;

  float A[kS], a2[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int i = g * kS + j;
    A[j] = live && i < n ? a_t[static_cast<long long>(i) * di + d] : 0.0f;
    a2[j] = A[j] * kLog2e;
  }
  // States i >= n of the B and C rows: zero, once (never loaded).
  for (int e = tid; e < 2 * kRows; e += kThreads)
    if (e % kMaxState >= n) s_b[e] = 0.0f;

  float gr[kS], a_next[kS];              // g_{t+1} and a_{t+1}
#pragma unroll
  for (int j = 0; j < kS; ++j) gr[j] = a_next[j] = 0.0f;

  for (int k = n_states - 1; k >= 0; --k) {
    const int t0 = k * kTc;
    const int len = min(kTc, seq - t0);
    const long long tok = b * seq + t0;
    // Every thread is done with the last chunk's tiles and stores.
    __syncthreads();
    for (int e = tid; e < kTile; e += kThreads) {
      const int tt = e / kC, dd = d0 + e % kC;
      const bool ok = tt < len && dd < di;
      const long long at = (tok + tt) * di + dd;
      s_dt[e] = ok ? dt[at] : 0.0f;
      s_dx[e] = ok ? dtx[at] : 0.0f;
      s_dy[e] = ok ? dy[at] : 0.0f;
    }
    for (int e = tid; e < kTc * n; e += kThreads) {
      const int tt = e / n, i = e % n;
      const bool ok = tt < len;
      const long long at = (tok + tt) * n + i;
      s_b[tt * kMaxState + i] = ok ? bm[at] : 0.0f;
      s_c[tt * kMaxState + i] = ok ? cm[at] : 0.0f;
    }
    __syncthreads();

    // h over the chunk from its start state, as K9 computes it.
    float h0[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int i = g * kS + j;
      h0[j] = live && i < n
                  ? hc[((b * n_states + k) * n + i) * static_cast<long long>(di) + d]
                  : 0.0f;
    }
    {
      float h[kS];
#pragma unroll
      for (int j = 0; j < kS; ++j) h[j] = h0[j];
#pragma unroll 1
      for (int tt = 0; tt < len; ++tt) {
        const float dtv = s_dt[tt * kC + c], dxv = s_dx[tt * kC + c];
        const float* brow = s_b + tt * kMaxState + g * kS;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          h[j] = fmaf(exp2_sfu(dtv * a2[j]), h[j], dxv * brow[j]);
          s_h[(tt * kS + j) * kThreads + tid] = h[j];
        }
      }
    }

    // The chunk backwards.
#pragma unroll 1
    for (int tt = len - 1; tt >= 0; --tt) {
      const float dtv = s_dt[tt * kC + c], dxv = s_dx[tt * kC + c];
      const float dyv = s_dy[tt * kC + c];
      const float* brow = s_b + tt * kMaxState + g * kS;
      const float* crow = s_c + tt * kMaxState + g * kS;
      float pdt = 0.0f, pdx = 0.0f, pb[kS], pc[kS];
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const float ht = s_h[(tt * kS + j) * kThreads + tid];
        const float hp =
            tt > 0 ? s_h[((tt - 1) * kS + j) * kThreads + tid] : h0[j];
        gr[j] = fmaf(a_next[j], gr[j], dyv * crow[j]);
        const float a = exp2_sfu(dtv * a2[j]);
        a_next[j] = a;
        pdt = fmaf(gr[j] * A[j], a * hp, pdt);
        pdx = fmaf(gr[j], brow[j], pdx);
        pb[j] = gr[j] * dxv;
        pc[j] = ht * dyv;
      }
      pdt += __shfl_xor_sync(0xffffffffu, pdt, 1);
      pdx += __shfl_xor_sync(0xffffffffu, pdx, 1);
      if (g == 0) {
        s_odt[tt * kC + c] = pdt;
        s_odx[tt * kC + c] = pdx;
      }
      const float sb = channel_sum(pb, lane);
      const float sc = channel_sum(pc, lane);
      if (lane < 16) {
        const int st = (lane & 1) * kS + ((lane >> 1) & 7);
        float* row = s_part + ((warp * kTc + tt) * 2) * kMaxState;
        row[st] = sb;
        row[kMaxState + st] = sc;
      }
    }
    __syncthreads();

    for (int e = tid; e < kTile; e += kThreads) {
      const int tt = e / kC, dd = d0 + e % kC;
      if (tt < len && dd < di) {
        const long long at = (tok + tt) * di + dd;
        d_dt[at] = s_odt[e];
        d_dtx[at] = s_odx[e];
      }
    }
    // The block's partial d_B and d_C: the warps' sums in warp order.
    for (int e = tid; e < len * 2 * n; e += kThreads) {
      const int tt = e / (2 * n), q = (e / n) % 2, i = e % n;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += s_part[((w * kTc + tt) * 2 + q) * kMaxState + i];
      float* out = q == 0 ? part_b : part_c;
      out[((blockIdx.x * batch + b) * seq + t0 + tt) * n + i] = sum;
    }
  }
}

// d_B and d_C: the blocks' partials [blocks, B*S*n] added in index order.
__global__ void selective_scan_bwd_sum_kernel(const float* __restrict__ part_b,
                                              const float* __restrict__ part_c,
                                              float* __restrict__ d_b,
                                              float* __restrict__ d_c,
                                              long long elems, int blocks) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < elems; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sb = 0.0f, sc = 0.0f;
    for (int x = 0; x < blocks; ++x) {
      sb += part_b[x * elems + e];
      sc += part_c[x * elems + e];
    }
    d_b[e] = sb;
    d_c[e] = sc;
  }
}

}  // namespace

// part_b and part_c: scratch of [ceil(di / 64), batch, seq, n] floats each.
extern "C" int selective_scan_bwd(const void* dt, const void* dtx,
                                  const void* bm, const void* cm,
                                  const void* a_t, const void* hc,
                                  const void* dy, void* d_dt, void* d_dtx,
                                  void* d_b, void* d_c, void* part_b,
                                  void* part_c, int tc, int batch, int seq,
                                  int di, int n, void* stream) {
  if (batch <= 0 || di <= 0 || seq <= 0) return 0;
  if (n < 1 || n > kMaxState || batch > 65535 || tc != kTc)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      selective_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (di + kC - 1) / kC;
  const int n_states = (seq + kTc - 1) / kTc;
  selective_scan_bwd_kernel<<<dim3(blocks, batch), kThreads, kSmemBytes,
                              s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(dtx),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a_t), static_cast<const float*>(hc),
      static_cast<const float*>(dy), static_cast<float*>(d_dt),
      static_cast<float*>(d_dtx), static_cast<float*>(part_b),
      static_cast<float*>(part_c), seq, di, n, n_states);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(batch) * seq * n;
  const int sum_threads = 256;
  const long long want = (elems + sum_threads - 1) / sum_threads;
  const int grid = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  selective_scan_bwd_sum_kernel<<<grid, sum_threads, 0, s>>>(
      static_cast<const float*>(part_b), static_cast<const float*>(part_c),
      static_cast<float*>(d_b), static_cast<float*>(d_c), elems, blocks);
  return static_cast<int>(cudaGetLastError());
}
