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
// independent chains exist: about 8 warps per SM, too few to hide the
// latency of the loads and of the exp -> FMA chain. The kernel is
// latency-bound and well above its bound; a later design splits the state
// dim across threads or runs a chunked parallel scan.
// Design: the TPU grid's sequential chunk axis and the VMEM scratch that
// carries h become one loop over S inside the block. One thread owns one
// (batch row, channel) pair and keeps its states and its entries of A in
// registers. A block of 128 consecutive channels of one batch row stages
// each chunk of kChunk tokens of Bm and Cm (shared by every channel) in
// shared memory, and each thread loads the chunk's dt and dtx of its
// channel into registers first (all loads in flight at once, coalesced
// along di), then runs the chunk's recurrence and writes y coalesced. The
// kernel holds kMaxState = 16 states (the full-width configs' n); an n < 16
// runs with the states at i >= n held at zero (A = 0, B = C = 0), so any
// n <= 16 runs through the one build. The edge of di is masked; S needs no
// multiple. No atomics: deterministic. expf is
// the accurate one (no fast-math); nvcc contracts a*h + b into one FMA, so
// results differ from the plain version by rounding, not bitwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;
constexpr int kMaxState = 16;

__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ dtx,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_t,
                      const float* __restrict__ h0_t,
                      float* __restrict__ y, float* __restrict__ h_f,
                      int seq, int di, int n) {
  __shared__ float s_b[kChunk][kMaxState];
  __shared__ float s_c[kChunk][kMaxState];
  const long long b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;

  float a[kMaxState], h[kMaxState];
#pragma unroll
  for (int i = 0; i < kMaxState; ++i) {
    const bool ok = live && i < n;
    a[i] = ok ? a_t[static_cast<long long>(i) * di + d] : 0.0f;
    h[i] = ok ? h0_t[(b * n + i) * di + d] : 0.0f;
  }

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int len = min(kChunk, seq - t0);
    const long long tok = b * seq + t0;          // first token of the chunk
    __syncthreads();                             // last chunk's reads done
    for (int e = threadIdx.x; e < kChunk * kMaxState; e += kThreads) {
      const int tt = e / kMaxState, i = e % kMaxState;
      const bool ok = tt < len && i < n;
      const long long at = (tok + tt) * n + i;
      s_b[tt][i] = ok ? bm[at] : 0.0f;
      s_c[tt][i] = ok ? cm[at] : 0.0f;
    }
    float dt_r[kChunk], dx_r[kChunk];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const bool ok = live && tt < len;
      const long long at = (tok + tt) * di + d;
      dt_r[tt] = ok ? dt[at] : 0.0f;
      dx_r[tt] = ok ? dtx[at] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < len) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxState; ++i) {
          const float decay = expf(dt_r[tt] * a[i]);
          h[i] = decay * h[i] + dx_r[tt] * s_b[tt][i];
          acc += h[i] * s_c[tt][i];
        }
        if (live) y[(tok + tt) * di + d] = acc;
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < kMaxState; ++i)
      if (i < n) h_f[(b * n + i) * di + d] = h[i];
  }
}

}  // namespace

extern "C" int selective_scan(const void* dt, const void* dtx, const void* bm,
                              const void* cm, const void* a_t,
                              const void* h0_t, void* y, void* h_f, int batch,
                              int seq, int di, int n, void* stream) {
  if (batch <= 0 || di <= 0) return 0;
  if (n < 1 || n > kMaxState || batch > 65535 || seq < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f_dt = static_cast<const float*>(dt);
  const auto* f_dtx = static_cast<const float*>(dtx);
  const auto* f_bm = static_cast<const float*>(bm);
  const auto* f_cm = static_cast<const float*>(cm);
  const auto* f_a = static_cast<const float*>(a_t);
  const auto* f_h0 = static_cast<const float*>(h0_t);
  auto* f_y = static_cast<float*>(y);
  auto* f_hf = static_cast<float*>(h_f);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<<<grid, kThreads, 0, s>>>(f_dt, f_dtx, f_bm, f_cm,
                                                  f_a, f_h0, f_y, f_hf, seq,
                                                  di, n);
  return static_cast<int>(cudaGetLastError());
}
