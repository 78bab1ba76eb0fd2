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
// 3.35 TB/s; its B*S*di*n = 537 M exps take 0.128 ms on the SFUs. This
// design issues 1.75 exps a state-step (below), 0.225 ms on the SFUs, and
// about 24 instructions a state-step, 0.39 ms of issue on 132 SMs at
// 1.98 GHz; with 16 warps an SM it is partly latency-bound (its time is in
// PERF.md beside these bounds).
//
// Design:
//  - L lanes a channel (L = 4 or 8, adjacent in a warp), lane g holding
//    states g*kS .. g*kS + kS - 1 (kS = 16 / L) and their A in registers,
//    in a lane-dependent slot order (below); a block of 256 threads holds
//    256 / L channels of one batch row. At
//    L = 4: 2,048 warps at the training shape; the registers (at most 128)
//    and 106 KB of shared memory leave 2 blocks, 16 warps, an SM: one wave.
//    At L = 8: 4,096 warps, 3 blocks of 69 KB (24 warps) an SM. The
//    wrapper picks L (selective_scan.py: BWD_LANES, the faster of
//    chip_smoke.py's sweep).
//  - Two-level recompute. A chunk of kTc = 32 steps is 4 windows of kW = 8.
//    The pass from hc runs to the last window's start, keeping h at each
//    window's start (shared memory, kS floats a thread a window). Then
//    each window, last to first, recomputes a = exp(dt * A) and h over
//    its 8 steps into registers and walks back through them, reusing
//    those exps: 1 + 3/4 exps a state-step. a_{t+1} * g_{t+1} crosses
//    windows and chunks in registers, so g_t is one FMA. Exps are
//    ex2.approx of dt * A*log2(e); d_dt sums a_t g_t * h_{t-1} *
//    A*log2(e) and is scaled by ln(2) once.
//  - Loads run a chunk ahead: the chunk's dt, dtx, dy tiles, its B and C
//    rows and its hc states are staged by cp.async in a ring of two
//    stages, the next (earlier) chunk landing while this one is walked.
//  - d_dt and d_dtx sum over a channel's L lanes: each lane's partial sums
//    of L consecutive steps are reduced in K9's fixed xor tree, scattered
//    so that lane g ends with step g's (L - 1 shuffles for L steps), and
//    written in place over the chunk's dt and dtx tiles (only the lanes of
//    a channel read its column), which leave as coalesced rows after the
//    chunk.
//  - d_B and d_C sum over channels: at each step a lane's 2 * kS products
//    are reduced over the warp's 32 / L channels (= 2 * kS lanes) by one
//    xor reduce-scatter (masks L .. 16) that leaves each of the 32 lanes
//    one (quantity, state) sum, stored once. The lane of channel c in the
//    warp holds state g*kS + (j ^ (c % kS)) in slot j, so that at every
//    mask but 16 each lane keeps its even slot and sends its odd one:
//    2 * kS - 1 shuffles and 2 selects a step (with the same slot order
//    everywhere, selects would double the instructions). Each B and C row
//    is staged twice side by side, the second with its pairs of states
//    swapped, so a lane reads its slots as 8-byte vectors and a warp's
//    reads of a row hit 32 banks once. After each window the block
//    adds its 8 warps' sums in warp order and writes its partial to
//    [blocks along di, B, S, n]; a second kernel adds the blocks in index
//    order. No atomics anywhere: the same inputs give the same bits
//    (paper §3.2).
// n < 16 runs with the states at i >= n held at zero (A = 0, B = C = hc =
// 0); the edge of di and steps past S load zeros, which leave g at zero.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxState = 16;
constexpr int kTc = 32;            // steps between hc's states: a chunk
constexpr int kW = 8;              // steps a window holds in registers
constexpr int kWin = kTc / kW;     // windows a chunk
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The block's sum of its warps' d_B and d_C: one thread per (step of the
// window, lane).
static_assert(kThreads == kW * 32, "one thread per window step and lane");

template <int L>
struct Plan {
  static constexpr int kS = kMaxState / L;   // states a lane holds
  static constexpr int kC = kThreads / L;    // channels a block holds
  // A tile row, padded so that the L lanes of a channel, writing L steps,
  // fall in different banks.
  static constexpr int kRow = kC + 32 / L;
  static constexpr int kTile = kTc * kRow;
  // The B rows, then the C rows, [kTc][2][kMaxState]: each row as loaded
  // and with its pairs of states swapped, side by side (other banks).
  static constexpr int kRows = kTc * 2 * kMaxState;
  // Floats of one ring stage: the dt, dtx, dy tiles [kTc][kRow], the B
  // and C rows, hc's states [kMaxState][kC].
  static constexpr int kStage = 3 * kTile + 2 * kRows + kMaxState * kC;
  // The warps' d_B, d_C sums of a window [kWarps][kW][32], two windows.
  static constexpr int kPart = 2 * kWarps * kW * 32;
  // h at the start of windows 1 .. kWin - 1 [kWin - 1][kS][kThreads].
  static constexpr int kCk = (kWin - 1) * kS * kThreads;
  static constexpr int kSmemBytes = 4 * (2 * kStage + kPart + kCk);
  // Blocks an SM: 2 (128 registers a thread) at L = 4, 3 (85) at L = 8.
  static constexpr int kMinBlocks = L == 4 ? 2 : 3;
  static_assert(2 * kS == 32 / L, "a lane's products = the warp's channels");
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

__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage chunk k of this block (its dt, dtx, dy tiles, B and C rows and hc
// states) into ring stage `st`; steps past S and channels past di load
// zeros. States i >= n are never written: they keep the zeros the kernel
// put there first.
template <typename P>
__device__ __forceinline__ void load_chunk(
    float* st, const float* __restrict__ dt, const float* __restrict__ dtx,
    const float* __restrict__ dy, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ hc, long long b,
    int k, int n_states, int seq, int di, int d0, int n, bool vec_di,
    bool vec_n) {
  float* s_dt = st;
  float* s_dx = st + P::kTile;
  float* s_dy = st + 2 * P::kTile;
  float* s_b = st + 3 * P::kTile;
  float* s_c = s_b + P::kRows;
  float* s_hc = s_c + P::kRows;
  const int t0 = k * kTc;
  const int len = min(kTc, seq - t0);
  const long long tok = b * seq + t0;
  const long long hrow = (b * n_states + k) * n;
  if (vec_di) {                    // di % 4 == 0: a vector is all in or out
    constexpr int kVec = P::kC / 4;
    for (int e = threadIdx.x; e < kTc * kVec; e += kThreads) {
      const int tt = e / kVec, cc = 4 * (e % kVec), d = d0 + cc;
      const bool ok = tt < len && d < di;
      const long long at = ok ? (tok + tt) * di + d : 0;
      const int to = tt * P::kRow + cc;
      cp_async16(s_dt + to, dt + at, ok);
      cp_async16(s_dx + to, dtx + at, ok);
      cp_async16(s_dy + to, dy + at, ok);
    }
    for (int e = threadIdx.x; e < n * kVec; e += kThreads) {
      const int i = e / kVec, cc = 4 * (e % kVec), d = d0 + cc;
      const bool ok = d < di;
      cp_async16(s_hc + i * P::kC + cc,
                 hc + (ok ? (hrow + i) * di + d : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTc * P::kC; e += kThreads) {
      const int tt = e / P::kC, cc = e % P::kC, d = d0 + cc;
      const bool ok = tt < len && d < di;
      const long long at = ok ? (tok + tt) * di + d : 0;
      const int to = tt * P::kRow + cc;
      cp_async4(s_dt + to, dt + at, ok);
      cp_async4(s_dx + to, dtx + at, ok);
      cp_async4(s_dy + to, dy + at, ok);
    }
    for (int e = threadIdx.x; e < n * P::kC; e += kThreads) {
      const int i = e / P::kC, cc = e % P::kC, d = d0 + cc;
      const bool ok = d < di;
      cp_async4(s_hc + i * P::kC + cc, hc + (ok ? (hrow + i) * di + d : 0),
                ok);
    }
  }
  // The second copy of the rows: state i at i ^ 1.
  for (int e = threadIdx.x; e < kTc * n; e += kThreads) {
    const int tt = e / n, i = e % n;
    const bool ok = tt < len;
    const long long at = ok ? (tok + tt) * n + i : 0;
    const int to = (2 * tt + 1) * kMaxState + (i ^ 1);
    cp_async4(s_b + to, bm + at, ok);
    cp_async4(s_c + to, cm + at, ok);
  }
  if (vec_n) {                     // n % 4 == 0
    const int row = n / 4;
    for (int e = threadIdx.x; e < kTc * row; e += kThreads) {
      const int tt = e / row, i = 4 * (e % row);
      const bool ok = tt < len;
      const long long at = ok ? (tok + tt) * n + i : 0;
      cp_async16(s_b + 2 * tt * kMaxState + i, bm + at, ok);
      cp_async16(s_c + 2 * tt * kMaxState + i, cm + at, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTc * n; e += kThreads) {
      const int tt = e / n, i = e % n;
      const bool ok = tt < len;
      const long long at = ok ? (tok + tt) * n + i : 0;
      cp_async4(s_b + 2 * tt * kMaxState + i, bm + at, ok);
      cp_async4(s_c + 2 * tt * kMaxState + i, cm + at, ok);
    }
  }
}

// Sum v[u] (this lane's partial sum for step u of L) over the L lanes of a
// channel, in the tree ((p0 + p1) + (p2 + p3)) ...: at the step of mask m a
// lane keeps the steps whose bit m equals its own and sends the others to
// lane ^ m. Lane g ends with step g's sum in v[0] (K9's reduce_scatter).
template <int L>
__device__ __forceinline__ void lane_sum(float (&v)[L], int g) {
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

// The sum of v (a lane's 2 * kS products: d_B's for its kS state slots,
// then d_C's) over the warp's 32 / L channels (lane bits L .. 16), one
// reduce-scatter over masks L, 2L, .. 16. Lane l = L*c + g holds state
// g*kS + (j ^ x) in slot j, x = c % kS, so at each mask below 16 the even
// slot holds the state that the lane keeps and the odd slot the one its
// partner keeps: no selects. Mask 16 keeps d_B or d_C. Lane l ends with
// quantity c / kS of state g*kS + x summed over the channels g, L + g, ..
// in the xor tree.
template <int L>
__device__ __forceinline__ float channel_sum(float (&v)[32 / L], int lane) {
#pragma unroll
  for (int m = L, k = 32 / L; m < 16; m <<= 1, k >>= 1) {
#pragma unroll
    for (int j = 0; j < k / 2; ++j)
      v[j] = v[2 * j] + __shfl_xor_sync(0xffffffffu, v[2 * j + 1], m);
  }
  const bool up = lane & 16;
  return (up ? v[1] : v[0]) +
         __shfl_xor_sync(0xffffffffu, up ? v[0] : v[1], 16);
}

// kS slots of a B or C row (from `p`, this lane's base in the row): slot j
// holds state g*kS + (j ^ x). The copy with pairs swapped (x odd) and the
// order of the 8-byte pairs (bit 1 of x, lane-dependent offsets) give each
// lane its slots from kS / 2 vector loads.
template <int kS>
__device__ __forceinline__ void load_slots(const float* p,
                                           const int (&off)[kS / 2],
                                           float (&v)[kS]) {
#pragma unroll
  for (int j = 0; j < kS / 2; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(p + off[j]);
    v[2 * j] = x.x, v[2 * j + 1] = x.y;
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, Plan<L>::kMinBlocks)
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
                          int n, int n_states, bool vec_di, bool vec_n) {
  using P = Plan<L>;
  constexpr int kS = P::kS;
  extern __shared__ __align__(16) float smem[];
  float* s_part = smem + 2 * P::kStage;
  float* s_ck = s_part + P::kPart;

  const long long b = blockIdx.y;
  const long long batch = gridDim.y;
  const int d0 = blockIdx.x * P::kC;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = tid / L, g = tid % L;
  const int d = d0 + c;
  const bool live = d < di;
  // Slot j of this lane holds state g*kS + (j ^ x) (channel_sum).
  const int x = (lane / L) % kS;
  int slot[kS], off[kS / 2];
#pragma unroll
  for (int j = 0; j < kS; ++j) slot[j] = g * kS + (j ^ x);
#pragma unroll
  for (int j = 0; j < kS / 2; ++j)
    off[j] = (x & 1) * kMaxState + g * kS + ((2 * j) ^ (x & ~1));

  // States i >= n of both stages' B, C rows (both copies) and hc states:
  // zero, once.
  constexpr int kZero = 2 * P::kRows + kMaxState * P::kC;
  for (int e = tid; e < 2 * kZero; e += kThreads) {
    const int r = e % kZero;
    const bool dead = r < 2 * P::kRows
                          ? (r % kMaxState ^ (r / kMaxState) % 2) >= n
                          : r - 2 * P::kRows >= n * P::kC;
    if (dead) smem[(e / kZero) * P::kStage + 3 * P::kTile + r] = 0.0f;
  }

  float a2[kS];                          // A * log2(e)
#pragma unroll
  for (int j = 0; j < kS; ++j)
    a2[j] = live && slot[j] < n
                ? a_t[static_cast<long long>(slot[j]) * di + d] * kLog2e
                : 0.0f;
  float ag[kS];                          // a_{t+1} * g_{t+1}
#pragma unroll
  for (int j = 0; j < kS; ++j) ag[j] = 0.0f;

  load_chunk<P>(smem + ((n_states - 1) & 1) * P::kStage, dt, dtx, dy, bm, cm,
                hc, b, n_states - 1, n_states, seq, di, d0, n, vec_di, vec_n);
  cp_async_commit();
  int buf = 0;                           // the s_part half this window fills
  for (int k = n_states - 1; k >= 0; --k) {
    cp_async_wait<0>();                  // this thread's copies of chunk k
    // Every thread's copies of chunk k have landed, and every thread has
    // stored chunk k + 1's outputs: its stage is free for chunk k - 1.
    __syncthreads();
    if (k > 0)
      load_chunk<P>(smem + ((k - 1) & 1) * P::kStage, dt, dtx, dy, bm, cm,
                    hc, b, k - 1, n_states, seq, di, d0, n, vec_di, vec_n);
    cp_async_commit();

    float* st = smem + (k & 1) * P::kStage;
    float* s_dt = st;
    float* s_dx = st + P::kTile;
    const float* s_dy = st + 2 * P::kTile;
    const float* s_b = st + 3 * P::kTile;
    const float* s_c = s_b + P::kRows;
    const float* s_hc = s_c + P::kRows;
    const int t0 = k * kTc;
    const int len = min(kTc, seq - t0);
    const int nwin = (len + kW - 1) / kW;

    // The pass from hc to the last window's start, keeping h at each
    // window's start.
    {
      float h[kS];
#pragma unroll
      for (int j = 0; j < kS; ++j) h[j] = s_hc[slot[j] * P::kC + c];
#pragma unroll 1
      for (int w = 0; w + 1 < nwin; ++w) {
#pragma unroll
        for (int u = 0; u < kW; ++u) {
          const int tt = w * kW + u;
          const float dtv = s_dt[tt * P::kRow + c];
          const float dxv = s_dx[tt * P::kRow + c];
          float bb[kS];
          load_slots<kS>(s_b + 2 * tt * kMaxState, off, bb);
#pragma unroll
          for (int j = 0; j < kS; ++j)
            h[j] = fmaf(exp2_sfu(dtv * a2[j]), h[j], dxv * bb[j]);
        }
#pragma unroll
        for (int j = 0; j < kS; ++j)
          s_ck[(w * kS + j) * kThreads + tid] = h[j];
      }
    }

#pragma unroll 1
    for (int w = nwin - 1; w >= 0; --w) {
      // a and h over the window's steps, from h at its start (h0).
      float h0[kS], aw[kW][kS], hw[kW][kS];
#pragma unroll
      for (int j = 0; j < kS; ++j)
        h0[j] = w == 0 ? s_hc[slot[j] * P::kC + c]
                       : s_ck[((w - 1) * kS + j) * kThreads + tid];
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        const int tt = w * kW + u;
        const float dtv = s_dt[tt * P::kRow + c];
        const float dxv = s_dx[tt * P::kRow + c];
        float bb[kS];
        load_slots<kS>(s_b + 2 * tt * kMaxState, off, bb);
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          aw[u][j] = exp2_sfu(dtv * a2[j]);
          hw[u][j] = fmaf(aw[u][j], u > 0 ? hw[u - 1][j] : h0[j],
                          dxv * bb[j]);
        }
      }

      // The window backwards.
      float* part = s_part + (buf * kWarps + warp) * kW * 32;
      float vdt[L], vdx[L];
#pragma unroll
      for (int u = kW - 1; u >= 0; --u) {
        const int tt = w * kW + u;
        const float dyv = s_dy[tt * P::kRow + c];
        const float dxv = s_dx[tt * P::kRow + c];
        float bb[kS], cc[kS], v[2 * kS];
        load_slots<kS>(s_b + 2 * tt * kMaxState, off, bb);
        load_slots<kS>(s_c + 2 * tt * kMaxState, off, cc);
        float pdt = 0.0f, pdx = 0.0f;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          const float gr = fmaf(dyv, cc[j], ag[j]);       // g_t
          ag[j] = aw[u][j] * gr;
          const float hp = u > 0 ? hw[u - 1][j] : h0[j];
          pdt = fmaf(ag[j] * hp, a2[j], pdt);
          pdx = fmaf(gr, bb[j], pdx);
          v[j] = gr * dxv;
          v[kS + j] = hw[u][j] * dyv;
        }
        vdt[u % L] = pdt;
        vdx[u % L] = pdx;
        part[u * 32 + lane] = channel_sum<L>(v, lane);
        if (u % L == 0) {
          // Steps tt .. tt + L - 1 summed over the channel's lanes; lane g
          // has step tt + g's. Every lane of the channel has read those
          // steps' dtx (their products fed the shuffles above).
          lane_sum<L>(vdt, g);
          lane_sum<L>(vdx, g);
          s_dt[(tt + g) * P::kRow + c] = vdt[0] * kLn2;
          s_dx[(tt + g) * P::kRow + c] = vdx[0];
        }
      }
      // Every warp's sums of the window are in; the other half of s_part
      // was last read before this barrier.
      __syncthreads();
      {
        const int u = tid / 32, l = tid % 32;
        const float* src = s_part + buf * kWarps * kW * 32 + u * 32 + l;
        float sum = 0.0f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) sum += src[wp * kW * 32];
        const int cq = l / L, q = cq / kS, i = (l % L) * kS + cq % kS;
        const int tt = w * kW + u;
        if (tt < len && i < n) {
          float* out = q == 0 ? part_b : part_c;
          out[((blockIdx.x * batch + b) * seq + t0 + tt) * n + i] = sum;
        }
      }
      buf ^= 1;
    }

    // d_dt and d_dtx of the chunk, complete in its tiles since the last
    // window's barrier, as whole rows.
    if (vec_di) {
      constexpr int kVec = P::kC / 4;
      for (int e = tid; e < kTc * kVec; e += kThreads) {
        const int tt = e / kVec, cc = 4 * (e % kVec);
        if (tt < len && d0 + cc < di) {
          const long long at = (b * seq + t0 + tt) * di + d0 + cc;
          const int from = tt * P::kRow + cc;
          *reinterpret_cast<float4*>(d_dt + at) =
              *reinterpret_cast<const float4*>(s_dt + from);
          *reinterpret_cast<float4*>(d_dtx + at) =
              *reinterpret_cast<const float4*>(s_dx + from);
        }
      }
    } else {
      for (int e = tid; e < kTc * P::kC; e += kThreads) {
        const int tt = e / P::kC, cc = e % P::kC;
        if (tt < len && d0 + cc < di) {
          const long long at = (b * seq + t0 + tt) * di + d0 + cc;
          d_dt[at] = s_dt[tt * P::kRow + cc];
          d_dtx[at] = s_dx[tt * P::kRow + cc];
        }
      }
    }
  }
}

// d_B and d_C: the blocks' partials [blocks, B*S*n] added in index order,
// 16 blocks' loads in flight before their adds.
__global__ void selective_scan_bwd_sum_kernel(const float* __restrict__ part_b,
                                              const float* __restrict__ part_c,
                                              float* __restrict__ d_b,
                                              float* __restrict__ d_c,
                                              long long elems, int blocks) {
  constexpr int kAhead = 16;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < elems; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sb = 0.0f, sc = 0.0f;
    for (int x0 = 0; x0 < blocks; x0 += kAhead) {
      float vb[kAhead], vc[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const bool ok = x0 + j < blocks;
        vb[j] = ok ? part_b[(x0 + j) * elems + e] : 0.0f;
        vc[j] = ok ? part_c[(x0 + j) * elems + e] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j)
        if (x0 + j < blocks) sb += vb[j], sc += vc[j];
    }
    d_b[e] = sb;
    d_c[e] = sc;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int L>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(selective_scan_bwd_kernel<L>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Plan<L>::kSmemBytes);
}

template <int L>
int launch(const float* dt, const float* dtx, const float* bm,
           const float* cm, const float* a_t, const float* hc,
           const float* dy, float* d_dt, float* d_dtx, float* d_b, float* d_c,
           float* part_b, float* part_c, int batch, int seq, int di, int n,
           cudaStream_t s) {
  using P = Plan<L>;
  const cudaError_t attr = set_smem<L>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec_di = di % 4 == 0 && aligned16(dt) && aligned16(dtx) &&
                      aligned16(dy) && aligned16(hc) && aligned16(d_dt) &&
                      aligned16(d_dtx);
  const bool vec_n = n % 4 == 0 && aligned16(bm) && aligned16(cm);
  const int blocks = (di + P::kC - 1) / P::kC;
  const int n_states = (seq + kTc - 1) / kTc;
  selective_scan_bwd_kernel<L><<<dim3(blocks, batch), kThreads,
                                 P::kSmemBytes, s>>>(
      dt, dtx, bm, cm, a_t, hc, dy, d_dt, d_dtx, part_b, part_c, seq, di, n,
      n_states, vec_di, vec_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(batch) * seq * n;
  const int sum_threads = 256;
  const long long want = (elems + sum_threads - 1) / sum_threads;
  const int grid = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  selective_scan_bwd_sum_kernel<<<grid, sum_threads, 0, s>>>(
      part_b, part_c, d_b, d_c, elems, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int occupancy(int* out) {
  cudaError_t err = set_smem<L>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, selective_scan_bwd_kernel<L>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, selective_scan_bwd_kernel<L>, kThreads, Plan<L>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = Plan<L>::kSmemBytes;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

// part_b and part_c: scratch of [ceil(di / (256 / lanes)), batch, seq, n]
// floats each.
extern "C" int selective_scan_bwd(const void* dt, const void* dtx,
                                  const void* bm, const void* cm,
                                  const void* a_t, const void* hc,
                                  const void* dy, void* d_dt, void* d_dtx,
                                  void* d_b, void* d_c, void* part_b,
                                  void* part_c, int tc, int batch, int seq,
                                  int di, int n, int lanes, void* stream) {
  if (batch <= 0 || di <= 0 || seq <= 0) return 0;
  if (n < 1 || n > kMaxState || batch > 65535 || tc != kTc)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f_dt = static_cast<const float*>(dt);
  const auto* f_dtx = static_cast<const float*>(dtx);
  const auto* f_bm = static_cast<const float*>(bm);
  const auto* f_cm = static_cast<const float*>(cm);
  const auto* f_a = static_cast<const float*>(a_t);
  const auto* f_hc = static_cast<const float*>(hc);
  const auto* f_dy = static_cast<const float*>(dy);
  auto* f_ddt = static_cast<float*>(d_dt);
  auto* f_ddx = static_cast<float*>(d_dtx);
  auto* f_db = static_cast<float*>(d_b);
  auto* f_dc = static_cast<float*>(d_c);
  auto* f_pb = static_cast<float*>(part_b);
  auto* f_pc = static_cast<float*>(part_c);
  auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4:
      return launch<4>(f_dt, f_dtx, f_bm, f_cm, f_a, f_hc, f_dy, f_ddt, f_ddx,
                       f_db, f_dc, f_pb, f_pc, batch, seq, di, n, s);
    case 8:
      return launch<8>(f_dt, f_dtx, f_bm, f_cm, f_a, f_hc, f_dy, f_ddt, f_ddx,
                       f_db, f_dc, f_pb, f_pc, batch, seq, di, n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward kernel's residency at `lanes`: out = {blocks an SM,
// threads a block, registers a thread, dynamic shared memory bytes a
// block, local (spilled) bytes a thread}.
extern "C" int selective_scan_bwd_occupancy(int lanes, int* out) {
  switch (lanes) {
    case 4:
      return occupancy<4>(out);
    case 8:
      return occupancy<8>(out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
