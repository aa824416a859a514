// Mamba2 SSD chunked scan for Hopper (sm_90a), forward and backward, with a
// plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:ssd_scan
// (pallas_call at ssd_scan.py:88). Per (batch b, head h), with the state
// h (P x N) carried over chunks of length L:
//
//   s_t   = cumsum_{tau <= t}(dt_tau * A)              (within the chunk)
//   y_t   = sum_{u <= t} (C_t . B_u) exp(s_t - s_u) dt_u x_u
//         + exp(s_t) h C_t + D x_t
//   h'    = exp(s_L) h + sum_u exp(s_L - s_u) dt_u x_u B_u^T
//
// x (Bt, T, H, P), dt (Bt, T, H), A and D (H), B and C (Bt, T, N) shared by
// all heads (ngroups = 1); y (Bt, T, H, P) and the final state
// (Bt, H, P, N), all float32.
//
// Design. The TPU kernel walks the chunks as a sequential grid axis and
// carries the state in VMEM scratch. Hopper's blocks run in no order, so
// here one block of 256 threads owns one (b, h) and loops over the chunks
// itself, with the state in shared memory. The chunk length is the
// kernel's own, L = 64: the TPU's L = 256 would need a 256 KB L x L tile,
// more than a block's 227 KB. The chunk length changes only the rounding,
// not the function. A ragged last chunk is zero-padded in shared memory
// (dt, x, B, C = 0 contribute nothing), so any T runs, and this one kernel
// serves both cases the reference tells apart (ssd_chunked when T is a
// multiple of its chunk, the sequential ssd_reference otherwise).
//
// Every matrix product is written as: each warp owns whole rows of the
// output (its operand is read at one address by all lanes, a broadcast),
// and the lanes own consecutive columns. Every shared-memory matrix has an
// odd row stride (cols + 1), so a column read by consecutive lanes hits
// consecutive banks whichever index runs along the lanes. Sums accumulate
// in float32 with IEEE expf (the file is never built with fast math). The
// gate exp(s_t - s_u) is evaluated for u <= t only, where it is <= 1: the
// upper triangle, which overflows, is never exponentiated.
//
// The forward saves the state entering each chunk, (Bt, H, nc, P, N), when
// the caller asks for it; the backward reads them and runs the chunks in
// reverse, carrying dh (P x N) in shared memory, so it never redoes the
// recurrence. It returns dx, ddt, and per-(b, h) partials of dA and dD and
// per-head partials of dB and dC (Bt, H, T, N): B and C are shared across
// heads, and the caller sums the partials over heads in a fixed order,
// so the result does not depend on the order in which blocks run.
//
// Bound on the H100 at the LM path's shape (Bt 8, T 512, H 32, P 64,
// N 128), forward: the arrays it must read and write (x, y 33.5 MB each,
// B and C 2.1 MB each, the final state 8.4 MB; plus 67 MB of chunk states
// when training) move in 24 us (44 us) at 3.35 TB/s. The products the
// function needs at L = 64 are about 4.9 GFLOP, 73 us at the card's
// 67 TFLOP/s float32 without tensor cores: C B^T once per (b, chunk),
// since B and C are shared by the heads, and per head the masked product
// with x, C h and the state update. The backward needs about 9.8 GFLOP,
// 0.15 ms: dC and dB once on the head-summed dCB. So it is bound by
// operations. This version does more than that: each (b, h) block forms
// C B^T itself, and the backward's dB and dC products run per head
// (5.9 and 13 GFLOP in all). It reads its operands from shared memory
// with register tiles of up to 8 x 4 and does not use tensor cores (TF32
// would round x, B and C to 10 bits); sharing C B^T across a row's heads
// and wgmma are the levers for a later version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kL = 64;         // chunk length
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPMax = 64;      // head dim P <= 64
constexpr int kNMax = 128;     // state size N <= 128
constexpr int kLdP = kPMax + 1;
constexpr int kLdN = kNMax + 1;
constexpr int kLdL = kL + 1;
constexpr int kRowsL = kL / kWarps;     // output rows per warp: L rows
constexpr int kRowsP = kPMax / kWarps;  // output rows per warp: P rows
constexpr int kColsL = kL / 32;         // columns per lane: L columns
constexpr int kColsP = kPMax / 32;      // columns per lane: P columns
constexpr int kColsN = kNMax / 32;      // columns per lane: N columns
constexpr int kVec = 16;                // per-chunk vectors of length L

constexpr size_t kFwdSmem =
    sizeof(float) * (kPMax * kLdN + kL * kLdP + 2 * kL * kLdN +
                     kL * kLdL + kVec * kL + kWarps);
constexpr size_t kBwdSmem =
    sizeof(float) * (2 * kPMax * kLdN + 2 * kL * kLdP + 2 * kL * kLdN +
                     2 * kL * kLdL + kVec * kL + kWarps);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the result. `red` holds kWarps
// floats; the block synchronises inside.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Stage one chunk of x (or dy) as [t][p], and B, C as [t][n], zero-padded
// beyond the chunk's Lc rows and beyond P, N columns.
__device__ void load_xp(const float* __restrict__ src, float* dst, size_t row0,
                        int row_stride, int Lc, int P) {
  for (int i = threadIdx.x; i < kL * kPMax; i += kThreads) {
    const int t = i / kPMax, p = i % kPMax;
    dst[t * kLdP + p] =
        (t < Lc && p < P) ? src[row0 + (size_t)t * row_stride + p] : 0.f;
  }
}

__device__ void load_bc(const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* bs, float* cs,
                        size_t row0, int Lc, int N) {
  for (int i = threadIdx.x; i < kL * kNMax; i += kThreads) {
    const int t = i / kNMax, n = i % kNMax;
    float bv = 0.f, cv = 0.f;
    if (t < Lc && n < N) {
      const size_t o = row0 + (size_t)t * N + n;
      bv = Bm[o];
      cv = Cm[o];
    }
    bs[t * kLdN + n] = bv;
    cs[t * kLdN + n] = cv;
  }
}

// s_t = cumsum(dt_t * A) over the chunk, in order, rounded as
// fl(fl(s_{t-1}) + fl(dt_t * A)) without contraction. Thread 0 only.
__device__ void chunk_cumsum(const float* dts, float* ss, float Ah) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int t = 0; t < kL; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(dts[t], Ah));
      ss[t] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_fwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ D,
                    float* __restrict__ y, float* __restrict__ fin,
                    float* __restrict__ states, int T, int H, int P, int N) {
  extern __shared__ float sm[];
  float* hs = sm;                   // [P][N]   state
  float* xs = hs + kPMax * kLdN;    // [L][P]
  float* bs = xs + kL * kLdP;       // [L][N]
  float* cs = bs + kL * kLdN;       // [L][N]
  float* ms = cs + kL * kLdN;       // [L][L]   M = CB o gate o dt_u
  float* ss = ms + kL * kLdL;       // [L]      cumulative log decay
  float* dts = ss + kL;             // [L]
  float* ws = dts + kL;             // [L]      exp(total - s_u) dt_u

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float Ah = A[h], Dh = D[h];
  const int nc = (T + kL - 1) / kL;
  const size_t bh = (size_t)b * H + h;

  for (int i = threadIdx.x; i < kPMax * kLdN; i += kThreads) hs[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kL;
    const int Lc = min(kL, T - t0);
    __syncthreads();  // the previous chunk is done with shared memory
    load_xp(x, xs, (((size_t)b * T + t0) * H + h) * P, H * P, Lc, P);
    load_bc(Bm, Cm, bs, cs, ((size_t)b * T + t0) * N, Lc, N);
    if (threadIdx.x < kL)
      dts[threadIdx.x] = threadIdx.x < Lc
                             ? dt[((size_t)b * T + t0 + threadIdx.x) * H + h]
                             : 0.f;
    if (states) {  // the state entering chunk c, for the backward
      float* dst = states + (bh * nc + c) * (size_t)P * N;
      for (int i = threadIdx.x; i < P * N; i += kThreads)
        dst[i] = hs[(i / N) * kLdN + i % N];
    }
    __syncthreads();
    chunk_cumsum(dts, ss, Ah);
    __syncthreads();
    const float total = ss[kL - 1];
    if (threadIdx.x < kL)
      ws[threadIdx.x] = expf(total - ss[threadIdx.x]) * dts[threadIdx.x];

    // M[t][u] = (C_t . B_u) exp(s_t - s_u) dt_u for u <= t, else 0
    {
      const int r0 = warp * kRowsL;
      float acc[kRowsL][kColsL] = {};
      for (int n = 0; n < N; ++n) {
        float yv[kColsL];
#pragma unroll
        for (int j = 0; j < kColsL; ++j) yv[j] = bs[(lane + 32 * j) * kLdN + n];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = cs[(r0 + i) * kLdN + n];
#pragma unroll
          for (int j = 0; j < kColsL; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int t = r0 + i;
#pragma unroll
        for (int j = 0; j < kColsL; ++j) {
          const int u = lane + 32 * j;
          ms[t * kLdL + u] =
              u <= t ? acc[i][j] * expf(ss[t] - ss[u]) * dts[u] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t][p] = sum_u M[t][u] x[u][p] + exp(s_t) sum_n C[t][n] h[p][n]
    //         + D x[t][p]
    {
      const int r0 = warp * kRowsL;
      float ai[kRowsL][kColsP] = {};
      float ae[kRowsL][kColsP] = {};
      const int umax = r0 + kRowsL;  // M[t][u] = 0 for u > t
      for (int u = 0; u < umax; ++u) {
        float yv[kColsP];
#pragma unroll
        for (int j = 0; j < kColsP; ++j) yv[j] = xs[u * kLdP + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = ms[(r0 + i) * kLdL + u];
#pragma unroll
          for (int j = 0; j < kColsP; ++j) ai[i][j] = fmaf(xv, yv[j], ai[i][j]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float yv[kColsP];
#pragma unroll
        for (int j = 0; j < kColsP; ++j) yv[j] = hs[(lane + 32 * j) * kLdN + n];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = cs[(r0 + i) * kLdN + n];
#pragma unroll
          for (int j = 0; j < kColsP; ++j) ae[i][j] = fmaf(xv, yv[j], ae[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int t = r0 + i;
        if (t >= Lc) continue;
        const float es = expf(ss[t]);
        float* yrow = y + (((size_t)b * T + t0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < kColsP; ++j) {
          const int p = lane + 32 * j;
          if (p < P) yrow[p] = ai[i][j] + es * ae[i][j] + Dh * xs[t * kLdP + p];
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // h[p][n] = exp(total) h[p][n] + sum_u x[u][p] w_u B[u][n]
    {
      const int r0 = warp * kRowsP;
      float acc[kRowsP][kColsN] = {};
      for (int u = 0; u < Lc; ++u) {
        const float wu = ws[u];
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = bs[u * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsP; ++i) {
          const float xv = xs[u * kLdP + r0 + i] * wu;
#pragma unroll
          for (int j = 0; j < kColsN; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
      const float dec = expf(total);
#pragma unroll
      for (int i = 0; i < kRowsP; ++i)
#pragma unroll
        for (int j = 0; j < kColsN; ++j) {
          float* hp = hs + (r0 + i) * kLdN + lane + 32 * j;
          *hp = dec * *hp + acc[i][j];
        }
    }
  }
  __syncthreads();
  float* dst = fin + bh * (size_t)P * N;
  for (int i = threadIdx.x; i < P * N; i += kThreads)
    dst[i] = hs[(i / N) * kLdN + i % N];
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_bwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ D,
                    const float* __restrict__ states,
                    const float* __restrict__ dy,
                    const float* __restrict__ dfin, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ dA_part,
                    float* __restrict__ dB_part, float* __restrict__ dC_part,
                    float* __restrict__ dD_part, int T, int H, int P,
                    int N) {
  extern __shared__ float sm[];
  float* h0 = sm;                   // [P][N]  state entering the chunk
  float* dh = h0 + kPMax * kLdN;    // [P][N]  gradient of the state leaving it
  float* xs = dh + kPMax * kLdN;    // [L][P]
  float* dys = xs + kL * kLdP;      // [L][P]
  float* bs = dys + kL * kLdP;      // [L][N]
  float* cs = bs + kL * kLdN;       // [L][N]
  float* s1 = cs + kL * kLdN;       // [L][L]  (C_t . B_u) exp(s_t - s_u), u <= t
  float* s2 = s1 + kL * kLdL;       // [L][L]  dM, then dCB
  float* ss = s2 + kL * kLdL;       // [L] cumulative log decay
  float* dts = ss + kL;             // [L]
  float* ws = dts + kL;             // [L] exp(total - s_u) dt_u
  float* ddtm = ws + kL;            // [L] sum_t dM[t][u] s1[t][u]
  float* rowe = ddtm + kL;          // [L] sum_u dM[t][u] M[t][u]
  float* dwv = rowe + kL;           // [L] dL/dw_u
  float* dsi = dwv + kL;            // [L] ds_t through the carried state
  float* cole = dsi + kL;           // [L] sum_{t > u} dM[t][u] M[t][u]
  float* red = ss + kVec * kL;      // [kWarps]

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float Ah = A[h], Dh = D[h];
  const int nc = (T + kL - 1) / kL;
  const size_t bh = (size_t)b * H + h;

  for (int i = threadIdx.x; i < kPMax * kLdN; i += kThreads) {
    const int p = i / kLdN, n = i % kLdN;
    dh[i] = (dfin && p < P && n < N) ? dfin[(bh * P + p) * N + n] : 0.f;
  }
  float dA_acc = 0.f, dD_acc = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kL;
    const int Lc = min(kL, T - t0);
    __syncthreads();
    const size_t xrow0 = (((size_t)b * T + t0) * H + h) * P;
    load_xp(x, xs, xrow0, H * P, Lc, P);
    load_xp(dy, dys, xrow0, H * P, Lc, P);
    load_bc(Bm, Cm, bs, cs, ((size_t)b * T + t0) * N, Lc, N);
    {
      const float* src = states + (bh * nc + c) * (size_t)P * N;
      for (int i = threadIdx.x; i < kPMax * kLdN; i += kThreads) {
        const int p = i / kLdN, n = i % kLdN;
        h0[i] = (p < P && n < N) ? src[p * N + n] : 0.f;
      }
    }
    if (threadIdx.x < kL)
      dts[threadIdx.x] = threadIdx.x < Lc
                             ? dt[((size_t)b * T + t0 + threadIdx.x) * H + h]
                             : 0.f;
    __syncthreads();
    chunk_cumsum(dts, ss, Ah);
    __syncthreads();
    const float total = ss[kL - 1];
    if (threadIdx.x < kL)
      ws[threadIdx.x] = expf(total - ss[threadIdx.x]) * dts[threadIdx.x];

    // s1[t][u] = (C_t . B_u) exp(s_t - s_u), s2[t][u] = dy_t . x_u (u <= t)
    {
      const int r0 = warp * kRowsL;
      float acc[kRowsL][kColsL] = {};
      for (int n = 0; n < N; ++n) {
        float yv[kColsL];
#pragma unroll
        for (int j = 0; j < kColsL; ++j) yv[j] = bs[(lane + 32 * j) * kLdN + n];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = cs[(r0 + i) * kLdN + n];
#pragma unroll
          for (int j = 0; j < kColsL; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
      float dm[kRowsL][kColsL] = {};
      for (int p = 0; p < P; ++p) {
        float yv[kColsL];
#pragma unroll
        for (int j = 0; j < kColsL; ++j) yv[j] = xs[(lane + 32 * j) * kLdP + p];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = dys[(r0 + i) * kLdP + p];
#pragma unroll
          for (int j = 0; j < kColsL; ++j) dm[i][j] = fmaf(xv, yv[j], dm[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int t = r0 + i;
#pragma unroll
        for (int j = 0; j < kColsL; ++j) {
          const int u = lane + 32 * j;
          const bool lower = u <= t;
          s1[t * kLdL + u] = lower ? acc[i][j] * expf(ss[t] - ss[u]) : 0.f;
          s2[t * kLdL + u] = lower ? dm[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // column and row sums of dM o s1: ddt through M's dt_u factor, and the
    // parts of ds through the gate. The gate's diagonal (u = t) is
    // exp(s_t - s_t): it adds E[t][t] to ds_t and takes it away again, so
    // both sums leave it out rather than cancel it in rounding — beside
    // O(1) diagonal terms the off-diagonal ones can be e^-10 smaller.
    if (threadIdx.x < kL) {
      const int u = threadIdx.x;
      float acc = 0.f;
      for (int t = u + 1; t < kL; ++t)
        acc += s2[t * kLdL + u] * s1[t * kLdL + u];
      ddtm[u] = s2[u * kLdL + u] * s1[u * kLdL + u] + acc;
      cole[u] = acc * dts[u];
    } else if (threadIdx.x < 2 * kL) {
      const int t = threadIdx.x - kL;
      float acc = 0.f;
      for (int u = 0; u < t; ++u)
        acc += s2[t * kLdL + u] * s1[t * kLdL + u] * dts[u];
      rowe[t] = acc;
    }
    __syncthreads();
    // s2 := dCB[t][u] = dM[t][u] exp(s_t - s_u) dt_u
    for (int i = threadIdx.x; i < kL * kL; i += kThreads) {
      const int t = i / kL, u = i % kL;
      if (u <= t) s2[t * kLdL + u] *= expf(ss[t] - ss[u]) * dts[u];
    }
    __syncthreads();

    // dx[u][p] = dt_u sum_t s1[t][u] dy[t][p] + w_u r[u][p] + D dy[u][p],
    // r[u][p] = sum_n B[u][n] dh[p][n];  dw_u = sum_p x[u][p] r[u][p]
    {
      const int r0 = warp * kRowsL;
      float a1[kRowsL][kColsP] = {};
      float a2[kRowsL][kColsP] = {};
      for (int t = r0; t < kL; ++t) {  // s1[t][u] = 0 for t < u
        float yv[kColsP];
#pragma unroll
        for (int j = 0; j < kColsP; ++j) yv[j] = dys[t * kLdP + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = s1[t * kLdL + r0 + i];
#pragma unroll
          for (int j = 0; j < kColsP; ++j) a1[i][j] = fmaf(xv, yv[j], a1[i][j]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float yv[kColsP];
#pragma unroll
        for (int j = 0; j < kColsP; ++j) yv[j] = dh[(lane + 32 * j) * kLdN + n];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = bs[(r0 + i) * kLdN + n];
#pragma unroll
          for (int j = 0; j < kColsP; ++j) a2[i][j] = fmaf(xv, yv[j], a2[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int u = r0 + i;
        float dw = 0.f;
#pragma unroll
        for (int j = 0; j < kColsP; ++j) {
          const int p = lane + 32 * j;
          const float xv = xs[u * kLdP + p], dyv = dys[u * kLdP + p];
          dw += xv * a2[i][j];
          dD_acc += dyv * xv;
          if (u < Lc && p < P)
            dx[xrow0 + (size_t)u * H * P + p] =
                dts[u] * a1[i][j] + ws[u] * a2[i][j] + Dh * dyv;
        }
        dw = warp_sum(dw);
        if (lane == 0) dwv[u] = dw;
      }
    }

    // dB[u][n] = sum_p w_u x[u][p] dh[p][n] + sum_t dCB[t][u] C[t][n]
    {
      const int r0 = warp * kRowsL;
      float acc[kRowsL][kColsN] = {};
      for (int p = 0; p < P; ++p) {
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = dh[p * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = ws[r0 + i] * xs[(r0 + i) * kLdP + p];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
      for (int t = r0; t < kL; ++t) {  // dCB[t][u] = 0 for t < u
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = cs[t * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = s2[t * kLdL + r0 + i];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int u = r0 + i;
        if (u >= Lc) continue;
        float* row = dB_part + ((bh * T) + t0 + u) * N;
#pragma unroll
        for (int j = 0; j < kColsN; ++j) {
          const int n = lane + 32 * j;
          if (n < N) row[n] = acc[i][j];
        }
      }
    }

    // dC[t][n] = exp(s_t) g[t][n] + sum_u dCB[t][u] B[u][n],
    // g[t][n] = sum_p dy[t][p] h0[p][n];  ds_t += exp(s_t) sum_n C[t][n] g[t][n]
    {
      const int r0 = warp * kRowsL;
      float g[kRowsL][kColsN] = {};
      float a2[kRowsL][kColsN] = {};
      for (int p = 0; p < P; ++p) {
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = h0[p * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = dys[(r0 + i) * kLdP + p];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) g[i][j] = fmaf(xv, yv[j], g[i][j]);
        }
      }
      const int umax = r0 + kRowsL;  // dCB[t][u] = 0 for u > t
      for (int u = 0; u < umax; ++u) {
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = bs[u * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = s2[(r0 + i) * kLdL + u];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) a2[i][j] = fmaf(xv, yv[j], a2[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int t = r0 + i;
        const float es = expf(ss[t]);
        float cg = 0.f;
        float* row = dC_part + ((bh * T) + t0 + t) * N;
#pragma unroll
        for (int j = 0; j < kColsN; ++j) {
          const int n = lane + 32 * j;
          cg += cs[t * kLdN + n] * g[i][j];
          if (t < Lc && n < N) row[n] = es * g[i][j] + a2[i][j];
        }
        cg = warp_sum(cg);
        if (lane == 0) dsi[t] = es * cg;
      }
    }
    __syncthreads();  // every read of dh (the old one) is done

    // dh[p][n] := exp(total) dh[p][n] + sum_t exp(s_t) dy[t][p] C[t][n];
    // dtot_h = sum dh_old o h0
    float dtot_h = 0.f;
    {
      const int r0 = warp * kRowsP;
      float acc[kRowsP][kColsN] = {};
      for (int t = 0; t < Lc; ++t) {
        const float es = expf(ss[t]);
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = cs[t * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsP; ++i) {
          const float xv = es * dys[t * kLdP + r0 + i];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
      const float dec = expf(total);
#pragma unroll
      for (int i = 0; i < kRowsP; ++i)
#pragma unroll
        for (int j = 0; j < kColsN; ++j) {
          const int o = (r0 + i) * kLdN + lane + 32 * j;
          dtot_h += dh[o] * h0[o];
          dh[o] = dec * dh[o] + acc[i][j];
        }
    }
    dtot_h = block_sum(dtot_h, red);  // synchronises: dwv, dsi, rowe ready

    // the chunk's scalars, in order: ds_t, its reverse cumsum da_t, ddt_t.
    // total = s_{Lc-1}, so w_{Lc-1} = dt_{Lc-1} does not depend on s: its
    // +dw w (through total) and -dw w (through s_{Lc-1}) are both left out
    if (threadIdx.x == 0) {
      float dtot = expf(total) * dtot_h;
      for (int u = 0; u < Lc - 1; ++u) dtot += dwv[u] * ws[u];
      float acc = 0.f;
      for (int t = Lc - 1; t >= 0; --t) {
        float ds = rowe[t] - cole[t] + dsi[t];
        ds += t == Lc - 1 ? dtot : -dwv[t] * ws[t];
        acc += ds;  // da_t = sum_{tau >= t} ds_tau
        ddt[((size_t)b * T + t0 + t) * H + h] =
            ddtm[t] + dwv[t] * expf(total - ss[t]) + acc * Ah;
        dA_acc += acc * dts[t];
      }
    }
  }
  dD_acc = block_sum(dD_acc, red);
  if (threadIdx.x == 0) {
    dA_part[bh] = dA_acc;
    dD_part[bh] = dD_acc;
  }
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" int ssd_scan_chunk() { return kL; }
extern "C" int ssd_scan_max_p() { return kPMax; }
extern "C" int ssd_scan_max_n() { return kNMax; }

// Forward: x (Bt,T,H,P), dt (Bt,T,H), A, D (H), B, C (Bt,T,N) float32
// contiguous -> y (Bt,T,H,P), fin (Bt,H,P,N) and, when `states` is not
// null, the state entering each chunk (Bt,H,ceil(T/64),P,N). Returns the
// cudaError_t of the launch.
extern "C" int ssd_scan_fwd_f32(const float* x, const float* dt,
                                const float* A, const float* B,
                                const float* C, const float* D, float* y,
                                float* fin, float* states, int Bt, int T,
                                int H, int P, int N, void* stream) {
  if (Bt <= 0 || H <= 0 || T <= 0) return 0;
  static const int attr = set_smem((const void*)ssd_scan_fwd_kernel, kFwdSmem);
  if (attr) return attr;
  ssd_scan_fwd_kernel<<<dim3(H, Bt), kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      x, dt, A, B, C, D, y, fin, states, T, H, P, N);
  return (int)cudaGetLastError();
}

// Backward: the forward's inputs, its chunk states, dy (Bt,T,H,P) and dfin
// (Bt,H,P,N; null = zero) -> dx (Bt,T,H,P), ddt (Bt,T,H), and the partials
// dA_part, dD_part (Bt,H), dB_part, dC_part (Bt,H,T,N) that the caller sums.
extern "C" int ssd_scan_bwd_f32(const float* x, const float* dt,
                                const float* A, const float* B,
                                const float* C, const float* D,
                                const float* states, const float* dy,
                                const float* dfin, float* dx, float* ddt,
                                float* dA_part, float* dB_part,
                                float* dC_part, float* dD_part, int Bt,
                                int T, int H, int P, int N, void* stream) {
  if (Bt <= 0 || H <= 0 || T <= 0) return 0;
  static const int attr = set_smem((const void*)ssd_scan_bwd_kernel, kBwdSmem);
  if (attr) return attr;
  ssd_scan_bwd_kernel<<<dim3(H, Bt), kThreads, kBwdSmem, (cudaStream_t)stream>>>(
      x, dt, A, B, C, D, states, dy, dfin, dx, ddt, dA_part, dB_part, dC_part,
      dD_part, T, H, P, N);
  return (int)cudaGetLastError();
}
