// Causal / sliding-window attention for Hopper (sm_90a), forward and
// backward, with a plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (pallas_call at flash_attention.py:99, body
// _flash_kernel). For q (B, T, H, d), k and v (B, S, KV, d), query head h
// reads kv head h / G (G = H / KV, no copy of K or V), and
//
//   s[t][u] = (q_t . k_u) / sqrt(d)      where the mask holds, else -1e30
//   mask    = u < S & t < T  [& u <= t if causal]  [& u > t - window]
//   o_t     = sum_{u < S} softmax(s[t])_u v_u    (f32 sums, o in q's type)
//
// with the online softmax over key tiles: a running max m and sum l per
// row, the accumulator rescaled by exp(m_old - m_new) as each tile comes,
// and o = acc / max(l, 1e-30). As in the TPU kernel a masked score is
// -1e30: in a row with any key in its band it contributes exactly 0 (once
// a real score arrives, exp(-1e30 - m) = 0 wipes what masked keys added),
// and a row with none (window > 0 and t >= S + window - 1, so only when
// T > S) takes the mean of v over the S keys. The query tiles that hold
// such rows visit every key tile. The forward also writes each row's
// logsumexp m + log l, (B, H, T) f32, for the backward; for a row with no
// key it is -1e30 (log S is below f32's resolution there), so the dK/dV
// kernel gives such a row P = 1/S by its index, not from lse.
//
// Backward (the TPU kernel has none), FA2-style, deterministic (no
// atomics): D = rowsum(dO o O) by a small kernel; one block per (b, kv
// head, key tile) holds its K, V tile and accumulates dK and dV in
// registers over the band's query tiles and the G query heads of that kv
// head; one block per (b, h, query tile) accumulates dQ over the band's
// key tiles. Both recompute P = exp(s - lse) and dS = P o (dP - D).
//
// Design. The TPU kernel walks key blocks on a sequential grid axis with
// m, l and acc in VMEM scratch. Here one block of 256 threads owns a tile
// of 64 query rows and loops over the key tiles itself. A tile that lies
// wholly outside the causal or window band is never loaded: the loop runs
// only over the key tiles that the band reaches. Every tile lives in
// shared memory as f32, with an odd row stride (DMAX + 1, tile + 1) so a
// column read by consecutive lanes hits consecutive banks. Each warp owns
// whole rows of every product's output (its left operand is a broadcast)
// and the lanes consecutive columns; so the row max and row sum of the
// softmax are warp shuffles, and the P written for a P.V product is read
// back only by the warp that wrote it (a __syncwarp, not a block
// barrier). Head dims d <= 64, 128 and 256 each get their own tiles: the
// key tile is 64 rows, 32 at d > 128, so the f32 tiles fit the 227 KB a
// block may use (214 KB in the d = 256 dK/dV kernel). Inputs are f32 or
// bf16; every product accumulates in f32 with fmaf and IEEE expf (the
// file is never built with fast math).
//
// Bound on the H100 at the zamba2 path's shape (B 8, T = S = 512, H = KV
// = 32, d 112, causal), forward: 131,328 (t, u) pairs in the causal band
// per (b, h), each 2 d multiply-adds (q.k and p.v), are 15.06 GFLOP:
// 0.225 ms at the card's 67 TFLOP/s f32 without tensor cores; q, k, v
// and o are 235 MB, 0.070 ms at 3.35 TB/s. The backward recomputes s and
// adds dP, dV, dK and dQ: 37.6 GFLOP, 0.56 ms, against 0.14 ms of bytes.
// So it is bound by operations. This version feeds the FMA pipes from
// shared memory, with about one shared load per two multiply-adds in the
// q.k product, and does not use the tensor cores (TF32 would round q and
// k to 10 bits, and the path is f32 for parity): wgmma on bf16 tiles, TMA
// loads and register-tiled q.k products are the levers for a later
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 64;              // query rows per tile
constexpr int kRowsT = kBT / kWarps; // query rows per warp
constexpr int kColsT = kBT / 32;     // query columns per lane
constexpr float kNoKey = -INFINITY;  // the score of a column u >= S
constexpr float kMinus = -1e30f;  // a masked score; the max before a key

template <int DMAX>
struct Tiles {
  static constexpr int kBS = DMAX > 128 ? 32 : 64;  // keys per tile
  static constexpr int kLd = DMAX + 1;               // f32 row stride
  static constexpr int kLdS = kBS + 1;
  static constexpr int kLdT = kBT + 1;
  static constexpr int kRowsS = kBS / kWarps;  // key rows per warp
  static constexpr int kColsS = kBS / 32;      // key columns per lane
  static constexpr int kColsD = DMAX / 32;     // head-dim columns per lane
  // forward: q [BT][Ld], k, v [BS][Ld], p [BT][LdS]
  static constexpr size_t kFwdSmem =
      sizeof(float) * ((size_t)(kBT + 2 * kBS) * kLd + kBT * kLdS);
  // dK/dV: k, v [BS][Ld], q, dO [BT][Ld], p^T, dS^T [BS][LdT], lse, D [BT]
  static constexpr size_t kDkvSmem =
      sizeof(float) * ((size_t)(2 * kBS + 2 * kBT) * kLd + 2 * kBS * kLdT +
                       2 * kBT);
  // dQ: q, dO [BT][Ld], k, v [BS][Ld], dS [BT][LdS], lse, D [BT]
  static constexpr size_t kDqSmem =
      sizeof(float) * ((size_t)(2 * kBT + 2 * kBS) * kLd + kBT * kLdS +
                       2 * kBT);
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool in_band(int t, int u, int T, int S,
                                        int causal, int window) {
  return u < S && t < T && (!causal || u <= t) &&
         (window <= 0 || u > t - window);
}

// Stage `rows` rows of one head of a (B, L, heads, d) tensor as f32
// [rows][ld], zero beyond the sequence's `n` rows and beyond d columns.
template <typename T, int ROWS, int DMAX, int LD>
__device__ void load_tile(const T* __restrict__ src, float* dst, int b,
                          int r0, int n, int heads, int head, int d) {
  for (int i = threadIdx.x; i < ROWS * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    float val = 0.f;
    if (r0 + r < n && c < d)
      val = to_f(src[(((size_t)b * n + r0 + r) * heads + head) * d + c]);
    dst[r * LD + c] = val;
  }
}

// One row-vector per query row of the tile, (B, H, T) layout.
__device__ void load_rows(const float* __restrict__ src, float* dst,
                          size_t bh, int t0, int T) {
  if (threadIdx.x < kBT) {
    const int t = t0 + threadIdx.x;
    dst[threadIdx.x] = t < T ? src[bh * T + t] : 0.f;
  }
}

// The first query row with no key in its band: t >= S + window - 1 when
// window > 0 (u <= t never empties a row, u > t - window does once
// t - window + 1 > S - 1); none without a window.
__device__ __forceinline__ int first_keyless_row(int S, int window) {
  return window > 0 ? S + window - 1 : 0x7fffffff;
}

// The key range [lo, hi) that the band of query rows [t0, t0 + BT) reaches;
// all S keys when a row of the tile has none in its band.
__device__ __forceinline__ void key_range(int t0, int S, int causal,
                                          int window, int* lo, int* hi) {
  if (t0 + kBT - 1 >= first_keyless_row(S, window)) {
    *lo = 0;
    *hi = S;
    return;
  }
  *lo = window > 0 ? max(0, t0 - window + 1) : 0;
  *hi = causal ? min(S, t0 + kBT) : S;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DMAX, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int Tq, int S, int H,
                           int KV, int d, int causal, int window,
                           float scale) {
  using C = Tiles<DMAX>;
  constexpr int BS = C::kBS, LD = C::kLd, LDS = C::kLdS;
  extern __shared__ float sm[];
  float* qs = sm;              // [BT][LD]
  float* ks = qs + kBT * LD;   // [BS][LD]
  float* vs = ks + BS * LD;    // [BS][LD]
  float* ps = vs + BS * LD;    // [BT][LDS]

  const int t0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * kRowsT;

  load_tile<T, kBT, DMAX, LD>(q, qs, b, t0, Tq, H, h, d);

  float m[kRowsT], l[kRowsT], acc[kRowsT][C::kColsD];
#pragma unroll
  for (int r = 0; r < kRowsT; ++r) {
    m[r] = kMinus;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < C::kColsD; ++j) acc[r][j] = 0.f;
  }

  int lo, hi;
  key_range(t0, S, causal, window, &lo, &hi);
  for (int s0 = (lo / BS) * BS; s0 < hi; s0 += BS) {
    __syncthreads();  // every warp is done with the previous k, v tile
    load_tile<T, BS, DMAX, LD>(k, ks, b, s0, S, KV, kvh, d);
    load_tile<T, BS, DMAX, LD>(v, vs, b, s0, S, KV, kvh, d);
    __syncthreads();

    // s[t][u] = q_t . k_u for the warp's rows t and the lane's columns u
    float sc[kRowsT][C::kColsS] = {};
    for (int i = 0; i < d; ++i) {
      float kv_[C::kColsS];
#pragma unroll
      for (int j = 0; j < C::kColsS; ++j) kv_[j] = ks[(lane + 32 * j) * LD + i];
#pragma unroll
      for (int r = 0; r < kRowsT; ++r) {
        const float qv = qs[(r0 + r) * LD + i];
#pragma unroll
        for (int j = 0; j < C::kColsS; ++j) sc[r][j] = fmaf(qv, kv_[j], sc[r][j]);
      }
    }

    // online softmax over this tile, one row per step, across the warp
#pragma unroll
    for (int r = 0; r < kRowsT; ++r) {
      const int t = t0 + r0 + r;
      float mx = kMinus;
#pragma unroll
      for (int j = 0; j < C::kColsS; ++j) {
        const int u = s0 + lane + 32 * j;
        sc[r][j] = in_band(t, u, Tq, S, causal, window) ? sc[r][j] * scale
                   : u < S                              ? kMinus
                                                        : kNoKey;
        mx = fmaxf(mx, sc[r][j]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::kColsS; ++j) {
        const float p = expf(sc[r][j] - m_new);  // 0 for u >= S
        ps[(r0 + r) * LDS + lane + 32 * j] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < C::kColsD; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();

    // acc[t][c] += sum_u p[t][u] v[u][c]
    const int un = min(BS, S - s0);
    for (int u = 0; u < un; ++u) {
      float vv[C::kColsD];
#pragma unroll
      for (int j = 0; j < C::kColsD; ++j) vv[j] = vs[u * LD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRowsT; ++r) {
        const float pv = ps[(r0 + r) * LDS + u];
#pragma unroll
        for (int j = 0; j < C::kColsD; ++j) acc[r][j] = fmaf(pv, vv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsT; ++r) {
    const int t = t0 + r0 + r;
    if (t >= Tq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + (((size_t)b * Tq + t) * H + h) * d;
#pragma unroll
    for (int j = 0; j < C::kColsD; ++j) {
      const int c = lane + 32 * j;
      if (c < d) orow[c] = from_f<T>(acc[r][j] / den);
    }
    if (lane == 0) lse[((size_t)b * H + h) * Tq + t] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D[b][h][t] = sum_c dO[b][t][h][c] O[b][t][h][c]: one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dot_kernel(const T* __restrict__ o,
                               const T* __restrict__ dout,
                               float* __restrict__ Dv, int rows, int Tq,
                               int H, int d) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = o + (size_t)row * d;
  const T* g = dout + (size_t)row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(a[c]), to_f(g[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, bt = row / H;  // row = (b * T + t) * H + h
    const int t = bt % Tq, b = bt / Tq;
    Dv[((size_t)b * H + h) * Tq + t] = acc;
  }
}

// dK, dV for one key tile of one kv head: rows are keys, the loop runs
// over the G query heads and the query tiles the band reaches.
template <int DMAX, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ Dv,
                               T* __restrict__ dk, T* __restrict__ dv,
                               int Tq, int S, int H, int KV, int d,
                               int causal, int window, float scale) {
  using C = Tiles<DMAX>;
  constexpr int BS = C::kBS, LD = C::kLd, LDT = C::kLdT;
  constexpr int RS = C::kRowsS;
  extern __shared__ float sm[];
  float* ks = sm;                // [BS][LD]
  float* vs = ks + BS * LD;      // [BS][LD]
  float* qs = vs + BS * LD;      // [BT][LD]
  float* dos = qs + kBT * LD;    // [BT][LD]
  float* pt = dos + kBT * LD;    // [BS][LDT]  p^T
  float* dst = pt + BS * LDT;    // [BS][LDT]  dS^T
  float* ls = dst + BS * LDT;    // [BT]
  float* ds_ = ls + kBT;         // [BT]       D

  const int s0 = blockIdx.x * BS, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * RS;

  load_tile<T, BS, DMAX, LD>(k, ks, b, s0, S, KV, kvh, d);
  load_tile<T, BS, DMAX, LD>(v, vs, b, s0, S, KV, kvh, d);

  float dka[RS][C::kColsD] = {}, dva[RS][C::kColsD] = {};
  // the query rows whose band reaches keys [s0, s0 + BS), and those with
  // no key in their band, whose P is 1/S on every key (and dS = 0: the
  // mask holds their scores constant)
  const int keyless = first_keyless_row(S, window);
  const float inv_s = 1.0f / (float)S;
  const int qlo = causal ? s0 : 0;
  const int qhi = keyless < Tq ? Tq
                  : window > 0 ? min(Tq, s0 + BS - 1 + window)
                               : Tq;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t bh = (size_t)b * H + h;
    for (int t0 = (qlo / kBT) * kBT; t0 < qhi; t0 += kBT) {
      __syncthreads();  // every warp is done with the previous q, dO tile
      load_tile<T, kBT, DMAX, LD>(q, qs, b, t0, Tq, H, h, d);
      load_tile<T, kBT, DMAX, LD>(dout, dos, b, t0, Tq, H, h, d);
      load_rows(lse, ls, bh, t0, Tq);
      load_rows(Dv, ds_, bh, t0, Tq);
      __syncthreads();

      // s^T[u][t] = k_u . q_t and dP^T[u][t] = v_u . dO_t
      float st[RS][kColsT] = {}, dpt[RS][kColsT] = {};
      for (int i = 0; i < d; ++i) {
        float qv[kColsT], gv[kColsT];
#pragma unroll
        for (int j = 0; j < kColsT; ++j) {
          qv[j] = qs[(lane + 32 * j) * LD + i];
          gv[j] = dos[(lane + 32 * j) * LD + i];
        }
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          const float kk = ks[(r0 + r) * LD + i];
          const float vk = vs[(r0 + r) * LD + i];
#pragma unroll
          for (int j = 0; j < kColsT; ++j) {
            st[r][j] = fmaf(qv[j], kk, st[r][j]);
            dpt[r][j] = fmaf(gv[j], vk, dpt[r][j]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const int u = s0 + r0 + r;
#pragma unroll
        for (int j = 0; j < kColsT; ++j) {
          const int tl = lane + 32 * j, t = t0 + tl;
          const bool band = in_band(t, u, Tq, S, causal, window);
          const float p = band ? expf(st[r][j] * scale - ls[tl])
                          : (t >= keyless && t < Tq && u < S) ? inv_s
                                                              : 0.f;
          pt[(r0 + r) * LDT + tl] = p;
          dst[(r0 + r) * LDT + tl] = band ? p * (dpt[r][j] - ds_[tl]) : 0.f;
        }
      }
      __syncwarp();

      // dV[u][c] += sum_t p^T[u][t] dO[t][c]; dK[u][c] += sum_t dS^T[u][t] q[t][c]
      const int tn = min(kBT, Tq - t0);
      for (int t = 0; t < tn; ++t) {
        float gv[C::kColsD], qv[C::kColsD];
#pragma unroll
        for (int j = 0; j < C::kColsD; ++j) {
          gv[j] = dos[t * LD + lane + 32 * j];
          qv[j] = qs[t * LD + lane + 32 * j];
        }
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          const float pv = pt[(r0 + r) * LDT + t];
          const float sv = dst[(r0 + r) * LDT + t];
#pragma unroll
          for (int j = 0; j < C::kColsD; ++j) {
            dva[r][j] = fmaf(pv, gv[j], dva[r][j]);
            dka[r][j] = fmaf(sv, qv[j], dka[r][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int u = s0 + r0 + r;
    if (u >= S) continue;
    const size_t row = (((size_t)b * S + u) * KV + kvh) * d;
#pragma unroll
    for (int j = 0; j < C::kColsD; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        dk[row + c] = from_f<T>(dka[r][j] * scale);
        dv[row + c] = from_f<T>(dva[r][j]);
      }
    }
  }
}

// dQ for one query tile of one head, over the key tiles the band reaches.
template <int DMAX, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ Dv,
                              T* __restrict__ dq, int Tq, int S, int H,
                              int KV, int d, int causal, int window,
                              float scale) {
  using C = Tiles<DMAX>;
  constexpr int BS = C::kBS, LD = C::kLd, LDS = C::kLdS;
  extern __shared__ float sm[];
  float* qs = sm;                // [BT][LD]
  float* dos = qs + kBT * LD;    // [BT][LD]
  float* ks = dos + kBT * LD;    // [BS][LD]
  float* vs = ks + BS * LD;      // [BS][LD]
  float* dss = vs + BS * LD;     // [BT][LDS]
  float* ls = dss + kBT * LDS;   // [BT]
  float* ds_ = ls + kBT;         // [BT]

  const int t0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t bh = (size_t)b * H + h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * kRowsT;

  load_tile<T, kBT, DMAX, LD>(q, qs, b, t0, Tq, H, h, d);
  load_tile<T, kBT, DMAX, LD>(dout, dos, b, t0, Tq, H, h, d);
  load_rows(lse, ls, bh, t0, Tq);
  load_rows(Dv, ds_, bh, t0, Tq);

  float dqa[kRowsT][C::kColsD] = {};
  int lo, hi;
  key_range(t0, S, causal, window, &lo, &hi);
  for (int s0 = (lo / BS) * BS; s0 < hi; s0 += BS) {
    __syncthreads();
    load_tile<T, BS, DMAX, LD>(k, ks, b, s0, S, KV, kvh, d);
    load_tile<T, BS, DMAX, LD>(v, vs, b, s0, S, KV, kvh, d);
    __syncthreads();

    // s[t][u] = q_t . k_u and dP[t][u] = dO_t . v_u
    float sc[kRowsT][C::kColsS] = {}, dp[kRowsT][C::kColsS] = {};
    for (int i = 0; i < d; ++i) {
      float kk[C::kColsS], vk[C::kColsS];
#pragma unroll
      for (int j = 0; j < C::kColsS; ++j) {
        kk[j] = ks[(lane + 32 * j) * LD + i];
        vk[j] = vs[(lane + 32 * j) * LD + i];
      }
#pragma unroll
      for (int r = 0; r < kRowsT; ++r) {
        const float qv = qs[(r0 + r) * LD + i];
        const float gv = dos[(r0 + r) * LD + i];
#pragma unroll
        for (int j = 0; j < C::kColsS; ++j) {
          sc[r][j] = fmaf(qv, kk[j], sc[r][j]);
          dp[r][j] = fmaf(gv, vk[j], dp[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsT; ++r) {
      const int tl = r0 + r;
#pragma unroll
      for (int j = 0; j < C::kColsS; ++j) {
        const int u = s0 + lane + 32 * j;
        const float p = in_band(t0 + tl, u, Tq, S, causal, window)
                            ? expf(sc[r][j] * scale - ls[tl])
                            : 0.f;
        dss[tl * LDS + lane + 32 * j] = p * (dp[r][j] - ds_[tl]);
      }
    }
    __syncwarp();

    // dQ[t][c] += sum_u dS[t][u] k[u][c]
    const int un = min(BS, S - s0);
    for (int u = 0; u < un; ++u) {
      float kk[C::kColsD];
#pragma unroll
      for (int j = 0; j < C::kColsD; ++j) kk[j] = ks[u * LD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRowsT; ++r) {
        const float sv = dss[(r0 + r) * LDS + u];
#pragma unroll
        for (int j = 0; j < C::kColsD; ++j) dqa[r][j] = fmaf(sv, kk[j], dqa[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsT; ++r) {
    const int t = t0 + r0 + r;
    if (t >= Tq) continue;
    T* row = dq + (((size_t)b * Tq + t) * H + h) * d;
#pragma unroll
    for (int j = 0; j < C::kColsD; ++j) {
      const int c = lane + 32 * j;
      if (c < d) row[c] = from_f<T>(dqa[r][j] * scale);
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DMAX, typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Tq, int S, int H, int KV, int d,
               int causal, int window, cudaStream_t stream) {
  using C = Tiles<DMAX>;
  static const int attr = set_smem(
      (const void*)flash_attention_fwd_kernel<DMAX, T>, C::kFwdSmem);
  if (attr) return attr;
  const dim3 grid((Tq + kBT - 1) / kBT, H, B);
  flash_attention_fwd_kernel<DMAX, T><<<grid, kThreads, C::kFwdSmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Tq, S, H, KV, d,
      causal, window, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <int DMAX, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, float* Dv, void* dq,
               void* dk, void* dv, int B, int Tq, int S, int H, int KV, int d,
               int causal, int window, cudaStream_t stream) {
  using C = Tiles<DMAX>;
  static const int attr_kv = set_smem(
      (const void*)flash_attention_bwd_dkv_kernel<DMAX, T>, C::kDkvSmem);
  static const int attr_q = set_smem(
      (const void*)flash_attention_bwd_dq_kernel<DMAX, T>, C::kDqSmem);
  if (attr_kv) return attr_kv;
  if (attr_q) return attr_q;
  const float scale = 1.0f / sqrtf((float)d);
  const int rows = B * Tq * H;
  flash_attention_bwd_dot_kernel<T>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          (const T*)o, (const T*)dout, Dv, rows, Tq, H, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  flash_attention_bwd_dkv_kernel<DMAX, T>
      <<<dim3((S + C::kBS - 1) / C::kBS, KV, B), kThreads, C::kDkvSmem,
         stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                   lse, Dv, (T*)dk, (T*)dv, Tq, S, H, KV, d, causal, window,
                   scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_attention_bwd_dq_kernel<DMAX, T>
      <<<dim3((Tq + kBT - 1) / kBT, H, B), kThreads, C::kDqSmem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, Dv,
          (T*)dq, Tq, S, H, KV, d, causal, window, scale);
  return (int)cudaGetLastError();
}

// cudaErrorInvalidValue for a head dim or type the kernels do not take
constexpr int kBadArgs = (int)cudaErrorInvalidValue;

}  // namespace

extern "C" int flash_attention_max_d() { return 256; }

// Forward: q (B,T,H,d), k, v (B,S,KV,d), contiguous, dtype 0 = f32,
// 1 = bf16 -> o (B,T,H,d) in q's type and lse (B,H,T) f32. Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int Tq, int S, int H, int KV, int d,
                                   int causal, int window, void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || d <= 0 || d > 256 || S <= 0) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_FWD(DM, TY) \
  launch_fwd<DM, TY>(q, k, v, o, lse, B, Tq, S, H, KV, d, causal, window, st)
  if (dtype == 0)
    return d <= 64 ? FA_FWD(64, float) : d <= 128 ? FA_FWD(128, float)
                                                  : FA_FWD(256, float);
  if (dtype == 1)
    return d <= 64    ? FA_FWD(64, __nv_bfloat16)
           : d <= 128 ? FA_FWD(128, __nv_bfloat16)
                      : FA_FWD(256, __nv_bfloat16);
#undef FA_FWD
  return kBadArgs;
}

// Backward: the forward's inputs, its o and lse, and dO (B,T,H,d) -> dq,
// dk, dv in the inputs' type; `Dv` is (B,H,T) f32 scratch. Three launches:
// D = rowsum(dO o O), then dK/dV, then dQ.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dout,
                                   float* Dv, void* dq, void* dk, void* dv,
                                   int B, int Tq, int S, int H, int KV, int d,
                                   int causal, int window, void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || d <= 0 || d > 256 || S <= 0) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_BWD(DM, TY)                                                       \
  launch_bwd<DM, TY>(q, k, v, o, lse, dout, Dv, dq, dk, dv, B, Tq, S, H, KV, \
                     d, causal, window, st)
  if (dtype == 0)
    return d <= 64 ? FA_BWD(64, float) : d <= 128 ? FA_BWD(128, float)
                                                  : FA_BWD(256, float);
  if (dtype == 1)
    return d <= 64    ? FA_BWD(64, __nv_bfloat16)
           : d <= 128 ? FA_BWD(128, __nv_bfloat16)
                      : FA_BWD(256, __nv_bfloat16);
#undef FA_BWD
  return kBadArgs;
}
