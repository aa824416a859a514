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
// key it is -1e30 (log S is below f32's resolution there), so the backward
// gives such a row P = 1/S by its index, not from lse.
//
// Forward design. The TPU kernel walks key blocks on a sequential grid
// axis with m, l and acc in VMEM scratch. Here one block of 256 threads
// owns a tile of 64 query rows and loops over the key tiles itself. A tile
// that lies wholly outside the causal or window band is never loaded: the
// loop runs only over the key tiles that the band reaches. Every tile
// lives in shared memory as f32, with an odd row stride (DMAX + 1, tile +
// 1) so a column read by consecutive lanes hits consecutive banks. Each
// warp owns whole rows of every product's output (its left operand is a
// broadcast) and the lanes consecutive columns; so the row max and row sum
// of the softmax are warp shuffles, and the P written for a P.V product is
// read back only by the warp that wrote it (a __syncwarp, not a block
// barrier). Head dims d <= 64, 128 and 256 each get their own tiles: the
// key tile is 64 rows, 32 at d > 128, so the f32 tiles fit the 227 KB a
// block may use. Inputs are f32 or bf16; the forward accumulates in f32
// with fmaf, and both directions use IEEE expf (the file is never built
// with fast math).
//
// Backward (the TPU kernel has none), FA2-style, two launches: D =
// rowsum(dO o O) by a small kernel, then one fused kernel. A block per (b,
// kv head, key tile) holds its K and V tiles and loops over the G query
// heads of that kv head and the query tiles the band reaches. For each
// query tile it computes s^T = K.Q^T and dP^T = V.dO^T once, then P =
// exp(s - lse) and dS = P o (dP - D), and three more products: dV +=
// P^T.dO and dK += dS^T.Q in registers, and dQ = dS.K, which it adds into
// an f32 buffer dq_acc (B, T, H, d) with 16-byte red.global.add.v4.f32
// (scalar atomics when d % 4 != 0). That is 5 products of length d a
// (t, u) pair, the function's own count. dK and dV are deterministic; dQ
// is not: the key tiles' atomic adds land in whatever order the blocks
// run, so dQ may differ in its last bits from run to run (as
// scaled_dot_product_attention's own backward may).
//
// The products run on the tensor cores by 3xTF32 (CUTLASS's
// OpMultiplyAddFastF32): each f32 operand x is split as big + small, big
// rounded to TF32 and small = x - big read as TF32, and a.b = big_a.big_b +
// big_a.small_b + small_a.big_b, three mma.sync m16n8k8 into one f32
// accumulator. big carries x's top 11 significant bits and small the next
// 11, so each product keeps about 21 bits (small_a.small_b, dropped, is
// below 2^-21 of it), where one TF32 pass would keep 11: the sums stay
// near f32 accuracy. The tiles stay in shared memory as f32 with a row stride
// of DMAX + 4 (and 64 + 4 for P^T and dS^T), 4 mod 32: the A and B
// fragments that read along a row (lane -> row lane / 4, column lane % 4
// and + 4) hit 32 distinct banks; the transposed operands (Q, dO and K as
// the right operand of dK, dV and dQ, dS as the left of dQ) are read by
// index from those tiles, not copied, with at most 2-way conflicts (an
// order of columns that avoids them compiled to a slower kernel). The loops
// over the head dim and over the tiles are unrolled in full. Rows
// are staged with 16-byte loads where d % 4 == 0 (every width the paths
// use), a scalar loop otherwise; bf16 is widened to f32 as it is staged.
// Shared memory a block: 104,960 B at DMAX 64, 170,496 B at 128 and
// 217,600 B at 256 (32-key tiles), so one block an SM; a next
// q/dO tile double-buffered beside them would need 238,080 B at DMAX 128,
// more than the 232,448 a block may use, so the loads are not overlapped
// with the products. The block has 16 warps, 4 to a scheduler, so one
// warp's load -> split -> MMA chain waits while others issue; with 8
// warps and twice the registers each it is slower
// (scripts/flash_bwd_ablation.py). So a thread may hold 128 registers
// (nvcc -Xptxas -v, sm_90a, CUDA 12.8): it takes 119 at DMAX 64, 123 at
// 128 and 118 at 256, f32 and bf16 alike, with no spills.
//
// Bounds on the H100 at the zamba2 path's shape (B 8, T = S = 512, H = KV
// = 32, d 112, causal): 131,328 (t, u) pairs in the causal band per (b,
// h). Forward, 2 d multiply-adds a pair (q.k and p.v): 15.06 GFLOP, 0.225
// ms at the card's 67 TFLOP/s f32 without tensor cores; q, k, v and o are
// 235 MB, 0.070 ms at 3.35 TB/s. Backward, 5 d multiply-adds a pair:
// 37.65 GFLOP, 0.562 ms at 67 TFLOP/s, against 0.14 ms of bytes, so it is
// bound by operations; on the tensor cores the 3xTF32 route does three
// TF32 products for each, 3 x 37.65 GFLOP at 495 TFLOP/s: 0.228 ms. But
// mma.sync reaches about 310 TFLOP/s of TF32 on this card
// (scripts/flash_bwd_ablation.py), and the kernel computes the causal
// diagonal's tiles whole (42.3 GFLOP a product set), so its own floor is
// 3 x 42.3 GFLOP at 310 TFLOP/s, 0.41 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBwdWarps = 16;  // the fused backward's warps a block
constexpr int kBT = 64;              // query rows per tile
constexpr int kRowsT = kBT / kWarps; // query rows per warp
constexpr float kNoKey = -INFINITY;  // the score of a column u >= S
constexpr float kMinus = -1e30f;  // a masked score; the max before a key

template <int DMAX>
struct Tiles {
  static constexpr int kBS = DMAX > 128 ? 32 : 64;  // keys per tile
  static constexpr int kLd = DMAX + 1;               // forward f32 row stride
  static constexpr int kLdS = kBS + 1;
  static constexpr int kColsS = kBS / 32;      // key columns per lane
  static constexpr int kColsD = DMAX / 32;     // head-dim columns per lane
  // forward: q [BT][Ld], k, v [BS][Ld], p [BT][LdS]
  static constexpr size_t kFwdSmem =
      sizeof(float) * ((size_t)(kBT + 2 * kBS) * kLd + kBT * kLdS);
  // backward strides, 4 mod 32: an mma fragment's 32 lanes (rows lane / 4,
  // columns lane % 4) read 32 distinct banks
  static constexpr int kLdB = DMAX + 4;
  static constexpr int kLdTB = kBT + 4;
  // backward: k, v [BS][LdB], q, dO [BT][LdB], P^T, dS^T [BS][LdTB], lse, D
  static constexpr size_t kBwdSmem =
      sizeof(float) * ((size_t)(2 * kBS + 2 * kBT) * kLdB + 2 * kBS * kLdTB +
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

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  const auto* two = reinterpret_cast<const __nv_bfloat162*>(&w);
  const float2 lo = __bfloat1622float2(two[0]), hi = __bfloat1622float2(two[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Stage `rows` rows of one head of a (B, L, heads, d) tensor as f32
// [rows][ld], zero beyond the sequence's `n` rows and beyond d columns; four
// columns a thread (16 bytes of f32) where ld and d allow it.
template <typename T, int ROWS, int DMAX, int LD, int THREADS = kThreads>
__device__ void load_tile(const T* __restrict__ src, float* dst, int b,
                          int r0, int n, int heads, int head, int d) {
  if constexpr (LD % 4 == 0) {
    const bool aligned =
        reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
    if (d % 4 == 0 && aligned) {
      constexpr int Q4 = DMAX / 4;
      for (int i = threadIdx.x; i < ROWS * Q4; i += THREADS) {
        const int r = i / Q4, c = 4 * (i % Q4);
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < n && c < d)
          val = load4(src + (((size_t)b * n + r0 + r) * heads + head) * d + c);
        *reinterpret_cast<float4*>(dst + r * LD + c) = val;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < ROWS * DMAX; i += THREADS) {
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

// ---- the backward's products: mma.sync m16n8k8 on TF32, three a product
//
// Fragments of D[16][8] += A[16][8] . B[8][8] (PTX ISA, mma.m16n8k8 .tf32),
// with g = lane / 4 and i = lane % 4: a0 (g, i), a1 (g + 8, i), a2 (g, i + 4),
// a3 (g + 8, i + 4); b0 (k i, n g), b1 (k i + 4, n g); c0, c1 (g, 2i and
// 2i + 1), c2, c3 (g + 8, the same columns).

// x = big + small: big is x rounded to TF32's 10-bit mantissa (add half of
// its last place, clear the 13 bits below), small = x - big exactly, passed
// as f32 bits, of which the tensor core reads the top 19 (TF32). big carries
// x's top 11 significant bits and small the next 11, so what the core sees
// is x to about 2^-21. That is two integer and one f32 instruction a value:
// every fragment is split where it is loaded, so the splits are a large
// share of the kernel's instructions, and cvt.rna.tf32.f32 for both parts
// costs more.
template <int N>
struct Split {
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    f.big[j] = (__float_as_uint(x[j]) + 0x1000u) & 0xffffe000u;
    f.small[j] = __float_as_uint(x[j] - __uint_as_float(f.big[j]));
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in f32 by 3xTF32: a.b = big.big + big.small + small.big, the
// dropped small.small below 2^-22 of it; the small terms go in first.
__device__ __forceinline__ void mma3(float (&c)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// A fragment of rows m0.. of a row-major tile x[m][k], columns k0..
template <int LD>
__device__ __forceinline__ Split<4> frag_a(const float* x, int m0, int k0,
                                           int lane) {
  const float* p = x + (m0 + (lane >> 2)) * LD + k0 + (lane & 3);
  const float v[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
  return split(v);
}

// A fragment of A = x^T: A[m][k] = x[k][m]
template <int LD>
__device__ __forceinline__ Split<4> frag_at(const float* x, int m0, int k0,
                                            int lane) {
  const float* p = x + (k0 + (lane & 3)) * LD + m0 + (lane >> 2);
  const float v[4] = {p[0], p[8], p[4 * LD], p[4 * LD + 8]};
  return split(v);
}

// B fragment of B = x^T for a row-major x[n][k]: B[k][n] = x[n][k]
template <int LD>
__device__ __forceinline__ Split<2> frag_bt(const float* x, int n0, int k0,
                                            int lane) {
  const float* p = x + (n0 + (lane >> 2)) * LD + k0 + (lane & 3);
  const float v[2] = {p[0], p[4]};
  return split(v);
}

// B fragment of a row-major x[k][n]
template <int LD>
__device__ __forceinline__ Split<2> frag_b(const float* x, int n0, int k0,
                                           int lane) {
  const float* p = x + (k0 + (lane & 3)) * LD + n0 + (lane >> 2);
  const float v[2] = {p[0], p[4 * LD]};
  return split(v);
}

// dq_acc[row][c .. c + 3] += v, one 16-byte reduction
__device__ __forceinline__ void red_add4(float* p, float a, float b, float c,
                                         float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// dK, dV and dQ for one key tile of one kv head: rows are keys, the loop
// runs over the G query heads and the query tiles the band reaches. For each
// query tile, s^T = K.Q^T and dP^T = V.dO^T once; then P, dS; dV += P^T.dO
// and dK += dS^T.Q in registers; and dQ = dS.K added into dq_acc with f32
// atomics. Warp layouts (kBwdWarps = 16): s^T, dP^T and dK, dV as BS / 16
// warps of 16 key rows by 16 / (BS / 16) parts of the columns; dQ as 4
// warps of 16 query rows by 4 parts of the head dim.
template <int DMAX, typename T>
__global__ void __launch_bounds__(32 * kBwdWarps, 1)
flash_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ Dv,
                           float* __restrict__ dq_acc, T* __restrict__ dk,
                           T* __restrict__ dv, int Tq, int S, int H, int KV,
                           int d, int causal, int window, float scale) {
  using C = Tiles<DMAX>;
  constexpr int BS = C::kBS, LD = C::kLdB, LDT = C::kLdTB;
  constexpr int WM = BS / 16, WN = kBwdWarps / WM;  // s^T, dK, dV warps
  constexpr int WQ = kBwdWarps / 4;  // dQ: 4 warps of 16 rows by WQ parts
  constexpr int NT_S = kBT / WN / 8;             // s^T n-tiles a warp
  constexpr int NT_D = DMAX / WN / 8;            // dK, dV n-tiles a warp
  constexpr int NT_Q = DMAX / WQ / 8;            // dQ n-tiles a warp
  extern __shared__ float sm[];
  float* ks = sm;                // [BS][LD]
  float* vs = ks + BS * LD;      // [BS][LD]
  float* qs = vs + BS * LD;      // [BT][LD]
  float* dos = qs + kBT * LD;    // [BT][LD]
  float* pt = dos + kBT * LD;    // [BS][LDT]  P^T
  float* dst = pt + BS * LDT;    // [BS][LDT]  dS^T
  float* ls = dst + BS * LDT;    // [BT]
  float* ds_ = ls + kBT;         // [BT]       D

  const int s0 = blockIdx.x * BS, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, gc = 2 * (lane & 3);  // accumulator row, column
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = 16 * wm;                   // key rows of s^T, dK, dV
  const int n0s = wn * NT_S * 8;            // query columns of s^T
  const int nt = (d + 7) / 8;               // head-dim n-tiles in all
  const int nt_d = (nt + WN - 1) / WN, nt_q = (nt + WQ - 1) / WQ;
  const int n0d = wn * nt_d * 8;            // head-dim columns of dK, dV
  const int mq = 16 * (warp & 3);           // query rows of dQ
  const int n0q = (warp >> 2) * nt_q * 8;   // head-dim columns of dQ

  constexpr int NTH = 32 * kBwdWarps;
  load_tile<T, BS, DMAX, LD, NTH>(k, ks, b, s0, S, KV, kvh, d);
  load_tile<T, BS, DMAX, LD, NTH>(v, vs, b, s0, S, KV, kvh, d);

  float dka[NT_D][4] = {}, dva[NT_D][4] = {};
  // the query rows whose band reaches keys [s0, s0 + BS), and those with
  // no key in their band, whose P is 1/S on every key (and dS = 0: the
  // mask holds their scores constant)
  const int keyless = first_keyless_row(S, window);
  const float inv_s = 1.0f / (float)S;
  const int qlo = causal ? s0 : 0;
  const int qhi = keyless < Tq ? Tq
                  : window > 0 ? min(Tq, s0 + BS - 1 + window)
                               : Tq;
  const int un = min(BS, S - s0);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t bh = (size_t)b * H + h;
    for (int t0 = (qlo / kBT) * kBT; t0 < qhi; t0 += kBT) {
      __syncthreads();  // every warp is done with the previous tiles
      load_tile<T, kBT, DMAX, LD, NTH>(q, qs, b, t0, Tq, H, h, d);
      load_tile<T, kBT, DMAX, LD, NTH>(dout, dos, b, t0, Tq, H, h, d);
      load_rows(lse, ls, bh, t0, Tq);
      load_rows(Dv, ds_, bh, t0, Tq);
      __syncthreads();

      // s^T[u][t] = k_u . q_t and dP^T[u][t] = v_u . dO_t
      float st[NT_S][4] = {}, dpt[NT_S][4] = {};
#pragma unroll
      for (int i0 = 0; i0 < DMAX; i0 += 8) {
        if (i0 >= d) break;
        const Split<4> ak = frag_a<LD>(ks, m0, i0, lane);
        const Split<4> av = frag_a<LD>(vs, m0, i0, lane);
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
          mma3(st[j], ak, frag_bt<LD>(qs, n0s + 8 * j, i0, lane));
          mma3(dpt[j], av, frag_bt<LD>(dos, n0s + 8 * j, i0, lane));
        }
      }
      // P = exp(s scale - lse) in the band, 1/S on a row with no key;
      // dS = P (dP - D) in the band
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ul = m0 + gr + 8 * (e >> 1), u = s0 + ul;
          const int tl = n0s + 8 * j + gc + (e & 1), t = t0 + tl;
          const bool band = in_band(t, u, Tq, S, causal, window);
          const float p = band ? expf(st[j][e] * scale - ls[tl])
                          : (t >= keyless && t < Tq && u < S) ? inv_s
                                                              : 0.f;
          pt[ul * LDT + tl] = p;
          dst[ul * LDT + tl] = band ? p * (dpt[j][e] - ds_[tl]) : 0.f;
        }
      }
      __syncthreads();  // P^T and dS^T are whole

      // dV[u][c] += sum_t P^T[u][t] dO[t][c];
      // dK[u][c] += sum_t dS^T[u][t] q[t][c]
      const int tn = min(kBT, Tq - t0);
#pragma unroll
      for (int k0 = 0; k0 < kBT; k0 += 8) {
        if (k0 >= tn) break;
        const Split<4> ap = frag_a<LDT>(pt, m0, k0, lane);
        const Split<4> as = frag_a<LDT>(dst, m0, k0, lane);
#pragma unroll
        for (int j = 0; j < NT_D; ++j) {
          if (j < nt_d) {
            mma3(dva[j], ap, frag_b<LD>(dos, n0d + 8 * j, k0, lane));
            mma3(dka[j], as, frag_b<LD>(qs, n0d + 8 * j, k0, lane));
          }
        }
      }

      // dQ[t][c] += scale sum_u dS^T[u][t] k[u][c], into dq_acc
      float dqa[NT_Q][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < BS; k0 += 8) {
        if (k0 >= un) break;
        const Split<4> as = frag_at<LDT>(dst, mq, k0, lane);
#pragma unroll
        for (int j = 0; j < NT_Q; ++j)
          if (j < nt_q) mma3(dqa[j], as, frag_b<LD>(ks, n0q + 8 * j, k0, lane));
      }
      // lanes 2i and 2i + 1 trade halves: the even one adds row gr, columns
      // gc .. gc + 3, the odd one row gr + 8, columns gc - 2 .. gc + 1
      const bool odd = lane & 1;
      const int t = t0 + mq + gr + (odd ? 8 : 0);
      float* row = dq_acc + (((size_t)b * Tq + t) * H + h) * d;
#pragma unroll
      for (int j = 0; j < NT_Q; ++j) {
        const float x0 =
            __shfl_xor_sync(0xffffffffu, odd ? dqa[j][0] : dqa[j][2], 1);
        const float x1 =
            __shfl_xor_sync(0xffffffffu, odd ? dqa[j][1] : dqa[j][3], 1);
        const float w[4] = {odd ? x0 : dqa[j][0], odd ? x1 : dqa[j][1],
                            odd ? dqa[j][2] : x0, odd ? dqa[j][3] : x1};
        const int c = n0q + 8 * j + (gc & ~3);
        if (j >= nt_q || t >= Tq) continue;
        if ((d & 3) == 0) {
          if (c < d)
            red_add4(row + c, w[0] * scale, w[1] * scale, w[2] * scale,
                     w[3] * scale);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < d) atomicAdd(row + c + e, w[e] * scale);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT_D; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = s0 + m0 + gr + 8 * (e >> 1);
      const int c = n0d + 8 * j + gc + (e & 1);
      if (j < nt_d && u < S && c < d) {
        const size_t at = (((size_t)b * S + u) * KV + kvh) * d + c;
        dk[at] = from_f<T>(dka[j][e] * scale);
        dv[at] = from_f<T>(dva[j][e]);
      }
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
               const float* lse, const void* dout, float* Dv, float* dq_acc,
               void* dk, void* dv, int B, int Tq, int S, int H, int KV, int d,
               int causal, int window, cudaStream_t stream) {
  using C = Tiles<DMAX>;
  static const int attr = set_smem(
      (const void*)flash_attention_bwd_kernel<DMAX, T>, C::kBwdSmem);
  if (attr) return attr;
  const float scale = 1.0f / sqrtf((float)d);
  const int rows = B * Tq * H;
  flash_attention_bwd_dot_kernel<T>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          (const T*)o, (const T*)dout, Dv, rows, Tq, H, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  flash_attention_bwd_kernel<DMAX, T>
      <<<dim3((S + C::kBS - 1) / C::kBS, KV, B), 32 * kBwdWarps, C::kBwdSmem,
         stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                   lse, Dv, dq_acc, (T*)dk, (T*)dv, Tq, S, H, KV, d, causal,
                   window, scale);
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

// Backward: the forward's inputs, its o and lse, and dO (B,T,H,d) -> dk,
// dv in the inputs' type and dQ added into dq_acc (B,T,H,d) f32, which the
// caller zeroes; `Dv` is (B,H,T) f32 scratch. Two launches: D = rowsum(dO
// o O), then the fused dK/dV/dQ kernel.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dout,
                                   float* Dv, float* dq_acc, void* dk,
                                   void* dv,
                                   int B, int Tq, int S, int H, int KV, int d,
                                   int causal, int window, void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || d <= 0 || d > 256 || S <= 0) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_BWD(DM, TY)                                                  \
  launch_bwd<DM, TY>(q, k, v, o, lse, dout, Dv, dq_acc, dk, dv, B, Tq, S, H, \
                     KV, d, causal, window, st)
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
